"""pirbench: the benchmark of ``dpf_tpu_torch`` on one NVIDIA H100.

``python3 pirbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON result line.  Everything a cell is made of is found by name:
``configs/<config>.json`` (the deployment), ``traffic/<mix>.json`` (the
offered load), ``ciphers/<prf>.py`` and ``constructions/<name>.py``
(the plain reference and the frozen key generator), ``work/<name>.py``
(the algorithm's operations and bytes) and ``metrics/<metric>.py`` (one
reader a per-layer metric).  Nothing here imports ``jax`` or the JAX
package ``dpf_tpu``; the program under test is ``dpf_tpu_torch``.
"""
