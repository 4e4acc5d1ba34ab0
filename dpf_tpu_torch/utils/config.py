"""Runtime evaluation config.

Port of the ``dpf_tpu/utils/config.py`` ``EvalConfig`` fields this
package reads: ``prf_method``, ``batch_size``, ``radix`` (2, the binary
tree, or 4, the radix-4 tree), ``scheme`` (``"logn"``, the GGM trees,
or ``"sqrtn"``, the sqrt-N grid) and ``row_chunk`` (sqrt-N grid rows per
step of the grid kernel).  ``DPF`` serves ``"logn"`` and ``"sqrtn"``;
``"auto"`` needs the tuning cache, not ported yet, and raises.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class EvalConfig:
    """The knobs ``DPF`` reads."""
    prf_method: int = 3   # PRF_AES128; 0..3 = reference ids, 4/5 = the
    #                       Salsa20/ChaCha20 block-PRG variants
    batch_size: int = 512  # keys per device dispatch (reference parity)
    radix: int = 2         # 2 = reference-wire binary GGM, 4 = radix-4
    scheme: str = "logn"   # "logn" (GGM tree) | "sqrtn" (core/sqrtn.py)
    row_chunk: int | None = None  # sqrtn: grid rows per step (None =
    #                       auto; an explicit pin passes straight through
    #                       and raises if it does not divide R)
