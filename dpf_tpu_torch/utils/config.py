"""Runtime evaluation config.

Port of the ``dpf_tpu/utils/config.py`` ``EvalConfig`` fields this
package reads: ``prf_method`` and ``batch_size``.  ``radix`` and
``scheme`` are accepted so that configs written for the JAX package
construct here, and ``DPF`` rejects every value but the binary log-N
construction until radix-4 and sqrt-N are ported.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class EvalConfig:
    """The knobs ``DPF`` reads."""
    prf_method: int = 3   # PRF_AES128; 0..3 = reference ids, 4/5 = the
    #                       Salsa20/ChaCha20 block-PRG variants
    batch_size: int = 512  # keys per device dispatch (reference parity)
    radix: int = 2         # only 2 is served (radix-4: ROADMAP Queue 1 item 8)
    scheme: str = "logn"   # only "logn" is served (sqrt-N: Queue 1 item 9)
