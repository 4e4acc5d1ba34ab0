"""Runtime evaluation config.

Port of the ``dpf_tpu/utils/config.py`` ``EvalConfig`` fields this
package reads: ``prf_method``, ``batch_size`` and ``radix`` (2, the
binary tree, or 4, the radix-4 tree).  ``scheme`` is accepted so that
configs written for the JAX package construct here, and ``DPF`` rejects
every value but ``"logn"`` until sqrt-N and the tuning cache are
ported.
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
    scheme: str = "logn"   # only "logn" is served (sqrt-N: Queue 1 item 9)
