"""Runtime evaluation config.

Port of the ``dpf_tpu/utils/config.py`` ``EvalConfig`` fields this
package reads: ``prf_method``, ``batch_size``, ``radix`` (2, the binary
tree, or 4, the radix-4 tree), ``scheme`` (``"logn"``, the GGM trees,
or ``"sqrtn"``, the sqrt-N grid), ``row_chunk`` (sqrt-N grid rows per
step of the grid kernel), ``kernel_impl`` and ``dispatch_group``.
``DPF`` serves ``"logn"`` and ``"sqrtn"``; ``"auto"`` needs the tuning
cache, not ported yet, and raises.

``kernel_impl``: ``"dispatch"`` selects the per-level mode of the GGM
trees (``expand.eval_dispatch`` / ``radix4.eval_dispatch_mixed``: one
level a launch, a cooperative deadline between launches, the frontier
in groups of ``dispatch_group`` subtrees).  The JAX package's ``"xla"``
and ``"pallas"`` are the TPU's two compilers of one function; on the
card both, and the auto state (None or ``"auto"``), take the fused
kernels.  The sqrt-N grid has one route, K4, whatever the knob says.
"""

from __future__ import annotations

from dataclasses import dataclass

KERNEL_IMPLS = ("xla", "pallas", "dispatch", "auto", None)


def check_construction(scheme: str, radix: int,
                       schemes=("logn", "sqrtn", "auto")) -> None:
    """The scheme / radix membership rule of every construction surface
    (the ``DPF`` constructor, the batch-PIR server, client and cost
    model; port of ``dpf_tpu``'s).  A narrower ``schemes`` drops
    ``"auto"`` where a concrete construction is needed."""
    if scheme not in schemes:
        raise ValueError("scheme must be one of %s (got %r)"
                         % (schemes, scheme))
    if radix not in (2, 4):
        raise ValueError("radix must be 2 or 4")
    if scheme == "sqrtn" and radix == 4:
        raise ValueError("scheme='sqrtn' has no radix; use radix=2")


def is_auto(value) -> bool:
    """True when a knob is at its auto state: None or ``"auto"``."""
    return value is None or value == "auto"


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
    kernel_impl: str | None = "xla"  # "xla" | "pallas" (both: the fused
    #                       kernels) | "dispatch" (one level a launch)
    #                       | None/"auto" (the fused kernels)
    dispatch_group: int | None = None  # dispatch mode: frontier subtrees
    #                       expanded per pass (None = auto)

    def __post_init__(self):
        if self.kernel_impl not in KERNEL_IMPLS:
            raise ValueError("kernel_impl must be one of %s (got %r)"
                             % (KERNEL_IMPLS, self.kernel_impl))
