"""Runtime evaluation config (port of ``dpf_tpu/utils/config.py``).

Fields: ``prf_method``, ``batch_size``, ``radix`` (2, the binary tree,
or 4, the radix-4 tree), ``scheme`` (``"logn"``, the GGM trees,
``"sqrtn"``, the sqrt-N grid, or ``"auto"``, resolved from the tuning
cache's scheme winner, else the binary tree), ``row_chunk`` (sqrt-N
grid rows per step of the grid kernel), ``kernel_impl``,
``dispatch_group``, ``aes_impl``, ``chunk_leaves``, ``dot_impl`` and
``round_unroll``.  Fields at their auto state (``is_auto``) resolve at
dispatch: an explicit value wins, then a searched kernel variant, then
the tuning cache (``tune/cache.py``), then the heuristics
(``api.DPF.resolved_eval_knobs``).

``kernel_impl``: ``"dispatch"`` selects the per-level mode of the GGM
trees (``expand.eval_dispatch`` / ``radix4.eval_dispatch_mixed``: one
level a launch, a cooperative deadline between launches, the frontier
in groups of ``dispatch_group`` subtrees); ``"fused"`` pins the fused
kernels.  The JAX package's ``"xla"`` and ``"pallas"`` are the TPU's two
compilers of one function: on the card they name no route of their own,
so they count as the auto state (``is_auto_kernel``), as None and
``"auto"`` do: the fused kernels unless the tuning cache says otherwise.
The sqrt-N grid has one route, K4, whatever the knob says.

``chunk_leaves`` means what the route it reaches takes: for Salsa and
ChaCha (and their block-PRG ids) in the fused mode K2's block subtree,
a power of two of at most 4096 leaves (``ops/subtree.py``); for AES and
DUMMY, and for every PRF in the dispatch mode, the live-seed chunk of
``expand.clamp_chunk``.  ``dot_impl`` picks the contraction of the
routes that contract outside a kernel (K3, ``"i32"``, or
``torch._int_mm`` on byte limbs, ``"mxu"``: ``ops/matmul128.py``); K2
and K4 contract inside.  ``round_unroll`` is accepted and recorded (the
JAX package unrolls its cipher rounds on the TPU); the CUDA kernels'
rounds are unrolled by ``nvcc``, so it moves no path.

``aes_impl`` (``"auto"``, ``"gather"`` or ``"bitsliced"`` with an
optional ``":bp"``, ``":tower"`` or ``":chain"`` S-box circuit) picks the
formulation of the plain AES-128 that a CPU server runs: its dispatches,
one-hot expansions and point walks pass it to ``core/prf.prf_multi``
(``"auto"`` is ``"gather"``).  A server on the card ignores it: the AES
levels run K1 (T-tables) and point walks the gather form, with the same
output bits, so the knob never moves a path from a kernel to plain
code.  The sqrt-N grid's plain AES is the gather form.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, replace

KERNEL_IMPLS = ("fused", "dispatch", "xla", "pallas", "auto", None)
AES_IMPLS = ("auto", "gather", "bitsliced", "bitsliced:bp",
             "bitsliced:tower", "bitsliced:chain")


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


def check_aes_impl(aes_impl) -> None:
    """``aes_impl`` must be None or one of ``AES_IMPLS``."""
    if aes_impl is not None and aes_impl not in AES_IMPLS:
        raise ValueError("aes_impl must be one of %s (got %r)"
                         % (AES_IMPLS, aes_impl))


def is_auto(value) -> bool:
    """True when a knob is at its auto state: None or ``"auto"``."""
    return value is None or value == "auto"


def is_auto_kernel(value) -> bool:
    """True when ``kernel_impl`` leaves the route to the resolver: the
    auto state, or one of the JAX package's compiler names."""
    return is_auto(value) or value in ("xla", "pallas")


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
    kernel_impl: str | None = "xla"  # "fused" | "dispatch" (one level a
    #                       launch) | "xla" / "pallas" / None / "auto"
    #                       (auto: tuned, else the fused kernels)
    dispatch_group: int | None = None  # dispatch mode: frontier subtrees
    #                       expanded per pass (None = auto)
    aes_impl: str = "auto"  # "auto"|"gather"|"bitsliced"[":bp"|":tower"
    #                       |":chain"]: a CPU server's plain AES (ignored
    #                       on the card)
    chunk_leaves: int | None = None  # None = auto (searched, tuned, else
    #                       the route's heuristic)
    dot_impl: str | None = "i32"  # "i32" | "mxu" (ops/matmul128) |
    #                       None/"auto" (tuned, else the module default)
    round_unroll: bool | None = None  # recorded; moves no path

    def __post_init__(self):
        if self.kernel_impl not in KERNEL_IMPLS:
            raise ValueError("kernel_impl must be one of %s (got %r)"
                             % (KERNEL_IMPLS, self.kernel_impl))
        check_aes_impl(self.aes_impl)

    def with_(self, **kw) -> "EvalConfig":
        return replace(self, **kw)

    def apply_globals(self):
        """Push the process-wide knob this config sets: ``matmul128``'s
        default contraction (the auto state resets it to ``"i32"``).
        Prefer the scoped ``applied()`` in code that measures
        candidates."""
        from ..ops import matmul128
        matmul128.set_dot_impl(self.dot_impl
                               if not is_auto(self.dot_impl) else "i32")
        return self

    @contextlib.contextmanager
    def applied(self):
        """Scoped ``apply_globals``: snapshot ``matmul128``'s default,
        push this config's, and restore the snapshot on exit, exception
        or not (the tuner measures every candidate inside it)."""
        from ..ops import matmul128
        snap = matmul128.default_impl()
        try:
            yield self.apply_globals()
        finally:
            matmul128.set_dot_impl(snap)
