"""Batched DPF expansion with fused table contraction (binary GGM).

Port of ``dpf_tpu/core/expand.py``.  The GGM level recurrence

    new[2j+b] = PRF(old[j], b) + cw[old[j] & 1][2i + b]        (mod 2^128)

runs over ``[B, width, 4]`` int32 limb tensors; leaves come out in
bit-reversed order, so the table is bit-reverse-permuted once at init
(``permute_table``).  Mod 2^32 the 128-bit leaf times an entry reduces
to the leaf's low limb times the entry, so the contraction is an exact
wrapping int32 product.

``expand_and_contract`` routes each PRF as the JAX package's
``kernel_impl="pallas"`` path does:

* Salsa/ChaCha and their block-PRG ids: the fused subtree kernel (K2,
  ``ops/subtree.py``), which here starts at the root --
  ``_expand_contract_pallas``;
* AES-128 and DUMMY: ``eval_dispatch`` without a deadline -- one launch
  a level (AES: K1, ``ops/aes_level.py``; DUMMY: the plain step, as
  JAX's XLA path) over groups of frontier subtrees, the last level of
  each group keeping only its leaves' low limbs, each group contracted
  by K3 (``ops/matmul128.py``) -- ``_expand_contract_pallas_aes``.

``eval_dispatch`` is also the per-level mode (``kernel_impl=
"dispatch"``) for every PRF: a monotonic deadline checked between
launches (``DeadlineExceeded``), the frontier in groups of ``group``
subtrees.  There ChaCha20-12 levels go to K5
(``ops/subtree.chacha_level_step``) and Salsa20 and the block-PRG ids
to the plain level step (the JAX package computes those with XLA ops).

``expand_and_contract_per_key_tables`` is the batch-PIR form, every key
with its own table (``[B, N, E]``): the stream ciphers through K2's
per-key mode, AES and DUMMY through ``dispatch_contract`` with each
group contracted by K6 (``matmul128.dot_i32_per_key``) in place of K3.

The tuner's knobs (``tune/search.py``, ``tune/kernel_search.py``)
reach these routes as ``chunk_leaves`` (K2's block subtree, or the
live-seed chunk of the per-level routes), ``f_levels`` (the frontier a
route starts from: K2's, walked by the per-level steps above it, or the
per-level routes' phase-1 frontier, its subtrees contracted in groups of
``chunk_leaves`` leaves) and ``dot_impl`` (the per-level routes'
contraction: K3 or ``matmul128.dot_i32_mxu``).  ``chunk_candidates`` and
``f_level_candidates`` are ``dpf_tpu``'s, for the live-seed routes; K2's
own are ``ops/subtree.block_leaves_candidates`` and
``frontier_level_candidates``.  No knob changes a bit of the result.

On CPU tensors every kernel wrapper takes its plain version, so the same
code is the CPU reference.  ``lax.scan`` becomes a Python loop.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from . import u128
from .prf import prf_multi, prf_pair
from .prf_ref import (PRF_AES128, PRF_CHACHA20, PRF_CHACHA20_BLK,
                      PRF_SALSA20, PRF_SALSA20_BLK)

# the PRFs the fused subtree kernel (K2) serves
SUBTREE_PRFS = (PRF_SALSA20, PRF_CHACHA20, PRF_SALSA20_BLK,
                PRF_CHACHA20_BLK)

# Live-seed budget for phase 2: the [B, C] x 16-byte seed tensor of one
# subtree group.
CHUNK_SEED_BYTES_BOUND = 1 << 26  # 64 MiB

_CHUNK_FLOOR = 256  # below this, loop overhead dominates any memory win


def chunk_within_bound(c: int, batch: int) -> bool:
    """True when a [B, C] seed tensor fits the 64 MiB budget (the floor
    chunk is always allowed)."""
    return c <= _CHUNK_FLOOR or c * 16 * max(1, batch) <= \
        CHUNK_SEED_BYTES_BOUND


def choose_chunk(n: int, batch: int) -> int:
    """Leaves per phase-2 subtree: bound the live seed tensor at 64 MiB
    (B x C x 16 B with C = max(256, 2^22 / B); at B=512, C=8192)."""
    target = max(_CHUNK_FLOOR, (CHUNK_SEED_BYTES_BOUND // 16)
                 // max(1, batch))
    c = 1
    while c * 2 <= min(n, target):
        c *= 2
    return c


def clamp_chunk(chunk, n: int, batch: int) -> int:
    """A falsy or over-budget ``chunk`` falls back to ``choose_chunk``."""
    if not chunk or not chunk_within_bound(chunk, batch):
        chunk = choose_chunk(n, batch)
    return min(int(chunk), n)


def chunk_candidates(n: int, batch: int, span: int = 2) -> list:
    """``chunk_leaves`` candidates of the live-seed routes for the
    autotuner (``dpf_tpu``'s rule): powers of two within ``span``
    octaves of ``choose_chunk``, each dividing the power-of-two ``n`` and
    each within the 64 MiB live-seed bound (dropped, not clipped).  The
    heuristic is always a member.  Sorted ascending."""
    base = choose_chunk(n, batch)
    out = set()
    for s in range(-span, span + 1):
        c = base << s if s >= 0 else base >> (-s)
        if 1 <= c <= n and chunk_within_bound(c, batch):
            out.add(c)
    return sorted(out)


def f_level_candidates(n: int, chunk: int, batch: int,
                       span: int = 3) -> list:
    """Legal ``f_levels`` of the live-seed routes for one (n, chunk)
    pair (``dpf_tpu``'s rule): from the chunk-implied frontier
    ``log2(n / chunk)`` (always a member) down at most ``span`` levels,
    while the frontier's ``[B, 2^f_levels, 4]`` seeds stay within the
    64 MiB bound.  Sorted ascending."""
    depth = int(np.log2(n))
    base = depth - int(np.log2(max(1, int(chunk))))
    out = []
    for fl in range(base, min(depth, base + span) + 1):
        if (1 << fl) * 16 * max(1, batch) <= CHUNK_SEED_BYTES_BOUND:
            out.append(fl)
    return out or [base]


def choose_group(f: int, c: int) -> int:
    """Frontier nodes expanded together: the largest divisor of ``f``
    keeping the live leaf tensor under ~2^18 x batch x 16 B."""
    g = max(1, min(f, (1 << 18) // c))
    while f % g:
        g -= 1
    return g


def _level_step_multi(seeds: torch.Tensor, cw1_lvl: torch.Tensor,
                      cw2_lvl: torch.Tensor, prf_method: int,
                      arity: int = 2,
                      aes_impl: str | None = None) -> torch.Tensor:
    """One GGM level of fan-out ``arity`` with this level's codewords
    passed directly (plain PyTorch; port of ``expand._level_step_pair``
    and ``radix4._level_step_mixed``).  seeds [B, w, 4]; cw*_lvl
    [B, arity, 4] -> [B, arity*w, 4], child b of node j at arity*j + b.
    ``aes_impl``: the AES formulation (``prf.prf_multi``)."""
    sel = (seeds[..., 0] & 1).bool()[..., None]            # [B, w, 1]
    prf_out = prf_multi(prf_method, seeds, arity, aes_impl)
    children = []
    for b in range(arity):
        cw = torch.where(sel, cw2_lvl[:, None, b, :], cw1_lvl[:, None, b, :])
        children.append(u128.add128(prf_out[b], cw))
    bsz, w = seeds.shape[0], seeds.shape[1]
    return torch.stack(children, dim=2).reshape(bsz, arity * w, 4)


def route_level(seeds, cw1_lvl, cw2_lvl, prf_method: int, arity: int = 2,
                low32: bool = False,
                aes_impl: str | None = None) -> torch.Tensor:
    """One GGM level on the port's route, this level's codewords
    ``[B, arity, 4]`` given: AES through K1 at the level's arity, binary
    ChaCha20 through K5, the rest through the plain step.  ``low32``:
    only the children's limb 0, ``[B, a*w]`` contiguous (K1 stores only
    it; the other routes copy it out).  ``aes_impl``: the formulation of
    K1's plain version on CPU tensors."""
    if prf_method == PRF_AES128:
        from ..ops.aes_level import aes_level_step
        return aes_level_step(seeds, cw1_lvl, cw2_lvl, arity=arity,
                              low32=low32, aes_impl=aes_impl)
    if prf_method == PRF_CHACHA20 and arity == 2:
        from ..ops.subtree import chacha_level_step
        out = chacha_level_step(seeds, cw1_lvl, cw2_lvl)
    else:
        out = _level_step_multi(seeds, cw1_lvl, cw2_lvl, prf_method, arity)
    return out[..., 0].contiguous() if low32 else out


def level_step(seeds, cw1, cw2, i: int, prf_method: int,
               low32: bool = False,
               aes_impl: str | None = None) -> torch.Tensor:
    """Binary level ``i`` (codeword slots 2i, 2i+1 of the full
    ``[B, 64, 4]`` arrays) through ``route_level``."""
    return route_level(seeds, cw1[:, 2 * i:2 * i + 2], cw2[:, 2 * i:2 * i + 2],
                       prf_method, 2, low32, aes_impl)


def pack_keys(flat_keys) -> tuple:
    """List of ``keygen.FlatKey`` -> (cw1 [B, 64, 4], cw2, last [B, 4])
    uint32 arrays: the scalar codec's packing (the batched wire path is
    ``keygen.decode_keys_batched``)."""
    cw1 = np.stack([k.cw1 for k in flat_keys]).astype(np.uint32, copy=False)
    cw2 = np.stack([k.cw2 for k in flat_keys]).astype(np.uint32, copy=False)
    last = np.stack([u128.int_to_limbs(k.last_key) for k in flat_keys])
    return cw1, cw2, last


def permute_table(table_i32: np.ndarray) -> np.ndarray:
    """Bit-reverse-permute table rows once at init (host side)."""
    n = table_i32.shape[0]
    return np.ascontiguousarray(table_i32[u128.bit_reverse_indices(n)])


def expand_and_contract(cw1, cw2, last, table_perm, *, depth: int,
                        prf_method: int, chunk_leaves: int,
                        aes_impl: str | None = None,
                        f_levels: int | None = None,
                        dot_impl: str | None = None) -> torch.Tensor:
    """Batched fused DPF evaluation against one shared table.

    cw1, cw2: [B, 64, 4] int32 codeword limbs; last: [B, 4] start seeds;
    table_perm: [N, E] int32 bit-reverse-permuted table, all on one
    device.  ``chunk_leaves``: leaves per phase-2 pass (AES, DUMMY) or
    per K2 block (the stream ciphers).  ``f_levels`` (None = the route's
    own): K2 starts from the ``2^f_levels`` frontier, which the per-level
    steps reach first (``f_levels <= depth - log2(chunk_leaves)``); AES
    and DUMMY expand to that frontier, then contract groups of its
    subtrees of ``chunk_leaves`` leaves in all (``f_levels >= depth -
    log2(chunk_leaves)``).  ``dot_impl``: the AES and DUMMY route's
    contraction (None = K3).  None of these changes a bit of the result.
    ``aes_impl``: the formulation of K1's plain version on CPU tensors.
    Returns [B, E] int32 server shares.
    """
    n = table_perm.shape[0]
    c = chunk_leaves
    if n != 1 << depth or c < 1 or n % c or c & (c - 1):
        raise ValueError("chunk_leaves (%d) must be a power of two dividing "
                         "the table size %d = 2^%d" % (c, n, depth))
    base = depth - (c.bit_length() - 1)
    if prf_method in SUBTREE_PRFS:
        from ..ops.subtree import subtree_contract
        fl = f_levels or 0
        if not 0 <= fl <= base:
            raise ValueError("f_levels (%d) must be in [0, %d] for K2 blocks "
                             "of %d leaves" % (fl, base, c))
        seeds = last[:, None, :]
        for lv in range(fl):
            seeds = level_step(seeds, cw1, cw2, depth - 1 - lv, prf_method)
        return subtree_contract(seeds.contiguous(), cw1, cw2, table_perm,
                                depth=depth, f_levels=fl,
                                prf_method=prf_method, block_leaves=c)
    group = None
    if f_levels is not None:
        if not base <= f_levels <= depth:
            raise ValueError("f_levels (%d) must be in [%d, %d] for chunks "
                             "of %d leaves" % (f_levels, base, depth, c))
        c, group = n >> f_levels, c >> (depth - f_levels)
    return eval_dispatch(cw1, cw2, last, table_perm, depth=depth,
                         prf_method=prf_method, chunk_leaves=c, group=group,
                         aes_impl=aes_impl, dot_impl=dot_impl)


class DeadlineExceeded(RuntimeError):
    """Raised by the per-level modes between launches when their
    deadline (a ``time.monotonic()`` value) has passed; the launches
    already enqueued run to their end on the device."""


def check_deadline(deadline: float | None) -> None:
    """Raise ``DeadlineExceeded`` once ``time.monotonic()`` is past
    ``deadline`` (monotonic: an NTP step neither fires nor starves it)."""
    if deadline is not None and time.monotonic() > deadline:
        raise DeadlineExceeded(
            "eval_dispatch soft deadline passed between dispatches")


def dispatch_group_size(f: int, c: int, group: int | None) -> int:
    """Frontier subtrees a dispatch-mode pass expands: ``group`` (None =
    ``choose_group``) clamped to ``f`` and lowered to a divisor of it."""
    if group is not None and group < 1:
        raise ValueError("dispatch group must be >= 1 (got %r)" % (group,))
    g = min(group or choose_group(f, c), f)
    while f % g:
        g -= 1
    return g


def dispatch_contract(last, table_perm, level, n_levels: int, f_lv: int,
                      c: int, group: int | None,
                      deadline: float | None,
                      dot_impl: str | None = None,
                      lv0: int = 0) -> torch.Tensor:
    """The per-level mode's loop over any level schedule:
    ``level(seeds, j, low32)`` runs eval level ``j``; the root goes to
    the ``f = N / c`` frontier nodes at eval level ``f_lv``, then each
    group of subtrees to its leaves, contracted by K3 or the ``dot_impl``
    of ``matmul128.IMPLS`` (per-key tables ``[B, N, E]``: by K6, each key
    against its own rows).  The deadline is checked before every
    launch.  ``last`` ``[B, w, 4]`` with ``lv0`` starts from ``w``
    consecutive nodes of eval level ``lv0`` whose leaves are the table's
    ``N`` rows (a leaf range of a larger tree)."""
    from ..ops.matmul128 import IMPLS, dot_i32, dot_i32_per_key
    dot = dot_i32 if dot_impl in (None, "i32") else IMPLS[dot_impl]
    n, e = table_perm.shape[-2:]
    f = n // c
    g = dispatch_group_size(f, c, group)
    seeds = last[:, None, :] if last.dim() == 2 else last
    for j in range(lv0, f_lv):
        check_deadline(deadline)
        seeds = level(seeds, j, False)                  # [B, f, 4]
    acc = torch.zeros((last.shape[0], e), dtype=torch.int32,
                      device=last.device)
    for start in range(0, f, g):
        s = seeds[:, start:start + g, :].contiguous()
        if f_lv == n_levels:                      # one leaf a node
            s = s[..., 0].contiguous()
        for j in range(f_lv, n_levels):
            check_deadline(deadline)
            s = level(s, j, j == n_levels - 1)    # last: [B, g*c]
        check_deadline(deadline)
        rows = slice(start * c, (start + g) * c)
        if table_perm.dim() == 3:
            acc = acc + dot_i32_per_key(s, table_perm[:, rows])
        else:
            acc = acc + dot(s, table_perm[rows])
    return acc


def eval_dispatch(cw1, cw2, last, table_perm, *, depth: int,
                  prf_method: int, chunk_leaves: int,
                  group: int | None = None,
                  deadline: float | None = None,
                  aes_impl: str | None = None,
                  dot_impl: str | None = None) -> torch.Tensor:
    """Per-level evaluation of the binary tree (port of
    ``expand.eval_dispatch``): the same shares as
    ``expand_and_contract``, one launch a level.  ``table_perm`` may be
    ``[B, N, E]``, one table a key (contracted by K6).

    ``chunk_leaves``: leaves per frontier subtree (a power of two
    dividing N); ``group``: frontier subtrees expanded together (None =
    ``choose_group``; a value that does not divide the frontier is
    lowered to one that does); ``deadline``: a ``time.monotonic()``
    value checked before every launch; ``aes_impl``: the formulation of
    K1's plain version on CPU tensors; ``dot_impl``: the shared table's
    contraction (None = K3)."""
    n = table_perm.shape[-2]
    c = chunk_leaves
    if n != 1 << depth or c < 1 or n % c or c & (c - 1):
        raise ValueError("chunk_leaves (%d) must be a power of two dividing "
                         "the table size %d = 2^%d" % (c, n, depth))

    def level(s, j, low32):
        return level_step(s, cw1, cw2, depth - 1 - j, prf_method, low32,
                          aes_impl)

    return dispatch_contract(last, table_perm, level, depth,
                             (n // c).bit_length() - 1, c, group, deadline,
                             dot_impl)


def expand_and_contract_per_key_tables(cw1, cw2, last, tables_perm, *,
                                       depth: int, prf_method: int,
                                       chunk_leaves: int | None = None
                                       ) -> torch.Tensor:
    """Fused evaluation where every key has its own table (port of
    ``expand.expand_and_contract_per_key_tables``, the batch-PIR bin
    protocol: one dispatch answers a query round across all bins of one
    size).

    tables_perm: ``[B, N, E]`` int32, each bit-reverse-permuted and
    contiguous.  Returns ``[B, E]`` int32 shares, ``out[b] = sum_j
    leaf32[b, j] * tables_perm[b, j]`` mod 2^32.  Routed as
    ``expand_and_contract``: the stream ciphers through K2's per-key
    mode from the root (``chunk_leaves`` its block subtree, a power of
    two of at most 4096, else ValueError; None = ``subtree.
    pkt_block_leaves``), AES and DUMMY through ``dispatch_contract`` with
    K6 per group (``chunk_leaves`` its frontier subtree; None = the
    64 MiB live-seed chunk, ``clamp_chunk``).  ``chunk_leaves`` changes
    no bit of the result."""
    if tables_perm.dim() != 3 or tables_perm.shape[0] != last.shape[0]:
        raise ValueError("per-key tables %s for %d keys"
                         % (tuple(tables_perm.shape), last.shape[0]))
    n = tables_perm.shape[1]
    if prf_method in SUBTREE_PRFS:
        from ..ops.subtree import subtree_contract
        return subtree_contract(last[:, None, :], cw1, cw2, tables_perm,
                                depth=depth, f_levels=0,
                                prf_method=prf_method,
                                block_leaves=chunk_leaves)
    c = chunk_leaves or clamp_chunk(None, n, last.shape[0])
    if n != 1 << depth or c < 1 or n % c or c & (c - 1):
        raise ValueError("chunk_leaves (%d) must be a power of two dividing "
                         "the table size %d = 2^%d" % (c, n, depth))
    return eval_dispatch(cw1, cw2, last, tables_perm, depth=depth,
                         prf_method=prf_method, chunk_leaves=c)


def expand_leaves(cw1, cw2, last, *, depth: int, prf_method: int,
                  aes_impl: str | None = None) -> torch.Tensor:
    """Full expansion to [B, N] low-32 leaf shares in natural index
    order (the one-hot path).  Memory O(B * N)."""
    seeds = last[:, None, :]
    for lv in range(depth):
        seeds = level_step(seeds, cw1, cw2, depth - 1 - lv, prf_method,
                           aes_impl=aes_impl)
    perm = torch.from_numpy(u128.bit_reverse_indices(1 << depth).copy())
    return seeds[..., 0][:, perm.to(seeds.device)]


def eval_points(cw1, cw2, last, indices, *, depth: int, prf_method: int,
                aes_impl: str | None = None) -> torch.Tensor:
    """Root-to-leaf walks: [B] keys x [Q] indices -> [B, Q] int32 low-32
    shares (the naive strategy, O(Q log N) PRF calls per key; plain
    PyTorch on every device, ``aes_impl`` its AES formulation)."""
    idx = torch.as_tensor(indices, dtype=torch.int64, device=last.device)
    seeds = last[:, None, :].expand(-1, idx.shape[0], -1).contiguous()
    rem = idx
    for lv in range(depth):
        i = depth - 1 - lv
        b = rem & 1                                       # [Q]
        p0, p1 = prf_pair(prf_method, seeds, aes_impl)
        val = torch.where((b == 0)[None, :, None], p0, p1)
        sel = (seeds[..., 0] & 1).bool()[..., None]       # [B, Q, 1]
        slot = 2 * i + b
        cw = torch.where(sel, cw2[:, slot, :], cw1[:, slot, :])
        seeds = u128.add128(val, cw)
        rem = rem >> 1
    return seeds[..., 0]
