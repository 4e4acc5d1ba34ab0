"""Fused GGM subtree expansion + table contraction: plain versions and K2.

Port of ``dpf_tpu/ops/pallas_level.py::subtree_contract_pallas``
(binary schedule) and ``subtree_contract_pallas_mixed`` (radix-4
schedule) for the stream-cipher PRFs: Salsa20-12, ChaCha20-12 and the
block-PRG ids 4/5.  Both trees are a schedule of (arity, first codeword
slot) per eval level, taken by one plain engine (``_contract_plain``) and
by the one CUDA kernel (``csrc/subtree.cu``); each entry point counts its
own launches.

frontier ``[B, F, 4]`` (the seeds of the F = 2^f_levels nodes at level
``f_levels``), the full codeword arrays ``cw1``/``cw2`` ``[B, 64, 4]``
and the bit-reversed table ``[N, E]`` -> ``[B, E]`` int32 shares:
``sum_f leaves(f) . table[f*C:(f+1)*C]`` mod 2^32 with C = N/F.

* ``subtree_contract_plain`` -- the plain version: level steps in
  groups of block subtrees, then the plain product.
* ``subtree_contract`` -- the wrapper: CUDA tensors launch K2
  (``csrc/subtree.cu``), CPU tensors take the plain version.  A K2
  block serves a tile of 4 keys over one block subtree of
  ``block_leaves`` (<= 4096) leaves, so each table value it loads serves
  4 keys; neither changes a bit of the result.
* ``subtree_contract_mixed`` / ``subtree_contract_mixed_plain`` -- the
  same over a radix-4 tree of eval-order arities ``ars``: the frontier
  holds the nodes at eval level ``f_lv``, codewords sit at
  ``radix4.cw_offsets(ars)`` and the table is digit-reversed
  (``radix4.mixed_reverse_indices``).  ``block_leaves`` must be a product
  of trailing arities.
* per-key tables: each of the four functions also takes a ``[B, N, E]``
  stack of tables, one permuted table a key (batch-PIR's bins; the JAX
  package's per-key paths ``expand.expand_and_contract_per_key_tables``
  and ``radix4.expand_and_contract_per_key_tables_mixed`` expand the
  same way and contract with a batched ``dot_general``).  K2 runs its
  per-key kernel, one key a block, over block subtrees of
  ``pkt_block_leaves`` leaves unless the caller names them (a size the
  kernel cannot take raises); its launches count in ``launches_pkt``.

* ``subtree_contract_window`` / ``subtree_contract_window_plain`` -- the
  leaf-range form of both trees (a mesh shard or a cluster granule):
  the root seeds, the whole tree's schedule and the rows ``[row0, row0
  + rows)`` of the permuted table.  K2 takes a run of consecutive block
  subtrees as a launch argument (the first block and a power-of-two
  count; a range is one launch a power-of-two piece), every block
  walking from the root as in the full-table launch; its launches count
  on ``subtree_contract`` or ``subtree_contract_mixed``.
* ``chacha_level_step`` / ``chacha_level_step_plain`` -- one ChaCha20-12
  GGM level, the port of ``pallas_level.chacha_level_step_pallas``:
  seeds ``[B, w, 4]`` and the level's codewords ``[B, 2, 4]`` ->
  children ``[B, 2w, 4]``, child b of node j at ``2j + b``, with the
  full 128-bit codeword add.  CUDA tensors launch K5
  (``csrc/chacha_level.cu``).  Like the JAX function it is on no path:
  it is kept to hold and time one level of the stream cipher against
  K1's AES level.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..core.expand import SUBTREE_PRFS, _level_step_multi, choose_group
from ..core.prf_ref import PRF_CHACHA20
from ..core.radix4 import _suffix_chunk, cw_offsets
from . import cuda_build
from .aes_level import check_level_operands
from .matmul128 import dot_i32_per_key_plain, dot_i32_plain

MAX_BLOCK_LEAVES = 4096   # leaves per key that a K2 block keeps
# K2's per-key grid: at least three blocks for each of the H100's 132 SMs
# (a block's top breadth-first levels keep most of its warps idle, so an
# SM needs several), each block subtree at least one leaf for each of its
# 256 threads
PKT_TARGET_BLOCKS = 3 * 132
PKT_MIN_BLOCK_LEAVES = 256


def subtree_chunk_leaves(n: int) -> int:
    """Leaves per K2 block subtree: the largest power of two <= min(n,
    4096) (port of ``pallas_level.pallas_chunk_leaves``)."""
    c = 1
    while c * 2 <= min(n, MAX_BLOCK_LEAVES):
        c *= 2
    return c


def block_leaves_candidates(n: int, ars=None, span: int = 2) -> list:
    """K2's ``block_leaves`` candidates for the autotuner: the heuristic
    ``subtree_chunk_leaves(n)`` (at most 4096) and up to ``span`` octaves
    below it, each rounded down to a product of trailing arities for a
    radix-4 tree of eval-order arities ``ars`` (deduplicated).  Larger
    blocks than the heuristic do not exist (K2 keeps at most 4096 leaves
    a block).  Sorted ascending."""
    from ..core.radix4 import _suffix_chunk
    base = subtree_chunk_leaves(n)
    out = set()
    for s in range(span + 1):
        c = max(1, base >> s)
        out.add(_suffix_chunk(tuple(ars), c)[1] if ars else c)
    return sorted(out)


def frontier_level_candidates(n: int, block: int, batch: int,
                              span: int = 3) -> list:
    """K2's ``f_levels`` candidates (binary tree): the frontier K2 starts
    from, 0 (the root, the heuristic) up to ``span`` levels down, while
    a frontier node keeps at least one block subtree below it
    (``f_levels <= log2(n / block)``) and the frontier's ``[B,
    2^f_levels, 4]`` seeds stay within the 64 MiB live-seed bound.
    Sorted ascending."""
    from ..core.expand import CHUNK_SEED_BYTES_BOUND
    top = (n // max(1, block)).bit_length() - 1
    return [fl for fl in range(0, min(top, span) + 1)
            if (1 << fl) * 16 * max(1, batch) <= CHUNK_SEED_BYTES_BOUND]


def pkt_block_leaves(g: int, ars, f_cnt: int = 1) -> int:
    """Leaves per block subtree of K2's per-key mode, for ``g`` keys with
    ``f_cnt`` frontier nodes each over levels of arities ``ars`` below
    the frontier (the binary tree: ``(2,) * levels``): the largest
    product of trailing arities, at most 4096 and at least min(256, all
    the leaves below a node), whose grid of ``g * f_cnt * prod(ars) /
    CB`` blocks reaches ``PKT_TARGET_BLOCKS``; the smallest such product
    when none does.  Each block also walks one PRF call a level from
    the frontier to its root, and the binary instances hold six blocks
    an SM, so smaller blocks than the grid needs add walks and a partial
    second wave (on an H100 at G = 256 bins of 4096 rows, binary
    ChaCha20: 512 blocks of 2048 leaves beat 1024 of 1024 by 7%, and 256
    of 4096 lose to both; ``utils/pkt_times.py --geometry``).  No bit of
    the result depends on it."""
    cands, c = [], 1
    for a in reversed(tuple(ars)):
        c *= a
        if c <= MAX_BLOCK_LEAVES:
            cands.append(c)
    if not cands:                 # no levels: one leaf a frontier node
        return 1
    floor = min(PKT_MIN_BLOCK_LEAVES, cands[-1])
    cands = [c for c in cands if c >= floor]
    total = int(np.prod(tuple(ars), dtype=np.int64))
    fill = [c for c in cands
            if g * f_cnt * (total // c) >= PKT_TARGET_BLOCKS]
    return max(fill) if fill else min(cands)


def _log2(x: int, what: str) -> int:
    if x < 1 or x & (x - 1):
        raise ValueError("%s (%d) must be a power of two" % (what, x))
    return x.bit_length() - 1


def _operands(frontier, cw1, cw2, table_perm, prf_method):
    """Checks shared by both schedules -> (B, F, N, E); ``table_perm``
    is one ``[N, E]`` table or ``[B, N, E]``, one a key."""
    if prf_method not in SUBTREE_PRFS:
        raise ValueError("subtree_contract serves PRF ids %s, got %r"
                         % (SUBTREE_PRFS, prf_method))
    for t in (frontier, cw1, cw2, table_perm):
        if t.dtype != torch.int32:
            raise TypeError("subtree_contract takes int32 tensors")
        if t.device != frontier.device:
            raise ValueError("subtree_contract operands on different devices")
    bsz, f_cnt, _ = frontier.shape
    for cw in (cw1, cw2):
        if tuple(cw.shape) != (bsz, 64, 4):
            raise ValueError("codewords must be [B, 64, 4], got %s"
                             % (tuple(cw.shape),))
    if table_perm.dim() == 3 and table_perm.shape[0] != bsz:
        raise ValueError("per-key tables %s for %d keys"
                         % (tuple(table_perm.shape), bsz))
    if table_perm.dim() not in (2, 3):
        raise ValueError("table must be [N, E] or [B, N, E], got %s"
                         % (tuple(table_perm.shape),))
    return (bsz, f_cnt) + tuple(table_perm.shape[-2:])


def _shapes(frontier, cw1, cw2, table_perm, depth, f_levels, prf_method):
    bsz, f_cnt, n, e = _operands(frontier, cw1, cw2, table_perm, prf_method)
    if n != 1 << depth or f_cnt != 1 << f_levels or f_levels > depth:
        raise ValueError("table of %d rows and frontier of %d nodes do not "
                         "match depth %d, f_levels %d"
                         % (n, f_cnt, depth, f_levels))
    return bsz, f_cnt, n, e


def _check_layout(*tensors) -> None:
    # the kernel's layout, checked on every device so CPU runs catch it
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError("subtree_contract: operands must be contiguous")


def _binary_schedule(depth: int) -> list:
    """(arity, first codeword slot) per eval level of the binary tree:
    the wire layout stores level j's pair at slot 2 (depth-1-j)."""
    return [(2, 2 * (depth - 1 - j)) for j in range(depth)]


def _binary_split(frontier, cw1, cw2, table_perm, depth, f_levels,
                  prf_method, block_leaves):
    """Checks of the binary schedule -> (B, E, s_lv, CB): block subtrees
    of CB leaves hang from eval level s_lv.  A shared table clamps
    ``block_leaves`` to the leaves below a frontier node and to 4096;
    per-key tables take it as given (``pkt_block_leaves`` when None) and
    raise on a size the kernel cannot take."""
    bsz, f_cnt, n, e = _shapes(frontier, cw1, cw2, table_perm, depth,
                               f_levels, prf_method)
    c = n // f_cnt
    if table_perm.dim() == 3:
        cb = block_leaves or pkt_block_leaves(bsz, (2,) * (depth - f_levels),
                                              f_cnt)
        if cb > min(c, MAX_BLOCK_LEAVES):
            raise ValueError("block_leaves (%d) must be at most the %d "
                             "leaves below a frontier node and %d"
                             % (cb, c, MAX_BLOCK_LEAVES))
    else:
        cb = min(block_leaves or subtree_chunk_leaves(c), c,
                 MAX_BLOCK_LEAVES)
    _log2(cb, "block_leaves")
    return bsz, e, f_levels + _log2(c // cb, "leaves per frontier node / "
                                    "block_leaves"), cb


def _contract_plain(frontier, cw1, cw2, table_perm, sched, f_lv, s_lv, cb,
                    prf_method, s0: int = 0) -> torch.Tensor:
    """The plain engine of both trees: walk the frontier to the block
    subtrees' roots with plain level steps of the (arity, offset)
    schedule, expand a group of block subtrees at a time, and contract
    the low limbs (per-key tables: each key's own rows).  ``s0``: the
    table's rows are those of the block subtrees from ``s0`` on (one
    frontier node)."""
    def level(s, j):
        a, o = sched[j]
        return _level_step_multi(s, cw1[:, o:o + a], cw2[:, o:o + a],
                                 prf_method, a)

    seeds = frontier
    for j in range(f_lv, s_lv):
        seeds = level(seeds, j)
    nodes = table_perm.shape[-2] // cb
    seeds = seeds[:, s0:s0 + nodes]
    g = choose_group(nodes, cb)
    acc = torch.zeros((frontier.shape[0], table_perm.shape[-1]),
                      dtype=torch.int32, device=frontier.device)
    for start in range(0, nodes, g):
        s = seeds[:, start:start + g, :]
        for j in range(s_lv, len(sched)):
            s = level(s, j)
        rows = slice(start * cb, (start + g) * cb)
        if table_perm.dim() == 3:
            acc = acc + dot_i32_per_key_plain(s[..., 0],
                                              table_perm[:, rows])
        else:
            acc = acc + dot_i32_plain(s[..., 0], table_perm[rows])
    return acc


def _contract_cuda(frontier, cw1, cw2, table_perm, sched, f_lv, cb,
                   prf_method, window=None) -> torch.Tensor:
    """Launch K2 over the (arity, offset) schedule -> [B, E] int32;
    ``window`` (s0, log_n): 2^log_n block subtrees from s0, the table
    holding their rows."""
    if frontier.device.type != "cuda":
        raise ValueError("subtree_contract: unsupported device %s"
                         % frontier.device)
    levels = len(sched)
    lg = (ctypes.c_int * levels)(*(a.bit_length() - 1 for a, _ in sched))
    off = (ctypes.c_int * levels)(*(o for _, o in sched))
    bsz, e = frontier.shape[0], table_perm.shape[-1]
    out = torch.zeros((bsz, e), dtype=torch.int32, device=frontier.device)
    args = (frontier.data_ptr(), cw1.data_ptr(), cw2.data_ptr(),
            table_perm.data_ptr(), out.data_ptr(), bsz, frontier.shape[1],
            levels, lg, off, f_lv, cb.bit_length() - 1, e, prf_method)
    stream = torch.cuda.current_stream().cuda_stream
    with torch.cuda.device(frontier.device):
        if window is None:
            cuda_build.launch("subtree", "subtree_contract_launch", *args,
                              int(table_perm.dim() == 3), stream)
        else:
            cuda_build.launch("subtree", "subtree_contract_window_launch",
                              *args, window[0], window[1], stream)
    return out


def _count(fn, table_perm) -> None:
    """One launch more on ``fn``'s counter of its table form."""
    if table_perm.dim() == 3:
        fn.launches_pkt += 1
    else:
        fn.launches += 1


def subtree_contract_plain(frontier, cw1, cw2, table_perm, *, depth: int,
                           f_levels: int, prf_method: int,
                           block_leaves: int | None = None) -> torch.Tensor:
    """Plain PyTorch over the binary tree (``_contract_plain``)."""
    _, _, s_lv, cb = _binary_split(frontier, cw1, cw2, table_perm, depth,
                                   f_levels, prf_method, block_leaves)
    return _contract_plain(frontier, cw1, cw2, table_perm,
                           _binary_schedule(depth), f_levels, s_lv, cb,
                           prf_method)


def subtree_contract(frontier, cw1, cw2, table_perm, *, depth: int,
                     f_levels: int, prf_method: int,
                     block_leaves: int | None = None) -> torch.Tensor:
    """Fused subtree expand + contract; K2 on CUDA tensors, plain on CPU
    ones.  ``table_perm``: one ``[N, E]`` table or ``[B, N, E]``, one a
    key.  Returns [B, E] int32."""
    _, _, s_lv, cb = _binary_split(frontier, cw1, cw2, table_perm, depth,
                                   f_levels, prf_method, block_leaves)
    _check_layout(frontier, cw1, cw2, table_perm)
    sched = _binary_schedule(depth)
    if frontier.device.type == "cpu":
        return _contract_plain(frontier, cw1, cw2, table_perm, sched,
                               f_levels, s_lv, cb, prf_method)
    out = _contract_cuda(frontier, cw1, cw2, table_perm, sched, f_levels,
                         cb, prf_method)
    _count(subtree_contract, table_perm)
    return out


subtree_contract.launches = 0
subtree_contract.launches_pkt = 0


def _mixed_split(frontier, cw1, cw2, table_perm, ars, f_lv, prf_method,
                 block_leaves):
    """Checks of the radix-4 schedule -> (B, E, s_lv, CB): block subtrees
    of CB leaves hang from eval level s_lv.  ``block_leaves`` None is
    4096 leaves rounded down to a product of trailing arities, or
    ``pkt_block_leaves`` for per-key tables."""
    bsz, f_cnt, n, e = _operands(frontier, cw1, cw2, table_perm, prf_method)
    ars = tuple(ars)
    if any(a not in (2, 4) for a in ars) or not 0 <= f_lv < len(ars):
        raise ValueError("arities %r with f_lv %d: need arities of 2 or 4 "
                         "and f_lv below their count" % (ars, f_lv))
    if n != int(np.prod(ars)) or f_cnt != int(np.prod(ars[:f_lv])):
        raise ValueError("table of %d rows and frontier of %d nodes do not "
                         "match arities %r, f_lv %d" % (n, f_cnt, ars, f_lv))
    if sum(ars) > 64:
        raise ValueError("arities %r need more than 64 codeword slots"
                         % (ars,))
    target = block_leaves
    if target is None:
        target = (pkt_block_leaves(bsz, ars[f_lv:], f_cnt)
                  if table_perm.dim() == 3 else MAX_BLOCK_LEAVES)
    j, cb = _suffix_chunk(ars[f_lv:], target)
    if (block_leaves is not None and cb != block_leaves) or \
            cb > MAX_BLOCK_LEAVES:
        raise ValueError("block_leaves (%d) must be a product of trailing "
                         "arities %r, at most %d"
                         % (target, ars[f_lv:], MAX_BLOCK_LEAVES))
    return bsz, e, f_lv + j, cb


def subtree_contract_mixed_plain(frontier, cw1, cw2, table_perm, *, ars,
                                 f_lv: int, prf_method: int,
                                 block_leaves: int | None = None
                                 ) -> torch.Tensor:
    """Plain PyTorch over the radix-4 tree (``_contract_plain``)."""
    _, _, s_lv, cb = _mixed_split(frontier, cw1, cw2, table_perm, ars, f_lv,
                                  prf_method, block_leaves)
    return _contract_plain(frontier, cw1, cw2, table_perm,
                           list(zip(ars, cw_offsets(ars))), f_lv, s_lv, cb,
                           prf_method)


def subtree_contract_mixed(frontier, cw1, cw2, table_perm, *, ars,
                           f_lv: int, prf_method: int,
                           block_leaves: int | None = None) -> torch.Tensor:
    """Fused radix-4 subtree expand + contract; K2 on CUDA tensors, plain
    on CPU ones.  ``table_perm``: one ``[N, E]`` table or ``[B, N, E]``,
    one a key.  Returns [B, E] int32."""
    _, _, s_lv, cb = _mixed_split(frontier, cw1, cw2, table_perm, ars, f_lv,
                                  prf_method, block_leaves)
    _check_layout(frontier, cw1, cw2, table_perm)
    sched = list(zip(ars, cw_offsets(ars)))
    if frontier.device.type == "cpu":
        return _contract_plain(frontier, cw1, cw2, table_perm, sched, f_lv,
                               s_lv, cb, prf_method)
    out = _contract_cuda(frontier, cw1, cw2, table_perm, sched, f_lv, cb,
                         prf_method)
    _count(subtree_contract_mixed, table_perm)
    return out


subtree_contract_mixed.launches = 0
subtree_contract_mixed.launches_pkt = 0


def _window_split(root, cw1, cw2, table, sched, row0, prf_method,
                  block_leaves):
    """Checks of the leaf-range form -> (s_lv, CB, pieces): block
    subtrees of CB leaves (the largest product of trailing arities of at
    most ``block_leaves`` and 4096 dividing ``row0`` and the rows) from
    eval level s_lv, in pieces (first block, log2 blocks) of power-of-two
    block counts."""
    sched = [(int(a), int(o)) for a, o in sched]
    ars = tuple(a for a, _ in sched)
    _operands(root, cw1, cw2, table, prf_method)
    if root.shape[1] != 1 or table.dim() != 2:
        raise ValueError("a leaf range takes the root [B, 1, 4] and one "
                         "[rows, E] table, got %s and %s"
                         % (tuple(root.shape), tuple(table.shape)))
    rows = table.shape[0]
    n = int(np.prod(ars, dtype=np.int64))
    if rows < 1 or row0 < 0 or row0 + rows > n or len(ars) > 32 or \
            any(a not in (2, 4) for a in ars) or sum(ars) > 64:
        raise ValueError("leaf range [%d, %d) of a tree of %d leaves "
                         "(arities %r)" % (row0, row0 + rows, n, ars))
    target = min(block_leaves or MAX_BLOCK_LEAVES, MAX_BLOCK_LEAVES)
    while True:
        j, cb = _suffix_chunk(ars, target)
        if (row0 % cb == 0 and rows % cb == 0) or cb <= ars[-1]:
            break
        target = cb - 1
    if row0 % cb or rows % cb or cb > MAX_BLOCK_LEAVES:
        raise ValueError("leaf range [%d, %d) is not whole blocks of "
                         "trailing arities %r" % (row0, row0 + rows, ars))
    pieces, first, count = [], row0 // cb, rows // cb
    for k in reversed(range(count.bit_length())):
        if count >> k & 1:
            pieces.append((first, k))
            first += 1 << k
    return sched, j, cb, pieces


def subtree_contract_window_plain(root, cw1, cw2, table, *, sched,
                                  row0: int, prf_method: int,
                                  block_leaves: int | None = None,
                                  radix: int = 2) -> torch.Tensor:
    """Plain PyTorch over a leaf range (``_contract_plain`` from the
    root, the block subtrees of the range only); ``radix`` is only
    counted by the kernel's wrapper."""
    sched, j, cb, pieces = _window_split(root, cw1, cw2, table, sched, row0,
                                         prf_method, block_leaves)
    return _contract_plain(root.contiguous(), cw1, cw2, table, sched, 0, j,
                           cb, prf_method, s0=row0 // cb)


def subtree_contract_window(root, cw1, cw2, table, *, sched, row0: int,
                            prf_method: int, block_leaves: int | None = None,
                            radix: int = 2) -> torch.Tensor:
    """K2 over a leaf range: the leaf-range form of ``subtree_contract``
    and ``subtree_contract_mixed`` (a mesh shard, a cluster granule).

    ``root`` ``[B, 1, 4]`` holds the keys' root seeds, ``sched`` the
    (arity, first codeword slot) of every eval level of the whole tree,
    ``table`` the ``[rows, E]`` rows ``[row0, row0 + rows)`` of the
    permuted table.  Each launch takes a power-of-two run of consecutive
    block subtrees (``csrc/subtree.cu``'s window entry: the first block
    and the count), each block walking from the root to its own subtree
    root as in the full-table launch, so no level above the blocks runs
    anywhere else.  ``block_leaves`` (None = 4096) is rounded down to a
    product of trailing arities dividing ``row0`` and the rows.  Launches
    count on ``subtree_contract`` (``radix`` 2) or
    ``subtree_contract_mixed``.  Returns [B, E] int32."""
    if root.device.type == "cpu":
        return subtree_contract_window_plain(
            root, cw1, cw2, table, sched=sched, row0=row0,
            prf_method=prf_method, block_leaves=block_leaves)
    sched, _, cb, pieces = _window_split(root, cw1, cw2, table, sched, row0,
                                         prf_method, block_leaves)
    root = root.contiguous()
    _check_layout(root, cw1, cw2, table)
    counter = subtree_contract if radix == 2 else subtree_contract_mixed
    acc, r = None, 0
    for s0, k in pieces:
        tb = table[r:r + (cb << k)]
        r += cb << k
        out = _contract_cuda(root, cw1, cw2, tb, sched, 0, cb, prf_method,
                             window=(s0, k))
        counter.launches += 1
        acc = out if acc is None else acc + out
    return acc


def chacha_level_step_plain(seeds: torch.Tensor, cw1_lvl: torch.Tensor,
                            cw2_lvl: torch.Tensor) -> torch.Tensor:
    """[B, w, 4] seeds, [B, 2, 4] codewords -> [B, 2w, 4] children."""
    return _level_step_multi(seeds, cw1_lvl, cw2_lvl, PRF_CHACHA20, 2)


def chacha_level_step(seeds: torch.Tensor, cw1_lvl: torch.Tensor,
                      cw2_lvl: torch.Tensor) -> torch.Tensor:
    """One ChaCha20-12 GGM level; K5 on CUDA tensors, plain on CPU
    ones."""
    check_level_operands(seeds, cw1_lvl, cw2_lvl, 2, "chacha_level_step")
    if seeds.device.type == "cpu":
        return chacha_level_step_plain(seeds, cw1_lvl, cw2_lvl)
    if seeds.device.type != "cuda":
        raise ValueError("chacha_level_step: unsupported device %s"
                         % seeds.device)
    bsz, w, _ = seeds.shape
    out = torch.empty((bsz, 2 * w, 4), dtype=torch.int32,
                      device=seeds.device)
    with torch.cuda.device(seeds.device):
        cuda_build.launch(
            "chacha_level", "chacha_level_launch", seeds.data_ptr(),
            cw1_lvl.data_ptr(), cw2_lvl.data_ptr(), cw1_lvl.stride(0),
            out.data_ptr(), bsz, w, torch.cuda.current_stream().cuda_stream)
    chacha_level_step.launches += 1
    return out


chacha_level_step.launches = 0
