"""Fused GGM subtree expansion + table contraction: plain version and K2.

Port of ``dpf_tpu/ops/pallas_level.py::subtree_contract_pallas``
(binary schedule) for the stream-cipher PRFs: Salsa20-12, ChaCha20-12
and the block-PRG ids 4/5.

frontier ``[B, F, 4]`` (the seeds of the F = 2^f_levels nodes at level
``f_levels``), the full codeword arrays ``cw1``/``cw2`` ``[B, 64, 4]``
and the bit-reversed table ``[N, E]`` -> ``[B, E]`` int32 shares:
``sum_f leaves(f) . table[f*C:(f+1)*C]`` mod 2^32 with C = N/F.

* ``subtree_contract_plain`` -- the plain version: level steps in
  groups of frontier nodes, then the plain product.
* ``subtree_contract`` -- the wrapper: CUDA tensors launch K2
  (``csrc/subtree.cu``), CPU tensors take the plain version.
  ``block_leaves`` (<= 4096) is the kernel's tile: the leaves one block
  expands and contracts; it does not change a bit of the result.
"""

from __future__ import annotations

import torch

from ..core.expand import SUBTREE_PRFS, _level_step, choose_group
from . import cuda_build
from .matmul128 import dot_i32_plain

MAX_BLOCK_LEAVES = 4096   # leaves one K2 block keeps in shared memory


def subtree_chunk_leaves(n: int) -> int:
    """Leaves per K2 block subtree: the largest power of two <= min(n,
    4096) (port of ``pallas_level.pallas_chunk_leaves``)."""
    c = 1
    while c * 2 <= min(n, MAX_BLOCK_LEAVES):
        c *= 2
    return c


def _log2(x: int, what: str) -> int:
    if x < 1 or x & (x - 1):
        raise ValueError("%s (%d) must be a power of two" % (what, x))
    return x.bit_length() - 1


def _shapes(frontier, cw1, cw2, table_perm, depth, f_levels, prf_method):
    if prf_method not in SUBTREE_PRFS:
        raise ValueError("subtree_contract serves PRF ids %s, got %r"
                         % (SUBTREE_PRFS, prf_method))
    for t in (frontier, cw1, cw2, table_perm):
        if t.dtype != torch.int32:
            raise TypeError("subtree_contract takes int32 tensors")
        if t.device != frontier.device:
            raise ValueError("subtree_contract operands on different devices")
    bsz, f_cnt, _ = frontier.shape
    n, e = table_perm.shape
    if n != 1 << depth or f_cnt != 1 << f_levels or f_levels > depth:
        raise ValueError("table of %d rows and frontier of %d nodes do not "
                         "match depth %d, f_levels %d"
                         % (n, f_cnt, depth, f_levels))
    for cw in (cw1, cw2):
        if tuple(cw.shape) != (bsz, 64, 4):
            raise ValueError("codewords must be [B, 64, 4], got %s"
                             % (tuple(cw.shape),))
    return bsz, f_cnt, n, e


def _check_layout(*tensors) -> None:
    # the kernel's layout, checked on every device so CPU runs catch it
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError("subtree_contract: operands must be contiguous")


def subtree_contract_plain(frontier, cw1, cw2, table_perm, *, depth: int,
                           f_levels: int, prf_method: int,
                           block_leaves: int | None = None) -> torch.Tensor:
    """Plain PyTorch: expand every frontier subtree with plain level steps,
    a group of subtrees at a time, and contract the low limbs."""
    bsz, f_cnt, n, e = _shapes(frontier, cw1, cw2, table_perm, depth,
                               f_levels, prf_method)
    c = n // f_cnt
    cb = min(block_leaves or subtree_chunk_leaves(c), c)
    split = f_levels + _log2(c // cb, "leaves per frontier node / "
                             "block_leaves")
    seeds = frontier
    for lv in range(f_levels, split):
        seeds = _level_step(seeds, cw1, cw2, depth - 1 - lv, prf_method)
    nodes = n // cb
    g = choose_group(nodes, cb)
    acc = torch.zeros((bsz, e), dtype=torch.int32, device=frontier.device)
    for start in range(0, nodes, g):
        s = seeds[:, start:start + g, :]
        for lv in range(split, depth):
            s = _level_step(s, cw1, cw2, depth - 1 - lv, prf_method)
        acc = acc + dot_i32_plain(s[..., 0],
                                  table_perm[start * cb:(start + g) * cb])
    return acc


def subtree_contract(frontier, cw1, cw2, table_perm, *, depth: int,
                     f_levels: int, prf_method: int,
                     block_leaves: int | None = None) -> torch.Tensor:
    """Fused subtree expand + contract; K2 on CUDA tensors, plain on CPU
    ones.  Returns [B, E] int32."""
    bsz, f_cnt, n, e = _shapes(frontier, cw1, cw2, table_perm, depth,
                               f_levels, prf_method)
    _check_layout(frontier, cw1, cw2, table_perm)
    if frontier.device.type == "cpu":
        return subtree_contract_plain(
            frontier, cw1, cw2, table_perm, depth=depth, f_levels=f_levels,
            prf_method=prf_method, block_leaves=block_leaves)
    if frontier.device.type != "cuda":
        raise ValueError("subtree_contract: unsupported device %s"
                         % frontier.device)
    c = n // f_cnt
    cb = min(block_leaves or subtree_chunk_leaves(c), c,
             MAX_BLOCK_LEAVES)
    log_cb = _log2(cb, "block_leaves")
    out = torch.zeros((bsz, e), dtype=torch.int32, device=frontier.device)
    with torch.cuda.device(frontier.device):
        cuda_build.launch(
            "subtree", "subtree_contract_launch", frontier.data_ptr(),
            cw1.data_ptr(), cw2.data_ptr(), table_perm.data_ptr(),
            out.data_ptr(), bsz, f_cnt, depth, f_levels, log_cb, e,
            prf_method, torch.cuda.current_stream().cuda_stream)
    subtree_contract.launches += 1
    return out


subtree_contract.launches = 0
