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

* AES-128: one kernel launch per level (K1, ``ops/aes_level.py``) over
  groups of frontier subtrees, the last level of each group storing only
  its leaves' low limbs, each group contracted by K3
  (``ops/matmul128.py``) -- ``_expand_contract_pallas_aes``;
* Salsa/ChaCha and their block-PRG ids: the fused subtree kernel (K2,
  ``ops/subtree.py``), which here starts at the root --
  ``_expand_contract_pallas``;
* DUMMY: plain level steps over one frontier subtree at a time, then
  K3 -- the XLA path of ``_expand_contract_core`` (JAX has no Pallas
  path for DUMMY).

On CPU tensors every kernel wrapper takes its plain version, so the same
code is the CPU reference.  ``lax.scan`` becomes a Python loop.
"""

from __future__ import annotations

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


def choose_group(f: int, c: int) -> int:
    """Frontier nodes expanded together: the largest divisor of ``f``
    keeping the live leaf tensor under ~2^18 x batch x 16 B."""
    g = max(1, min(f, (1 << 18) // c))
    while f % g:
        g -= 1
    return g


def _level_step_multi(seeds: torch.Tensor, cw1_lvl: torch.Tensor,
                      cw2_lvl: torch.Tensor, prf_method: int,
                      arity: int = 2) -> torch.Tensor:
    """One GGM level of fan-out ``arity`` with this level's codewords
    passed directly (plain PyTorch; port of ``expand._level_step_pair``
    and ``radix4._level_step_mixed``).  seeds [B, w, 4]; cw*_lvl
    [B, arity, 4] -> [B, arity*w, 4], child b of node j at arity*j + b."""
    sel = (seeds[..., 0] & 1).bool()[..., None]            # [B, w, 1]
    prf_out = prf_multi(prf_method, seeds, arity)
    children = []
    for b in range(arity):
        cw = torch.where(sel, cw2_lvl[:, None, b, :], cw1_lvl[:, None, b, :])
        children.append(u128.add128(prf_out[b], cw))
    bsz, w = seeds.shape[0], seeds.shape[1]
    return torch.stack(children, dim=2).reshape(bsz, arity * w, 4)


def _level_step(seeds, cw1, cw2, i: int, prf_method: int) -> torch.Tensor:
    """One plain GGM level: [B, w, 4] -> [B, 2w, 4]; ``i`` is the flat
    level index (codeword slots 2i, 2i+1)."""
    return _level_step_multi(seeds, cw1[:, 2 * i:2 * i + 2, :],
                             cw2[:, 2 * i:2 * i + 2, :], prf_method)


def level_step(seeds, cw1, cw2, i: int, prf_method: int,
               low32: bool = False) -> torch.Tensor:
    """One GGM level on the port's route: AES through K1, the others
    through the plain step.  ``low32``: only the children's limb 0,
    [B, 2w] contiguous."""
    if prf_method == PRF_AES128:
        from ..ops.aes_level import aes_level_step
        return aes_level_step(seeds, cw1[:, 2 * i:2 * i + 2, :],
                              cw2[:, 2 * i:2 * i + 2, :], low32=low32)
    out = _level_step(seeds, cw1, cw2, i, prf_method)
    return out[..., 0].contiguous() if low32 else out


def permute_table(table_i32: np.ndarray) -> np.ndarray:
    """Bit-reverse-permute table rows once at init (host side)."""
    n = table_i32.shape[0]
    return np.ascontiguousarray(table_i32[u128.bit_reverse_indices(n)])


def _expand_contract_core(cw1, cw2, last, table_perm, *, depth: int,
                          prf_method: int, f: int) -> torch.Tensor:
    """The plain two-phase engine: expand every key from the root to ``f``
    frontier nodes, then one frontier subtree at a time to its C = N/f
    leaves, contracting each against its table rows with K3."""
    from ..ops.matmul128 import dot_i32
    n, e = table_perm.shape
    c = n // f
    f_levels = f.bit_length() - 1
    seeds = last[:, None, :]
    for lv in range(f_levels):
        seeds = _level_step(seeds, cw1, cw2, depth - 1 - lv, prf_method)
    acc = torch.zeros((last.shape[0], e), dtype=torch.int32,
                      device=last.device)
    for j in range(f):
        s = seeds[:, j:j + 1, :]
        for lv in range(f_levels, depth):
            s = _level_step(s, cw1, cw2, depth - 1 - lv, prf_method)
        acc = acc + dot_i32(s[..., 0], table_perm[j * c:(j + 1) * c])
    return acc


def grouped_scan_contract(seeds, table_perm, expand_fn, *, f: int,
                          c: int) -> torch.Tensor:
    """Split the ``f`` frontier nodes ([B, F, 4] ``seeds``) into equal
    groups of g, expand each group with ``expand_fn([B, g, 4]) ->
    [B, g*c]`` (the low limbs of its leaves, contiguous), contract them
    against the matching table rows with K3, and accumulate [B, E].  The
    group's leaves are ``B x g x c x 4 B``; its widest live tensor, the
    level before them, ``B x g x c/a x 16 B`` at arity a."""
    from ..ops.matmul128 import dot_i32
    e = table_perm.shape[1]
    g = choose_group(f, c)
    acc = torch.zeros((seeds.shape[0], e), dtype=torch.int32,
                      device=seeds.device)
    for start in range(0, f, g):
        low = expand_fn(seeds[:, start:start + g, :].contiguous())
        acc = acc + dot_i32(low, table_perm[start * c:(start + g) * c])
    return acc


def _expand_contract_aes(cw1, cw2, last, table_perm, *, depth: int,
                         chunk_leaves: int) -> torch.Tensor:
    """AES: one K1 launch per level, frontier groups through
    ``grouped_scan_contract`` (port of ``_expand_contract_pallas_aes``)."""
    n = table_perm.shape[0]
    c = chunk_leaves
    f = n // c
    f_levels = f.bit_length() - 1
    seeds = last[:, None, :]
    for lv in range(f_levels):
        seeds = level_step(seeds, cw1, cw2, depth - 1 - lv, PRF_AES128)

    def expand_fn(node_seeds):
        s = node_seeds
        if f_levels == depth:                 # one leaf a frontier node
            return s[..., 0].contiguous()
        for lv in range(f_levels, depth):
            s = level_step(s, cw1, cw2, depth - 1 - lv, PRF_AES128,
                           low32=lv == depth - 1)
        return s

    return grouped_scan_contract(seeds, table_perm, expand_fn, f=f, c=c)


def expand_and_contract(cw1, cw2, last, table_perm, *, depth: int,
                        prf_method: int, chunk_leaves: int) -> torch.Tensor:
    """Batched fused DPF evaluation against one shared table.

    cw1, cw2: [B, 64, 4] int32 codeword limbs; last: [B, 4] start seeds;
    table_perm: [N, E] int32 bit-reverse-permuted table, all on one
    device.  ``chunk_leaves``: leaves per phase-2 subtree (AES, DUMMY) or
    per K2 block (the stream ciphers); it changes no bit of the result.
    Returns [B, E] int32 server shares.
    """
    n = table_perm.shape[0]
    c = chunk_leaves
    if n != 1 << depth or c < 1 or n % c or c & (c - 1):
        raise ValueError("chunk_leaves (%d) must be a power of two dividing "
                         "the table size %d = 2^%d" % (c, n, depth))
    if prf_method == PRF_AES128:
        return _expand_contract_aes(cw1, cw2, last, table_perm, depth=depth,
                                    chunk_leaves=c)
    if prf_method in SUBTREE_PRFS:
        from ..ops.subtree import subtree_contract
        return subtree_contract(last[:, None, :], cw1, cw2, table_perm,
                                depth=depth, f_levels=0,
                                prf_method=prf_method, block_leaves=c)
    return _expand_contract_core(cw1, cw2, last, table_perm, depth=depth,
                                 prf_method=prf_method, f=n // c)


def expand_leaves(cw1, cw2, last, *, depth: int,
                  prf_method: int) -> torch.Tensor:
    """Full expansion to [B, N] low-32 leaf shares in natural index
    order (the one-hot path).  Memory O(B * N)."""
    seeds = last[:, None, :]
    for lv in range(depth):
        seeds = level_step(seeds, cw1, cw2, depth - 1 - lv, prf_method)
    perm = torch.from_numpy(u128.bit_reverse_indices(1 << depth).copy())
    return seeds[..., 0][:, perm.to(seeds.device)]


def eval_points(cw1, cw2, last, indices, *, depth: int,
                prf_method: int) -> torch.Tensor:
    """Root-to-leaf walks: [B] keys x [Q] indices -> [B, Q] int32 low-32
    shares (the naive strategy, O(Q log N) PRF calls per key)."""
    idx = torch.as_tensor(indices, dtype=torch.int64, device=last.device)
    seeds = last[:, None, :].expand(-1, idx.shape[0], -1).contiguous()
    rem = idx
    for lv in range(depth):
        i = depth - 1 - lv
        b = rem & 1                                       # [Q]
        p0, p1 = prf_pair(prf_method, seeds)
        val = torch.where((b == 0)[None, :, None], p0, p1)
        sel = (seeds[..., 0] & 1).bool()[..., None]       # [B, Q, 1]
        slot = 2 * i + b
        cw = torch.where(sel, cw2[:, slot, :], cw1[:, slot, :])
        seeds = u128.add128(val, cw)
        rem = rem >> 1
    return seeds[..., 0]
