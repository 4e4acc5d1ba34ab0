"""Radix-4 (mixed-radix) GGM DPF: keys, codec and batched evaluation.

Port of ``dpf_tpu/core/radix4.py``.  Each level consumes one radix-``a``
digit of the index (LSB first) and owns ``a`` codeword slots per server
view; an evaluator picks cw1 or cw2 by the LSB of its current seed, as
in the binary tree.  Odd depths take one binary base level, then radix-4
levels up to the root (``arities``), so a tree needs about 2/3 of the
binary tree's PRF children and half its levels.

Keys reuse the 524-int32 container with a radix marker in slot 0 limb 1
(binary keys keep 0 there); level ``j``'s codewords sit at
``cw_offsets(ars)[j]`` in eval order.  Leaves come out in digit-reversed
breadth-first order; ``mixed_reverse_indices`` is the table permutation.

The key generator and codec are the JAX package's numpy host code,
copied so this package imports no JAX; wire keys are identical for the
same ``(alpha, n, seed, prf)``.  Evaluation runs on int32 limb tensors:

* ``expand_and_contract_mixed`` routes as ``dpf_tpu``'s
  ``expand_and_contract_mixed_pallas``: AES through K1 at each level's
  arity over groups of frontier subtrees, each group contracted by K3;
  Salsa/ChaCha and the block-PRG ids through the mixed K2
  (``ops/subtree.subtree_contract_mixed``) from the root; DUMMY through
  plain level steps and K3 (AES and DUMMY by ``eval_dispatch_mixed``
  without a deadline).
* ``expand_leaves_mixed`` (one-hot) and ``eval_points_mixed`` (root to
  leaf walks).

* ``eval_dispatch_mixed``, the per-level mode (``kernel_impl=
  "dispatch"``): one launch a level, AES through K1 at the level's
  arity, the other PRFs through the plain mixed step, one K3 a group
  of frontier subtrees, a cooperative deadline between launches.

* ``expand_and_contract_per_key_tables_mixed``, the batch-PIR form
  (every key its own digit-reversed table, ``[B, N, E]``): the stream
  ciphers through the mixed K2's per-key mode, AES and DUMMY through
  ``eval_dispatch_mixed`` with each group contracted by K6.

``gen_batched_r4`` is the batched generator, on ``[B, 4]`` limb
tensors as ``keygen.gen_batched``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from . import u128
from .expand import SUBTREE_PRFS, dispatch_contract, route_level
from .keygen import (KEY_WORDS, PackedKeys, Shake256Drbg, _check_batch_args,
                     _even, _keygen_knob_fns, _odd, _wire_batch, beta_limbs,
                     drbg_u128_batch, stack_wire_keys)
from .prf import prf_multi
from .prf_ref import MASK128, PRF_FUNCS

MAX_CW = 64


def arities(n: int) -> tuple:
    """Eval-order level arities for table size n: a binary base level iff
    depth is odd, then radix-4 all the way up."""
    depth = n.bit_length() - 1
    out = (2,) if depth % 2 else ()
    return out + (4,) * (depth // 2)


def cw_offsets(ars) -> list:
    """Slot offset of each level's codeword block (eval order)."""
    offs, o = [], 0
    for a in ars:
        offs.append(o)
        o += a
    return offs


def mixed_reverse_indices(ars) -> np.ndarray:
    """perm[bfs_pos] = alpha landing there under breadth-first expansion:
    alpha's mixed-radix digits read most significant first.  All-2
    arities reduce to bit reversal."""
    n = int(np.prod(ars))
    rem = np.arange(n, dtype=np.int64)
    alpha = np.zeros(n, dtype=np.int64)
    block = n
    mult = 1
    for a in ars:
        block //= a
        d, rem = np.divmod(rem, block)
        alpha += d * mult
        mult *= a
    return alpha


@dataclass
class MixedKey:
    """One server's mixed-radix DPF key (host representation)."""
    arities: tuple       # eval order; level j consumes digit j (LSB-first)
    cw1: np.ndarray      # [64, 4] uint32 (slots beyond sum(arities) zero)
    cw2: np.ndarray      # [64, 4] uint32
    last_key: int        # 128-bit start seed
    n: int

    def serialize(self) -> np.ndarray:
        """-> [524] int32: slot 0 = (depth, radix marker 4, binary levels,
        0), then the binary key's layout with eval-order codeword
        blocks."""
        depth = self.n.bit_length() - 1
        slots = np.zeros((131, 4), dtype=np.uint32)
        slots[0, 0] = depth
        slots[0, 1] = 4
        slots[0, 2] = sum(1 for a in self.arities if a == 2)
        slots[1:65] = self.cw1
        slots[65:129] = self.cw2
        slots[129] = u128.int_to_limbs(self.last_key)
        slots[130] = u128.int_to_limbs(self.n)
        return slots.reshape(-1).view(np.int32).copy()


def is_mixed_key(arr) -> bool:
    """True if a 524-word key carries the radix marker."""
    if hasattr(arr, "detach"):
        arr = arr.detach().cpu().numpy()
    a = np.asarray(arr, dtype=np.int32).reshape(-1)
    return a.shape[0] == KEY_WORDS and a.view(np.uint32)[1] == 4


def _check_header(slots: np.ndarray) -> tuple:
    """[B, 131, 4] uint32 wire slots of a radix-4 batch -> (n, depth);
    raises on a missing marker, mixed sizes or an inconsistent header."""
    if (slots[:, 0, 1] != 4).any():
        bad = int(np.argmax(slots[:, 0, 1] != 4))
        raise ValueError("not a mixed-radix key (marker %d): binary keys "
                         "are served by DPF() with radix 2"
                         % int(slots[bad, 0, 1]))
    n = (slots[:, 130, 0].astype(np.uint64)
         | (slots[:, 130, 1].astype(np.uint64) << np.uint64(32)))
    if (n != n[0]).any():
        raise ValueError("keys for mixed table sizes")
    n0 = int(n[0])
    depth = n0.bit_length() - 1
    n_bin = sum(1 for x in arities(n0) if x == 2)
    if ((slots[:, 0, 0] != depth) | (slots[:, 0, 2] != n_bin)).any():
        raise ValueError("mixed-radix key header inconsistent with n=%d"
                         % n0)
    return n0, depth


def deserialize_mixed_key(arr) -> MixedKey:
    """[524] int32 (array-like; torch tensors accepted) -> MixedKey."""
    if hasattr(arr, "detach"):
        arr = arr.detach().cpu().numpy()
    a = np.asarray(arr, dtype=np.int32).reshape(-1)
    if a.shape[0] != KEY_WORDS:
        raise ValueError("mixed-radix key must be %d int32 words, got %d"
                         % (KEY_WORDS, a.shape[0]))
    slots = a.view(np.uint32).reshape(131, 4)
    n, _ = _check_header(slots[None])
    return MixedKey(arities=arities(n), cw1=slots[1:65].copy(),
                    cw2=slots[65:129].copy(),
                    last_key=u128.limbs_to_int(slots[129]), n=n)


def decode_mixed_keys_batched(keys) -> PackedKeys:
    """Vectorized wire -> packed-arrays codec for a radix-4 key batch
    (codeword slots stay in the eval-order blocks of ``cw_offsets``)."""
    slots = stack_wire_keys(keys).view(np.uint32).reshape(-1, 131, 4)
    n, depth = _check_header(slots)
    return PackedKeys(
        cw1=np.ascontiguousarray(slots[:, 1:65]),
        cw2=np.ascontiguousarray(slots[:, 65:129]),
        last=np.ascontiguousarray(slots[:, 129]),
        depth=depth, n=n)


def generate_keys_r4(alpha: int, n: int, seed: bytes, prf_method: int,
                     beta: int = 1):
    """Two servers' mixed-radix keys for f(alpha) = beta (mod 2^128).

    The binary generator's bottom-up derivation with the branch loop
    widened to each level's arity.  O(log N) PRF calls, host side.
    """
    if n & (n - 1) != 0 or n < 2:
        raise ValueError("table size (%d) must be a power of two >= 2" % n)
    if not 0 <= alpha < n:
        raise ValueError("alpha (%d) must be in [0, %d)" % (alpha, n))
    if n.bit_length() - 1 > 32:  # sum(arities) = 2*depth must fit MAX_CW
        raise ValueError("table size 2^%d exceeds max 2^32"
                         % (n.bit_length() - 1))
    ars = arities(n)
    offs = cw_offsets(ars)
    levels = len(ars)
    prf = PRF_FUNCS[prf_method]
    rng = Shake256Drbg(seed)

    cw1 = np.zeros((MAX_CW, 4), dtype=np.uint32)
    cw2 = np.zeros((MAX_CW, 4), dtype=np.uint32)

    digits = []
    rem = alpha
    for a in ars:
        digits.append(rem % a)
        rem //= a

    # --- base level (eval step 0) ---------------------------------------
    a0 = ars[0]
    k1 = rng.u128() & ~1          # server 0 start seed: LSB 0
    k2 = rng.u128() | 1           # server 1 start seed: LSB 1
    beta_l = beta if levels == 1 else rng.u128_odd()
    tb = digits[0]
    c1 = [rng.u128() for _ in range(a0)]
    for b in range(a0):
        d = (prf(k1, b) - prf(k2, b)) & MASK128
        if b == tb:
            d = (d - beta_l) & MASK128
        cw1[offs[0] + b] = u128.int_to_limbs(c1[b])
        cw2[offs[0] + b] = u128.int_to_limbs((c1[b] + d) & MASK128)
    s1 = (prf(k1, tb) + c1[tb]) & MASK128
    s2 = (prf(k2, tb)
          + u128.limbs_to_int(cw2[offs[0] + tb])) & MASK128

    # --- upper levels, bottom to top -------------------------------------
    for j in range(1, levels):
        if not ((s1 - s2) & MASK128 == beta_l and (s1 ^ s2) & 1):
            raise AssertionError(
                "radix keygen invariant broken at level %d: seed shares "
                "must differ by the odd beta' (and so in LSB)" % j)
        a = ars[j]
        beta_l = beta if j == levels - 1 else rng.u128_odd()
        tb = digits[j]
        s1_even = (s1 & 1) == 0
        c1 = [rng.u128() for _ in range(a)]
        for b in range(a):
            d = (prf(s2, b) - prf(s1, b)) & MASK128
            if s1_even:
                d = (-d) & MASK128
            cw2[offs[j] + b] = u128.int_to_limbs((c1[b] + d) & MASK128)
        c1[tb] = (c1[tb] + (beta_l if s1_even else -beta_l)) & MASK128
        for b in range(a):
            cw1[offs[j] + b] = u128.int_to_limbs(c1[b])
        n1 = (prf(s1, tb) + (c1[tb] if s1_even else
                             u128.limbs_to_int(cw2[offs[j] + tb]))) & MASK128
        n2 = (prf(s2, tb) + (u128.limbs_to_int(cw2[offs[j] + tb])
                             if s1_even else c1[tb])) & MASK128
        s1, s2 = n1, n2

    ka = MixedKey(arities=ars, cw1=cw1, cw2=cw2, last_key=k1, n=n)
    kb = MixedKey(arities=ars, cw1=cw1.copy(), cw2=cw2.copy(),
                  last_key=k2, n=n)
    return ka, kb


def gen_batched_r4(alphas, n: int, seeds=None, *, prf_method: int,
                   beta: int = 1, knobs=None):
    """Two servers' radix-4 keys for B indices over one domain ``n``.

    The radix-4 ``keygen.gen_batched``: one DRBG squeeze per key, then
    ``O(log4 N)`` PRF calls over ``[B, 4]`` limb tensors; row i is
    byte-identical to ``generate_keys_r4(alphas[i], n, seeds[i])``.
    ``knobs`` as ``keygen._keygen_knob_fns``.  Returns two ``[B, 524]``
    int32 CPU tensors."""
    alphas, seeds = _check_batch_args(alphas, n, seeds)
    depth = n.bit_length() - 1
    if depth > 32:  # sum(arities) = 2 * depth must fit MAX_CW
        raise ValueError("table size 2^%d exceeds max 2^32" % depth)
    ars = arities(n)
    offs = cw_offsets(ars)
    levels = len(ars)
    bsz = alphas.size
    prf_pair_v, path_pick, squeeze_draws = _keygen_knob_fns(
        prf_method, knobs)
    # two start seeds, then a beta' for every level but the root, and
    # one draw per branch
    n_draws = 2 + (levels - 1) + sum(ars)
    draws = iter(drbg_u128_batch(seeds, n_draws,
                                 squeeze_draws=squeeze_draws).unbind(1))
    digits = np.empty((bsz, levels), dtype=np.int64)
    rem = alphas.copy()
    for j, a in enumerate(ars):
        digits[:, j] = rem % a
        rem //= a
    digits = torch.from_numpy(digits)

    beta_c = beta_limbs(beta, bsz)
    cw1 = torch.zeros((bsz, MAX_CW, 4), dtype=torch.int32)
    cw2 = torch.zeros((bsz, MAX_CW, 4), dtype=torch.int32)
    rows = torch.arange(bsz)

    # --- base level (eval step 0) ---------------------------------------
    a0 = ars[0]
    k1 = _even(next(draws))                           # server 0: LSB 0
    k2 = _odd(next(draws))                            # server 1: LSB 1
    beta_l = beta_c if levels == 1 else _odd(next(draws))
    tb = digits[:, 0]
    c1 = [next(draws) for _ in range(a0)]
    p1, p2 = [], []
    for b in range(a0):
        v1, v2 = prf_pair_v(k1, k2, b)
        p1.append(v1)
        p2.append(v2)
        d = u128.sub128(v1, v2)
        d = torch.where((tb == b)[:, None], u128.sub128(d, beta_l), d)
        cw1[:, offs[0] + b] = c1[b]
        cw2[:, offs[0] + b] = u128.add128(c1[b], d)
    c1_t = torch.stack(c1, dim=1)[rows, tb]
    s1 = u128.add128(path_pick(p1, k1, tb, rows), c1_t)
    s2 = u128.add128(path_pick(p2, k2, tb, rows), cw2[rows, offs[0] + tb])

    # --- upper levels, bottom to top -------------------------------------
    for j in range(1, levels):
        if not (torch.equal(u128.sub128(s1, s2), beta_l.expand_as(s1))
                and bool((((s1[:, 0] ^ s2[:, 0]) & 1) == 1).all())):
            raise AssertionError(
                "radix keygen invariant broken at level %d: seed shares "
                "must differ by the odd beta' (and so in LSB)" % j)
        a = ars[j]
        beta_l = beta_c if j == levels - 1 else _odd(next(draws))
        tb = digits[:, j]
        s1_even = ((s1[:, 0] & 1) == 0)[:, None]
        c1 = [next(draws) for _ in range(a)]
        p1, p2 = [], []
        for b in range(a):
            v1, v2 = prf_pair_v(s1, s2, b)
            p1.append(v1)
            p2.append(v2)
            d = u128.sub128(v2, v1)
            d = torch.where(s1_even, u128.neg128(d), d)
            cw2[:, offs[j] + b] = u128.add128(c1[b], d)
        adj = torch.where(s1_even, beta_l, u128.neg128(beta_l))
        c1 = [torch.where((tb == b)[:, None], u128.add128(c1[b], adj), c1[b])
              for b in range(a)]
        for b in range(a):
            cw1[:, offs[j] + b] = c1[b]
        c1_t = torch.stack(c1, dim=1)[rows, tb]
        cw2_t = cw2[rows, offs[j] + tb]
        n1 = u128.add128(path_pick(p1, s1, tb, rows),
                         torch.where(s1_even, c1_t, cw2_t))
        n2 = u128.add128(path_pick(p2, s2, tb, rows),
                         torch.where(s1_even, cw2_t, c1_t))
        s1, s2 = n1, n2

    marker = (4, sum(1 for a in ars if a == 2))
    return (_wire_batch(cw1, cw2, k1, depth, n, radix_slot0=marker),
            _wire_batch(cw1, cw2, k2, depth, n, radix_slot0=marker))


def evaluate_mixed(key: MixedKey, indx: int, prf_method: int) -> int:
    """Scalar reference evaluation at one index (O(log N) PRF calls)."""
    prf = PRF_FUNCS[prf_method]
    offs = cw_offsets(key.arities)
    cur = key.last_key
    rem = indx
    for j, a in enumerate(key.arities):
        b = rem % a
        val = prf(cur, b)
        cw = key.cw1 if (cur & 1) == 0 else key.cw2
        cur = (val + u128.limbs_to_int(cw[offs[j] + b])) & MASK128
        rem //= a
    return cur


def pack_mixed_keys(keys) -> tuple:
    """List of MixedKey -> (cw1 [B,64,4], cw2, last [B,4]) uint32."""
    bsz = len(keys)
    cw1 = np.zeros((bsz, MAX_CW, 4), dtype=np.uint32)
    cw2 = np.zeros((bsz, MAX_CW, 4), dtype=np.uint32)
    last = np.zeros((bsz, 4), dtype=np.uint32)
    for i, k in enumerate(keys):
        cw1[i] = k.cw1
        cw2[i] = k.cw2
        last[i] = u128.int_to_limbs(k.last_key)
    return cw1, cw2, last


def _suffix_chunk(ars, target: int) -> tuple:
    """Split levels so phase 2 covers a trailing suffix with product <=
    target (at least the last level): returns (f_levels, chunk)."""
    prod = 1
    j = len(ars)
    while j > 0 and prod * ars[j - 1] <= max(target, ars[-1]):
        j -= 1
        prod *= ars[j]
    return j, prod


# ---------------------------------------------------------------------------
# Batched evaluation on int32 limb tensors
# ---------------------------------------------------------------------------

def level_step_mixed(seeds, cw1, cw2, ars, offs, j: int, prf_method: int,
                     low32: bool = False,
                     aes_impl: str | None = None) -> torch.Tensor:
    """Eval level ``j`` (codeword slots ``offs[j]`` on of the full
    ``[B, 64, 4]`` arrays) through ``expand.route_level`` at the level's
    arity: seeds [B, w, 4] -> [B, ars[j]*w, 4], or with ``low32`` only
    the children's limb 0, [B, ars[j]*w] contiguous."""
    a = ars[j]
    return route_level(seeds, cw1[:, offs[j]:offs[j] + a],
                       cw2[:, offs[j]:offs[j] + a], prf_method, a, low32,
                       aes_impl)


def expand_leaves_mixed(cw1, cw2, last, *, n: int, prf_method: int,
                        aes_impl: str | None = None) -> torch.Tensor:
    """Full expansion to [B, N] low-32 leaf shares in natural index order
    (the one-hot path).  Memory O(B * N)."""
    ars = arities(n)
    offs = cw_offsets(ars)
    seeds = last[:, None, :]
    for j in range(len(ars)):
        seeds = level_step_mixed(seeds, cw1, cw2, ars, offs, j, prf_method,
                                 aes_impl=aes_impl)
    lo = seeds[..., 0]                                 # [B, N] BFS order
    # natural[perm[p]] = bfs[p]
    perm = mixed_reverse_indices(ars)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size)
    return lo[:, torch.from_numpy(inv).to(lo.device)]


def eval_points_mixed(cw1, cw2, last, indices, *, n: int, prf_method: int,
                      aes_impl: str | None = None) -> torch.Tensor:
    """Root-to-leaf walks: [B] keys x [Q] indices -> [B, Q] int32 low-32
    shares, natural order (O(Q log4 N) PRF calls per key; plain PyTorch
    on every device, ``aes_impl`` its AES formulation)."""
    ars = arities(n)
    offs = cw_offsets(ars)
    idx = torch.as_tensor(indices, dtype=torch.int64, device=last.device)
    bsz, q = last.shape[0], idx.shape[0]
    seeds = last[:, None, :].expand(-1, q, -1).contiguous()
    rem = idx
    for j, a in enumerate(ars):
        b = rem % a                                    # [Q]
        outs = torch.stack(prf_multi(prf_method, seeds, a, aes_impl))
        val = outs.gather(0, b[None, None, :, None].expand(1, bsz, q, 4))[0]
        sel = (seeds[..., 0] & 1).bool()[..., None]    # [B, Q, 1]
        slot = offs[j] + b
        cw = torch.where(sel, cw2[:, slot, :], cw1[:, slot, :])
        seeds = u128.add128(val, cw)
        rem = rem // a
    return seeds[..., 0]


def expand_and_contract_mixed(cw1, cw2, last, table_perm, *, n: int,
                              prf_method: int, chunk_leaves: int | None,
                              aes_impl: str | None = None) -> torch.Tensor:
    """Batched fused mixed-radix evaluation against one shared table.

    cw1, cw2: [B, 64, 4] int32 codeword limbs; last: [B, 4] start seeds;
    table_perm: [N, E] int32 permuted with ``mixed_reverse_indices``
    (or [B, N, E], one such table a key).  ``chunk_leaves`` (rounded
    down to a suffix product of the arities, None = N): leaves per
    frontier subtree (AES, DUMMY) or per K2 block (the stream ciphers);
    it changes no bit of the result.  ``aes_impl``: the formulation of
    K1's plain version on CPU tensors.  Returns [B, E] int32 server
    shares.
    """
    if table_perm.shape[-2] != n:
        raise ValueError("table of %d rows for n=%d"
                         % (table_perm.shape[-2], n))
    ars = arities(n)
    c = _suffix_chunk(ars, chunk_leaves or n)[1]
    if prf_method in SUBTREE_PRFS:
        from ..ops.subtree import subtree_contract_mixed
        return subtree_contract_mixed(last[:, None, :], cw1, cw2, table_perm,
                                      ars=ars, f_lv=0, prf_method=prf_method,
                                      block_leaves=c)
    return eval_dispatch_mixed(cw1, cw2, last, table_perm, n=n,
                               prf_method=prf_method, chunk_leaves=c,
                               aes_impl=aes_impl)


def eval_dispatch_mixed(cw1, cw2, last, table_perm, *, n: int,
                        prf_method: int, chunk_leaves: int | None,
                        group: int | None = None,
                        deadline: float | None = None,
                        aes_impl: str | None = None) -> torch.Tensor:
    """Per-level evaluation of the radix-4 tree (port of
    ``radix4.eval_dispatch_mixed``): the same shares as
    ``expand_and_contract_mixed``, one launch a level.  AES levels go to
    K1 at the level's arity (the last of each group storing only the
    leaves' low limbs), a binary ChaCha20 base level (odd depth) to K5,
    the other levels to the plain mixed step; each
    group of ``group`` frontier subtrees (None = auto) goes to K3 (to K6
    when ``table_perm`` is ``[B, N, E]``, one table a key).
    ``chunk_leaves`` is rounded down to a product of trailing arities
    (None = N); ``deadline`` is checked before every launch;
    ``aes_impl``: the formulation of K1's plain version on CPU
    tensors."""
    if table_perm.shape[-2] != n:
        raise ValueError("table of %d rows for n=%d"
                         % (table_perm.shape[-2], n))
    ars = arities(n)
    offs = cw_offsets(ars)
    f_lv, c = _suffix_chunk(ars, chunk_leaves or n)

    def level(s, j, low32):
        return level_step_mixed(s, cw1, cw2, ars, offs, j, prf_method,
                                low32, aes_impl)

    return dispatch_contract(last, table_perm, level, len(ars), f_lv, c,
                             group, deadline)


def expand_and_contract_per_key_tables_mixed(cw1, cw2, last, tables_perm,
                                             *, n: int, prf_method: int,
                                             chunk_leaves: int | None = None
                                             ) -> torch.Tensor:
    """Radix-4 fused evaluation where every key has its own table (port
    of ``radix4.expand_and_contract_per_key_tables_mixed``, the batch-PIR
    bin protocol's one-dispatch-per-round path).

    tables_perm: ``[B, N, E]`` int32, each permuted with
    ``mixed_reverse_indices`` and contiguous.  Returns ``[B, E]`` int32
    shares.  Routed as ``expand_and_contract_mixed``: the stream ciphers
    through the mixed K2's per-key mode from the root (``chunk_leaves``
    its block subtree, a product of trailing arities of at most 4096,
    else ValueError; None = ``subtree.pkt_block_leaves``), AES and DUMMY
    through ``eval_dispatch_mixed`` with K6 per group (``chunk_leaves``
    rounded down to a suffix product of the arities, None = N).
    ``chunk_leaves`` changes no bit of the result."""
    if tables_perm.dim() != 3 or tables_perm.shape[0] != last.shape[0]:
        raise ValueError("per-key tables %s for %d keys"
                         % (tuple(tables_perm.shape), last.shape[0]))
    if prf_method in SUBTREE_PRFS:
        from ..ops.subtree import subtree_contract_mixed
        return subtree_contract_mixed(last[:, None, :], cw1, cw2,
                                      tables_perm, ars=arities(n), f_lv=0,
                                      prf_method=prf_method,
                                      block_leaves=chunk_leaves)
    return eval_dispatch_mixed(cw1, cw2, last, tables_perm, n=n,
                               prf_method=prf_method,
                               chunk_leaves=chunk_leaves)
