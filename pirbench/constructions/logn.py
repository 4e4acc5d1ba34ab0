"""The binary GGM tree DPF ("log-N"): the frozen key generator and wire
codec, and the plain reference evaluation of server shares.

Key generation is a copy of the program's ``core/keygen.gen_batched``
(the upstream GPU-DPF construction: the seed's least significant bit is
the control bit; each level has a pair of 128-bit codewords a server
view, ``cw1`` taken under an even seed and ``cw2`` under an odd one;
index bits are consumed least significant first), with the PRF from
``ciphers/``.  Every secret comes from SHAKE-256 over the key's seed.
Wire format: 524 int32 words = 131 little-endian 128-bit slots:
``[0] = depth, [1..64] = cw1, [65..128] = cw2, [129] = start seed,
[130] = n``.

The reference expands a key over all N leaves level by level,
breadth-first (position p holds leaf bit_reverse(p)), keeps each leaf's
low 32 bits, and contracts them with the table rows in Z_2^32:
``share[e] = sum_j leaf_j * table[j, e] mod 2^32``.  Nothing here calls
the program.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from pirbench.harness.limbs import MASK32, add128, neg128, sub128

WIRE_WORDS = 524
#: parent nodes a reference PRF call takes at once (bounds its memory)
NODE_BLOCK = 1 << 19


# --------------------------------------------------------------- keygen

def _drbg(seed: bytes, n_draws: int) -> np.ndarray:
    """The first ``n_draws`` 128-bit draws of SHAKE-256(seed || counter)
    as [n_draws, 4] uint32 limbs."""
    buf = b""
    ctr = 0
    while len(buf) < 16 * n_draws:
        buf += hashlib.shake_256(seed + ctr.to_bytes(8, "little")).digest(1024)
        ctr += 1
    return np.frombuffer(buf[:16 * n_draws], dtype=np.uint32).reshape(
        n_draws, 4)


def _odd(v):
    v = v.clone()
    v[:, 0] |= 1
    return v


def _even(v):
    v = v.clone()
    v[:, 0] &= MASK32 - 1
    return v


def _wire(cw1, cw2, last, depth: int, n: int) -> np.ndarray:
    b = last.shape[0]
    slots = np.zeros((b, 131, 4), dtype=np.uint32)
    slots[:, 0, 0] = depth
    slots[:, 1:65] = cw1.numpy()
    slots[:, 65:129] = cw2.numpy()
    slots[:, 129] = last.numpy()
    slots[:, 130, 0] = n & MASK32
    slots[:, 130, 1] = n >> 32
    return slots.reshape(b, -1).view(np.int32)


def gen(alphas, n: int, seeds, cipher, beta: int = 1):
    """Both servers' keys for the point functions f(alpha_i) = beta over
    [0, n), key i from DRBG seed ``seeds[i]``.  Returns two [B, 524]
    int32 arrays (server 0, server 1)."""
    alphas = np.asarray(alphas, dtype=np.int64).reshape(-1)
    if n & (n - 1) or n < 4:
        raise ValueError("n must be a power of two >= 4 (got %d)" % n)
    if (alphas < 0).any() or (alphas >= n).any():
        raise ValueError("every alpha must lie in [0, n)")
    depth = n.bit_length() - 1
    bsz = alphas.size
    n_draws = 3 * depth + 1
    draws = torch.from_numpy(np.stack(
        [_drbg(s, n_draws) for s in seeds]).astype(np.int64))
    draws = iter(draws.unbind(1))
    beta_c = torch.tensor([[beta & MASK32, (beta >> 32) & MASK32,
                            (beta >> 64) & MASK32, (beta >> 96) & MASK32]],
                          dtype=torch.int64).expand(bsz, 4)
    bits = torch.from_numpy((alphas[:, None] >> np.arange(depth)) & 1)
    cw1 = torch.zeros((bsz, 64, 4), dtype=torch.int64)
    cw2 = torch.zeros((bsz, 64, 4), dtype=torch.int64)
    rows = torch.arange(bsz)

    def pick(pair, tb):
        return torch.where((tb == 1)[:, None], pair[1], pair[0])

    # the base level (flat index depth - 1) takes bit 0 of alpha
    k1 = _even(next(draws))
    k2 = _odd(next(draws))
    beta_l = _odd(next(draws))
    i = depth - 1
    b0 = bits[:, 0]
    c1 = [next(draws), next(draws)]
    p1, p2 = cipher.prf_pair(k1), cipher.prf_pair(k2)
    for b in (0, 1):
        d = sub128(p1[b], p2[b])
        d = torch.where((b0 == b)[:, None], sub128(d, beta_l), d)
        cw1[:, 2 * i + b] = c1[b]
        cw2[:, 2 * i + b] = add128(c1[b], d)
    s1 = add128(pick(p1, b0), torch.where((b0 == 1)[:, None], c1[1], c1[0]))
    s2 = add128(pick(p2, b0), cw2[rows, 2 * i + b0])

    # the levels above, bottom to top
    for lvl in range(1, depth):
        if not torch.equal(sub128(s1, s2), beta_l):
            raise AssertionError("keygen invariant broken at level %d" % lvl)
        i = depth - 1 - lvl
        beta_l = beta_c if lvl == depth - 1 else _odd(next(draws))
        tb = bits[:, lvl]
        s1_even = ((s1[:, 0] & 1) == 0)[:, None]
        c1 = [next(draws), next(draws)]
        p1, p2 = cipher.prf_pair(s1), cipher.prf_pair(s2)
        for b in (0, 1):
            d = sub128(p2[b], p1[b])
            d = torch.where(s1_even, neg128(d), d)
            cw2[:, 2 * i + b] = add128(c1[b], d)
        adj = torch.where(s1_even, beta_l, neg128(beta_l))
        c1 = [torch.where((tb == b)[:, None], add128(c1[b], adj), c1[b])
              for b in (0, 1)]
        for b in (0, 1):
            cw1[:, 2 * i + b] = c1[b]
        c1_t = torch.where((tb == 1)[:, None], c1[1], c1[0])
        cw2_t = cw2[rows, 2 * i + tb]
        s1, s2 = (add128(pick(p1, tb), torch.where(s1_even, c1_t, cw2_t)),
                  add128(pick(p2, tb), torch.where(s1_even, cw2_t, c1_t)))
    return (_wire(cw1, cw2, k1, depth, n), _wire(cw1, cw2, k2, depth, n))


def decode(wire: np.ndarray, device) -> tuple:
    """[S, 524] int32 wire keys -> (cw1 [S, 64, 4], cw2 [S, 64, 4],
    start seeds [S, 4]) int64 limb tensors on ``device``, and depth."""
    slots = np.ascontiguousarray(wire, dtype=np.int32).view(
        np.uint32).reshape(-1, 131, 4).astype(np.int64)
    depth = int(slots[0, 0, 0])
    t = torch.from_numpy(slots).to(device)
    return t[:, 1:65], t[:, 65:129], t[:, 129], depth


# ------------------------------------------------------------ reference

def bit_reverse(n: int) -> torch.Tensor:
    """p -> bit_reverse(p) over log2(n) bits."""
    bits = n.bit_length() - 1
    idx = torch.arange(n, dtype=torch.int64)
    rev = torch.zeros_like(idx)
    for b in range(bits):
        rev |= ((idx >> b) & 1) << (bits - 1 - b)
    return rev


def expand_low(wire: np.ndarray, cipher, device) -> torch.Tensor:
    """[S, 524] keys -> [S, N] int64: each leaf's low 32 bits, in
    breadth-first order."""
    cw1, cw2, seeds, depth = decode(wire, device)
    s = seeds[:, None, :]                                   # [S, 1, 4]
    for i in range(depth - 1, -1, -1):
        nk, w, _ = s.shape
        flat = s.reshape(-1, 4)
        kids = [torch.empty_like(flat), torch.empty_like(flat)]
        for lo in range(0, flat.shape[0], NODE_BLOCK):
            p0, p1 = cipher.prf_pair(flat[lo:lo + NODE_BLOCK])
            kids[0][lo:lo + NODE_BLOCK] = p0
            kids[1][lo:lo + NODE_BLOCK] = p1
        odd = (s[..., 0] & 1).bool()[..., None]
        out = []
        for b in (0, 1):
            cw = torch.where(odd, cw2[:, None, 2 * i + b],
                             cw1[:, None, 2 * i + b])
            out.append(add128(kids[b].reshape(nk, w, 4), cw))
        s = torch.stack(out, dim=2).reshape(nk, 2 * w, 4)
        del kids, out
    return s[..., 0].contiguous()


def contract(low: torch.Tensor, table_bfs: torch.Tensor) -> torch.Tensor:
    """Exact shares in Z_2^32: [S, N] leaf words (0 .. 2^32 - 1) and the
    [N, E] table in breadth-first row order -> [S, E] int64 words.  Each
    leaf word is split into bytes so that every product and sum stays
    below 2^63."""
    t = table_bfs.to(torch.int64) & MASK32
    out = torch.zeros((low.shape[0], t.shape[1]), dtype=torch.int64,
                      device=low.device)
    for s in range(low.shape[0]):
        for k in range(4):
            byte = (low[s] >> (8 * k)) & 0xFF
            part = (byte[:, None] * t).sum(0) & MASK32
            out[s] = (out[s] + (part << (8 * k))) & MASK32
    return out


def contract_float32(low: torch.Tensor, table_bfs: torch.Tensor):
    """The control: the same contraction as a float32 matrix product
    (TF32 off), the shortcut a float tensor-core path would take, which
    drops the low bits that Z_2^32 keeps."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        prod = low.to(torch.float32) @ (table_bfs.to(torch.int64)
                                        & MASK32).to(torch.float32)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    return prod.to(torch.float64).remainder(2.0 ** 32).to(torch.int64)


def shares(wire: np.ndarray, table: torch.Tensor, cipher, *,
           control: bool = False, keys_per_block: int = 8) -> np.ndarray:
    """Server shares of ``wire`` keys over ``table`` ([N, E] int32 in
    natural row order, on the device the reference runs on): [S, E]
    int32.  ``control`` contracts in float32 (``contract_float32``)."""
    n = table.shape[0]
    table_bfs = table[bit_reverse(n).to(table.device)]
    fn = contract_float32 if control else contract
    out = []
    for lo in range(0, wire.shape[0], keys_per_block):
        low = expand_low(wire[lo:lo + keys_per_block], cipher, table.device)
        out.append(fn(low, table_bfs).cpu())
        del low
    return torch.cat(out).numpy().astype(np.uint32).view(np.int32)
