"""The sqrt-N DPF: the frozen key generator and wire codec, and the plain
reference evaluation of server shares.

The table of N = 2^d rows is an R x K grid, row x at grid row r = x // K
and column j = x % K, with the program's split K = 2^ceil(d / 2), R =
N / K (1,024 x 1,024 at 2^20).  Key generation is a copy of the
program's ``core/sqrtn.generate_sqrt_keys`` (the upstream GPU-DPF
sqrt-N construction, ``dpf_base/dpf.h`` ``GenerateSeedsAndCodewords``):
each server holds K 128-bit column seeds, equal across the two servers
except at the target column, where their least significant bits are
opposite; both hold the codeword rows ``cw1[R]`` and ``cw2[R]``, with
``cw2 - cw1 = PRF(s1, r) - PRF(s2, r) - beta [r = r*]`` when server 0's
target seed ``s1`` is even, and its negation when it is odd.  Every
secret comes from SHAKE-256 over the key's seed, drawn in the program's
order: the K column seeds (the target column takes two draws, server
0's and then server 1's, whose LSB is then set opposite), then one
``cw1`` draw a row.  The PRF is the cipher keyed by the seed at position
r (``ciphers/chacha20.py``'s core; its ``prf_pair`` gives positions 0
and 1 only).  Wire format: 128-bit little-endian slots ``[K | R | n |
pad | seeds[K] | cw1[R] | cw2[R]]``, (4 + K + 2R) * 4 int32 words.

The reference evaluates each grid cell as ``PRF(seed_j, r) +
cw_{lsb(seed_j)}[r]`` mod 2^128 in natural order (x = r * K + j), keeps
its low 32 bits and contracts them with the table in Z_2^32
(``logn.contract``; ``logn.contract_float32`` for the control).
Everything is integer arithmetic in int64 tensors, so no TF32 path
applies.  Nothing here calls the program.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from pirbench.constructions.logn import contract, contract_float32
from pirbench.harness.limbs import MASK32, add128, neg128, sub128

#: grid cells a reference or keygen PRF call takes at once (bounds its
#: memory)
CELL_BLOCK = 1 << 20


def default_split(n: int) -> tuple:
    """(K, R): K = 2^ceil(d / 2) columns, R = n / K rows, n = 2^d."""
    d = n.bit_length() - 1
    k = 1 << ((d + 1) // 2)
    return k, n // k


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


def _prf_at(cipher, seeds: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """[M, 4] seeds at [M] positions -> [M, 4] outputs, CELL_BLOCK rows a
    call."""
    out = torch.empty_like(seeds)
    for lo in range(0, seeds.shape[0], CELL_BLOCK):
        out[lo:lo + CELL_BLOCK] = cipher._core(seeds[lo:lo + CELL_BLOCK],
                                               pos[lo:lo + CELL_BLOCK])
    return out


# --------------------------------------------------------------- keygen

def _wire(seeds, cw1, cw2, k: int, r: int, n: int) -> np.ndarray:
    b = seeds.shape[0]
    slots = np.zeros((b, 4 + k + 2 * r, 4), dtype=np.uint32)
    slots[:, 0, 0] = k
    slots[:, 1, 0] = r
    slots[:, 2, 0] = n & MASK32
    slots[:, 2, 1] = n >> 32
    slots[:, 4:4 + k] = seeds.numpy()
    slots[:, 4 + k:4 + k + r] = cw1.numpy()
    slots[:, 4 + k + r:] = cw2.numpy()
    return slots.reshape(b, -1).view(np.int32)


def gen(alphas, n: int, seeds, cipher, beta: int = 1):
    """Both servers' keys for the point functions f(alpha_i) = beta over
    [0, n), key i from DRBG seed ``seeds[i]``.  The PRF runs on the card
    when there is one.  Returns two [B, (4 + K + 2R) * 4] int32 arrays
    (server 0, server 1)."""
    alphas = np.asarray(alphas, dtype=np.int64).reshape(-1)
    if n & (n - 1) or n < 4:
        raise ValueError("n must be a power of two >= 4 (got %d)" % n)
    if (alphas < 0).any() or (alphas >= n).any():
        raise ValueError("every alpha must lie in [0, n)")
    k, r = default_split(n)
    bsz = alphas.size
    draws = torch.from_numpy(np.stack(
        [_drbg(s, k + 1 + r) for s in seeds]).astype(np.int64))
    rows_b = torch.arange(bsz)
    j_t = torch.from_numpy(alphas % k)
    r_t = torch.from_numpy(alphas // k)
    cols = torch.arange(k)[None, :]
    keys0 = draws[rows_b[:, None], cols + (cols > j_t[:, None])]  # [B, K, 4]
    s1 = keys0[rows_b, j_t]
    s2 = draws[rows_b, j_t + 1].clone()
    s2[:, 0] = (s2[:, 0] & (MASK32 - 1)) | (1 ^ (s1[:, 0] & 1))
    keys1 = keys0.clone()
    keys1[rows_b, j_t] = s2

    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    pos = torch.arange(r, device=dev).repeat(bsz)

    def grid_prf(s):                               # [B, 4] -> [B, R, 4]
        return _prf_at(cipher, s.to(dev).repeat_interleave(r, dim=0),
                       pos).reshape(bsz, r, 4).cpu()

    diff = sub128(grid_prf(s1), grid_prf(s2))
    beta_c = torch.tensor([(beta >> (32 * i)) & MASK32 for i in range(4)],
                          dtype=torch.int64)
    target = (torch.arange(r)[None, :] == r_t[:, None])[..., None]
    diff = torch.where(target, sub128(diff, beta_c.expand_as(diff)), diff)
    s1_even = ((s1[:, 0] & 1) == 0)[:, None, None]
    diff = torch.where(s1_even, diff, neg128(diff))
    cw1 = draws[:, k + 1:]
    cw2 = add128(cw1, diff)
    return (_wire(keys0, cw1, cw2, k, r, n), _wire(keys1, cw1, cw2, k, r, n))


def decode(wire: np.ndarray, device) -> tuple:
    """[S, (4 + K + 2R) * 4] int32 wire keys -> (seeds [S, K, 4], cw1
    [S, R, 4], cw2 [S, R, 4]) int64 limb tensors on ``device``."""
    slots = np.ascontiguousarray(wire, dtype=np.int32).view(
        np.uint32).reshape(wire.shape[0], -1, 4)
    k, r = int(slots[0, 0, 0]), int(slots[0, 1, 0])
    if slots.shape[1] != 4 + k + 2 * r:
        raise ValueError("malformed sqrt-N key: %d slots for K=%d R=%d"
                         % (slots.shape[1], k, r))
    t = torch.from_numpy(slots.astype(np.int64)).to(device)
    return t[:, 4:4 + k], t[:, 4 + k:4 + k + r], t[:, 4 + k + r:]


# ------------------------------------------------------------ reference

def expand_low(wire: np.ndarray, cipher, device) -> torch.Tensor:
    """[S, W] keys -> [S, N] int64: each cell's low 32 bits, in natural
    order, computed a block of whole grid rows at a time."""
    seeds, cw1, cw2 = decode(wire, device)
    s, k, _ = seeds.shape
    r = cw1.shape[1]
    odd = (seeds[:, :, 0] & 1).bool()[:, None, :, None]       # [S, 1, K, 1]
    out = torch.empty((s, r * k), dtype=torch.int64, device=device)
    step = max(1, CELL_BLOCK // (s * k))
    for lo in range(0, r, step):
        hi = min(r, lo + step)
        nr = hi - lo
        sd = seeds[:, None].expand(s, nr, k, 4).reshape(-1, 4)
        pos = torch.arange(lo, hi, device=device)[None, :, None].expand(
            s, nr, k).reshape(-1)
        vals = _prf_at(cipher, sd, pos).reshape(s, nr, k, 4)
        cw = torch.where(odd, cw2[:, lo:hi, None], cw1[:, lo:hi, None])
        out[:, lo * k:hi * k] = add128(vals, cw)[..., 0].reshape(s, nr * k)
    return out


def shares(wire: np.ndarray, table: torch.Tensor, cipher, *,
           control: bool = False, keys_per_block: int = 8) -> np.ndarray:
    """Server shares of ``wire`` keys over ``table`` ([N, E] int32 in
    natural row order, on the device the reference runs on): [S, E]
    int32.  ``control`` contracts in float32 (``logn.contract_float32``)."""
    fn = contract_float32 if control else contract
    out = []
    for lo in range(0, wire.shape[0], keys_per_block):
        low = expand_low(wire[lo:lo + keys_per_block], cipher, table.device)
        out.append(fn(low, table).cpu())
        del low
    return torch.cat(out).numpy().astype(np.uint32).view(np.int32)
