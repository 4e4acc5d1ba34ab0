"""Sqrt-N DPF construction: O(sqrt N) keys, one flat PRF grid per key.

Port of ``dpf_tpu/core/sqrtn.py``.  The table of N entries is an
``R x K`` grid (rows ``R = n_codewords``, columns ``K = n_keys``, index
``x = r * K + j``).  Each server holds K 128-bit column seeds, equal
across servers except at the target column, where the two seeds have
opposite LSBs; both hold the same codeword rows ``cw1[R]``, ``cw2[R]``.
A server's share at ``x`` is ``PRF(seed_j, r) + cw[lsb(seed_j)][r]``
mod 2^128, so the grid comes out in natural order and the table needs
no permutation.

The key generator and codec are the JAX package's numpy host code,
copied so this package imports no JAX; wire keys are identical for the
same ``(alpha, n, seed, prf)``.  Wire format: ``[K | R | n | pad |
keys[K] | cw1[R] | cw2[R]]`` as uint128 little-endian slots viewed as
int32, ``(4 + K + 2R) * 4`` words.  Evaluation runs on int32 limb
tensors:

* ``eval_contract_batched`` -- the server's fused path: K4
  ``ops/sqrt_grid.sqrt_grid_contract`` on CUDA tensors (every PRF id),
  its plain version (the port of the JAX row-chunked scan) on CPU ones;
* ``eval_contract_per_key_tables`` -- the batch-PIR form, every key with
  its own natural-order table (``[B, N, E]``): K4's per-key mode on CUDA
  tensors, the plain scan on CPU ones;
* ``eval_grid`` (one key's one-hot share) and ``eval_points_sqrt`` (one
  PRF call per queried index), plain PyTorch on any device.

``gen_sqrt_batched`` is the batched generator: one PRF call over the
``[B, R]`` target-column grid of ``[B, R, 4]`` limb tensors.
``eval_sharded_sqrt`` is the mesh path: the grid's rows split over the
mesh's "table" axis, K4 on each shard from its first grid row.  The
per-key reference ``eval_contract`` is not ported.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from . import u128
from .expand import CHUNK_SEED_BYTES_BOUND
from .keygen import (Shake256Drbg, _check_batch_args, beta_limbs,
                     drbg_u128_batch, stack_wire_keys)
from .prf import _BLK_WORDS, _blk_group, prf_v
from .prf_ref import MASK128, PRF_FUNCS
from .u32 import from_u32, i32


@dataclass
class SqrtKey:
    """One server's sqrt-N DPF key (host representation)."""
    n_keys: int          # K -- column seeds
    n_codewords: int     # R -- rows (N = R * K)
    n: int
    keys: np.ndarray     # [K, 4] uint32 limbs
    cw1: np.ndarray      # [R, 4] uint32
    cw2: np.ndarray      # [R, 4] uint32

    def serialize(self) -> np.ndarray:
        k, r = self.n_keys, self.n_codewords
        slots = np.zeros((4 + k + 2 * r, 4), dtype=np.uint32)
        slots[0] = u128.int_to_limbs(k)
        slots[1] = u128.int_to_limbs(r)
        slots[2] = u128.int_to_limbs(self.n)
        slots[4:4 + k] = self.keys
        slots[4 + k:4 + k + r] = self.cw1
        slots[4 + k + r:] = self.cw2
        return slots.reshape(-1).view(np.int32).copy()


def _wire_words(arr) -> np.ndarray:
    if hasattr(arr, "detach"):  # torch tensor, any device
        arr = arr.detach().cpu().numpy()
    return np.asarray(arr, dtype=np.int32).reshape(-1)


def deserialize_sqrt_key(arr) -> SqrtKey:
    flat = _wire_words(arr)
    if flat.size % 4 or flat.size < 8:
        raise ValueError("malformed sqrt-N key: %d int32 words" % flat.size)
    slots = flat.view(np.uint32).reshape(-1, 4)
    k = int(slots[0, 0])
    r = int(slots[1, 0])
    if slots.shape[0] != 4 + k + 2 * r:
        raise ValueError("malformed sqrt-N key: %d slots for K=%d R=%d"
                         % (slots.shape[0], k, r))
    n = u128.limbs_to_int(slots[2])
    if k * r != n:
        raise ValueError("malformed sqrt-N key: n=%d != K*R=%d" % (n, k * r))
    return SqrtKey(n_keys=k, n_codewords=r, n=n,
                   keys=slots[4:4 + k].copy(),
                   cw1=slots[4 + k:4 + k + r].copy(),
                   cw2=slots[4 + k + r:].copy())


def default_split(n: int) -> tuple[int, int]:
    """Balanced power-of-two grid: K = 2^ceil(d/2), R = N / K."""
    d = n.bit_length() - 1
    k = 1 << ((d + 1) // 2)
    return k, n // k


def generate_sqrt_keys(alpha: int, n: int, seed: bytes, prf_method: int,
                       beta: int = 1, n_keys: int | None = None):
    """-> (SqrtKey server1, SqrtKey server2) with share difference
    ``v1[x] - v2[x] = beta * [x == alpha]`` mod 2^128."""
    if n & (n - 1):
        raise ValueError("n must be a power of two")
    if not 0 <= alpha < n:
        raise ValueError("alpha out of range")
    k = n_keys or default_split(n)[0]
    if n % k:
        raise ValueError("n_keys must divide n")
    r = n // k
    j_t, r_t = alpha % k, alpha // k

    rng = Shake256Drbg(seed)
    keys1 = np.zeros((k, 4), dtype=np.uint32)
    keys2 = np.zeros((k, 4), dtype=np.uint32)
    for j in range(k):
        if j == j_t:
            # uniform seed for server 1, server 2 uniform with the
            # opposite LSB: marginally both are uniform
            s1_val = rng.u128()
            keys1[j] = u128.int_to_limbs(s1_val)
            keys2[j] = u128.int_to_limbs(
                (rng.u128() & ~1) | (1 ^ (s1_val & 1)))
        else:
            keys1[j] = keys2[j] = u128.int_to_limbs(rng.u128())

    prf = PRF_FUNCS[prf_method]
    s1 = u128.limbs_to_int(keys1[j_t])
    s2 = u128.limbs_to_int(keys2[j_t])
    # the evaluator picks cw_{lsb(seed)}: with server 1 holding the even
    # seed cw2 - cw1 = PRF(s1) - PRF(s2) - beta [r == r*], negated when
    # the roles are swapped
    s1_even = (s1 & 1) == 0
    cw1 = np.zeros((r, 4), dtype=np.uint32)
    cw2 = np.zeros((r, 4), dtype=np.uint32)
    for row in range(r):
        diff = (prf(s1, row) - prf(s2, row)) & MASK128
        if row == r_t:
            diff = (diff - beta) & MASK128
        if not s1_even:
            diff = (-diff) & MASK128
        c1 = rng.u128()
        cw1[row] = u128.int_to_limbs(c1)
        cw2[row] = u128.int_to_limbs((c1 + diff) & MASK128)

    args = dict(n_keys=k, n_codewords=r, n=n)
    return (SqrtKey(keys=keys1, cw1=cw1, cw2=cw2, **args),
            SqrtKey(keys=keys2, cw1=cw1, cw2=cw2, **args))


def gen_sqrt_batched(alphas, n: int, seeds=None, *, prf_method: int,
                     beta: int = 1, n_keys: int | None = None,
                     knobs=None):
    """Two servers' sqrt-N keys for B indices over one domain ``n``.

    The sqrt-N ``keygen.gen_batched``: one DRBG squeeze per key, then
    ONE PRF call over the ``[B, R]`` grid of target-column seeds and
    rows instead of ``O(B R)`` calls on Python ints; row i is
    byte-identical to ``generate_sqrt_keys(alphas[i], n, seeds[i])``.
    ``knobs``: ``prf_group="stacked"`` makes it one call over the
    ``[2B, R]`` grid of both servers' seeds; ``squeeze_draws`` as
    ``keygen.drbg_u128_batch``.  Returns two ``[B, (4 + K + 2R) * 4]``
    int32 CPU tensors."""
    alphas, seeds = _check_batch_args(alphas, n, seeds)
    kn = dict(knobs or {})
    k = n_keys or default_split(n)[0]
    if n % k:
        raise ValueError("n_keys must divide n")
    r = n // k
    bsz = alphas.size
    j_t = torch.from_numpy(alphas % k)
    r_t = torch.from_numpy(alphas // k)
    # per key: K + 1 column draws (the target column takes two, its
    # server-1 seed and then server 2's), then one codeword draw a row:
    # the scalar generator's draw order
    draws = drbg_u128_batch(seeds, k + 1 + r,
                            squeeze_draws=kn.get("squeeze_draws"))
    rows_b = torch.arange(bsz)
    cols = torch.arange(k)[None, :]
    keys1 = draws[rows_b[:, None], cols + (cols > j_t[:, None])]  # [B, K, 4]
    s1v = keys1[rows_b, j_t]                                      # [B, 4]
    s2v = draws[rows_b, j_t + 1].clone()
    s2v[:, 0] = (s2v[:, 0] & -2) | (1 ^ (s1v[:, 0] & 1))
    keys2 = keys1.clone()
    keys2[rows_b, j_t] = s2v

    rows = torch.arange(r, dtype=torch.int32)
    if kn.get("prf_group") == "stacked":
        both = prf_v(prf_method, torch.cat([s1v, s2v])[:, None, :].expand(
            2 * bsz, r, 4), rows)
        p1, p2 = both[:bsz], both[bsz:]
    else:
        p1 = prf_v(prf_method, s1v[:, None, :].expand(bsz, r, 4), rows)
        p2 = prf_v(prf_method, s2v[:, None, :].expand(bsz, r, 4), rows)
    diff = u128.sub128(p1, p2)                                    # [B, R, 4]
    target = (rows.long()[None, :] == r_t[:, None])[..., None]
    diff = torch.where(target, u128.sub128(
        diff, beta_limbs(beta, bsz)[:, None, :]), diff)
    s1_even = ((s1v[:, 0] & 1) == 0)[:, None, None]
    diff = torch.where(s1_even, diff, u128.neg128(diff))
    cw1 = draws[:, k + 1:]                                        # [B, R, 4]
    cw2 = u128.add128(cw1, diff)

    def wire(key_seeds):
        slots = torch.zeros((bsz, 4 + k + 2 * r, 4), dtype=torch.int32)
        slots[:, 0, 0] = k
        slots[:, 1, 0] = r
        slots[:, 2, 0] = i32(n)
        slots[:, 2, 1] = n >> 32
        slots[:, 4:4 + k] = key_seeds
        slots[:, 4 + k:4 + k + r] = cw1
        slots[:, 4 + k + r:] = cw2
        return slots.reshape(bsz, -1)

    return wire(keys1), wire(keys2)


# ------------------------------------------------------------ the grid

def _row_positions(r: int, row0: int, device) -> torch.Tensor:
    """Rows row0 .. row0 + r - 1 as an int32 tensor read as uint32."""
    rows = (torch.arange(r, dtype=torch.int64, device=device) + int(row0)) \
        & 0xFFFFFFFF
    return torch.where(rows >= 1 << 31, rows - (1 << 32), rows).to(
        torch.int32)


def _grid_vals(prf_method: int, seeds_row, r: int, row0: int = 0,
               device=None) -> torch.Tensor:
    """PRF values over rows row0 .. row0 + r - 1 for a seed tensor
    broadcast along a row axis (``seeds_row(nr)`` gives seeds shaped
    ``[..., nr, K, 4]`` or broadcastable to it).  For the block-PRG ids
    (4/5) rows 4c .. 4c+3 are the four word groups of one core block at
    counter c: ceil(r/4) blocks are evaluated and interleaved, so
    ``row0`` must then be a multiple of 4.  Returns ``[..., r, K, 4]``."""
    if prf_method not in _BLK_WORDS:
        rows = _row_positions(r, row0, device)[:, None]
        return prf_v(prf_method, seeds_row(r), rows)
    nctr = -(-r // 4)
    ctr = _row_positions(nctr, int(row0) >> 2, device)[:, None]
    out16 = _BLK_WORDS[prf_method](seeds_row(nctr), ctr)
    groups = torch.stack([_blk_group(out16, 4 * g) for g in range(4)],
                         dim=-3)                      # [.., C, 4, K, 4]
    flat = groups.reshape(groups.shape[:-4] + (4 * nctr,)
                          + groups.shape[-2:])
    return flat[..., :r, :, :]


def eval_grid(key: SqrtKey, prf_method: int, device=None) -> torch.Tensor:
    """Full one-hot share in natural order: [N] int32 (low 32 bits).

    One vectorized PRF call over the [R, K] grid (seeds broadcast along
    rows, positions along columns), then the LSB select of the codeword
    row."""
    k, r = key.n_keys, key.n_codewords
    keys = from_u32(key.keys).to(device)              # [K, 4]
    vals = _grid_vals(prf_method,
                      lambda nr: keys[None].expand(nr, k, 4), r,
                      device=keys.device)             # [R, K, 4]
    sel = (keys[None, :, 0] & 1).bool()[..., None]
    cw = torch.where(sel, from_u32(key.cw2).to(device)[:, None, :],
                     from_u32(key.cw1).to(device)[:, None, :])
    return u128.add128(vals, cw)[..., 0].reshape(-1)  # x = r*K + j


def pack_sqrt_keys(keys: list) -> tuple:
    """List of SqrtKey (uniform K, R) -> (seeds [B,K,4], cw1 [B,R,4],
    cw2 [B,R,4]) uint32 arrays for the batched device path."""
    k, r = keys[0].n_keys, keys[0].n_codewords
    bsz = len(keys)
    seeds = np.zeros((bsz, k, 4), dtype=np.uint32)
    cw1 = np.zeros((bsz, r, 4), dtype=np.uint32)
    cw2 = np.zeros((bsz, r, 4), dtype=np.uint32)
    for i, kk in enumerate(keys):
        if (kk.n_keys, kk.n_codewords) != (k, r):
            raise ValueError("keys for mixed sqrt-N splits")
        seeds[i] = kk.keys
        cw1[i] = kk.cw1
        cw2[i] = kk.cw2
    return seeds, cw1, cw2


# ------------------------------------------------------ packed-batch codec

@dataclass
class PackedSqrtKeys:
    """A sqrt-N key batch decoded into device-layout arrays, with the
    ``batch``/``slice`` surface of ``keygen.PackedKeys``."""
    seeds: np.ndarray    # [B, K, 4] uint32 column seeds
    cw1: np.ndarray      # [B, R, 4] uint32
    cw2: np.ndarray      # [B, R, 4] uint32
    n: int               # shared table size (N = K * R)

    @property
    def n_keys(self) -> int:
        return self.seeds.shape[1]

    @property
    def n_codewords(self) -> int:
        return self.cw1.shape[1]

    @property
    def batch(self) -> int:
        return self.seeds.shape[0]

    def slice(self, lo: int, hi: int) -> "PackedSqrtKeys":
        return PackedSqrtKeys(self.seeds[lo:hi], self.cw1[lo:hi],
                              self.cw2[lo:hi], self.n)


def stack_sqrt_wire_keys(keys) -> np.ndarray:
    """Key batch (list of flat int32 array-likes, torch tensors included,
    or one [B, W] array) -> one contiguous [B, W] int32 buffer; ragged
    widths can only come from mixed splits and are rejected as such."""
    if len(keys) == 0:
        raise ValueError("empty key batch")
    try:
        return stack_wire_keys(keys, words=None)
    except ValueError:
        raise ValueError("keys for mixed sqrt-N splits") from None


def sqrt_wire_ns(arr: np.ndarray) -> np.ndarray:
    """Per-key table size n from a stacked [B, W] sqrt-N wire buffer
    (header slot 2, limbs 0/1), with the width check a header read
    needs."""
    if arr.shape[1] % 4 or arr.shape[1] < 16:
        raise ValueError("malformed sqrt-N key: %d int32 words"
                         % arr.shape[1])
    slots = arr.view(np.uint32).reshape(arr.shape[0], -1, 4)
    return (slots[:, 2, 0].astype(np.int64)
            | (slots[:, 2, 1].astype(np.int64) << 32))


def decode_sqrt_keys_batched(keys) -> PackedSqrtKeys:
    """Vectorized wire -> packed-arrays codec for a uniform sqrt-N key
    batch: the wire words are stacked once and every seed and codeword
    limb is a view into that buffer."""
    arr = stack_sqrt_wire_keys(keys)
    if arr.shape[1] % 4 or arr.shape[1] < 8:
        raise ValueError("malformed sqrt-N key: %d int32 words"
                         % arr.shape[1])
    slots = arr.view(np.uint32).reshape(arr.shape[0], -1, 4)
    k = int(slots[0, 0, 0])
    r = int(slots[0, 1, 0])
    if ((slots[:, 0, 0] != np.uint32(k)).any()
            or (slots[:, 1, 0] != np.uint32(r)).any()):
        raise ValueError("keys for mixed sqrt-N splits")
    if slots.shape[1] != 4 + k + 2 * r:
        raise ValueError("malformed sqrt-N key: %d slots for K=%d R=%d"
                         % (slots.shape[1], k, r))
    # n <= 2^32 spills into limb 1; limbs 2/3 are zero on every writer
    n = (slots[:, 2, 0].astype(np.uint64)
         | (slots[:, 2, 1].astype(np.uint64) << np.uint64(32)))
    if (n != n[0]).any():
        raise ValueError("keys for mixed table sizes")
    if slots[:, 2, 2:].any() or k * r != int(n[0]):
        raise ValueError("malformed sqrt-N key: n=%d != K*R=%d"
                         % (int(n[0]), k * r))
    return PackedSqrtKeys(
        seeds=slots[:, 4:4 + k],
        cw1=slots[:, 4 + k:4 + k + r],
        cw2=slots[:, 4 + k + r:],
        n=int(n[0]))


def sqrt_key_views(buf: torch.Tensor, k: int, r: int,
                   pad_to: int | None = None) -> tuple:
    """A staged ``[B, 4 (K + 2R)]`` int32 key buffer on its device (each
    row a key's seeds, cw1 and cw2, as the wire holds them after its
    header) -> (seeds, cw1, cw2) views ``[B, K, 4]``, ``[B, R, 4]``,
    ``[B, R, 4]`` at the buffer's key stride.  ``pad_to`` repeats the
    last key on the device."""
    if pad_to is not None and pad_to > buf.shape[0]:
        buf = torch.cat([buf, buf[-1:].expand(pad_to - buf.shape[0], -1)])

    def view(slot, rows):
        return buf[:, 4 * slot:4 * (slot + rows)].unflatten(1, (rows, 4))
    return view(0, k), view(k, r), view(k + r, r)


# -------------------------------------------------- row-chunk rules

ROW_CHUNK_FLOOR = 4  # the block-PRG 4-row interleave quantum


def row_chunk_within_bound(rc: int, k: int, batch: int) -> bool:
    """True when a [B, rc, K, 4] PRF slab fits the 64 MiB live-seed
    budget shared with the log-N paths (the 4-row floor is always
    allowed)."""
    return rc <= ROW_CHUNK_FLOOR or rc * k * 16 * max(1, batch) <= \
        CHUNK_SEED_BYTES_BOUND


def choose_row_chunk(r: int, k: int, batch: int) -> int:
    """Grid rows PRF-expanded per step of the plain scan: bound the live
    [B, rc, K, 4] slab at 64 MiB.  Always a power-of-two multiple of 4
    dividing R, or R itself when R is too small (or odd-shaped) to
    chunk."""
    if r <= ROW_CHUNK_FLOOR or r % ROW_CHUNK_FLOOR:
        return r
    target = max(ROW_CHUNK_FLOOR,
                 CHUNK_SEED_BYTES_BOUND // (16 * k * max(1, batch)))
    rc = ROW_CHUNK_FLOOR
    while rc * 2 <= target and r % (rc * 2) == 0 and rc * 2 <= r:
        rc *= 2
    return min(rc, r)


def clamp_row_chunk(rc, r: int, k: int, batch: int) -> int:
    """A possibly-tuned ``row_chunk`` hardened against the key split and
    the live-slab budget; falsy or invalid values fall back to the
    heuristic."""
    if (not rc or r % int(rc)
            or (int(rc) < r and int(rc) % ROW_CHUNK_FLOOR)
            or not row_chunk_within_bound(int(rc), k, batch)):
        return choose_row_chunk(r, k, batch)
    return int(rc)


def _resolve_row_chunk(r: int, k: int, bsz: int,
                       row_chunk: int | None) -> int:
    """None -> the ``choose_row_chunk`` heuristic; explicit values must
    divide R and, when actually chunking, be a multiple of
    ``ROW_CHUNK_FLOOR`` so the block-PRG 4-row interleave stays
    intact."""
    if row_chunk is None:
        row_chunk = choose_row_chunk(r, k, bsz)
    row_chunk = int(row_chunk)
    if row_chunk < 1 or r % row_chunk:
        raise ValueError("row_chunk (%d) must divide R=%d"
                         % (row_chunk, r))
    if row_chunk < r and row_chunk % ROW_CHUNK_FLOOR:
        raise ValueError(
            "row_chunk (%d) must be a multiple of 4 when chunking (the "
            "block-PRG ids interleave 4 rows per core block)" % row_chunk)
    return row_chunk


# ------------------------------------------------------- evaluation

def sqrt_chunk_candidates(r: int, k: int, batch: int, span: int = 2) -> list:
    """``row_chunk`` candidates of the plain scan for the autotuner
    (``dpf_tpu``'s rule): powers-of-two multiples of 4 within ``span``
    octaves of ``choose_row_chunk``, each dividing R and within the
    live-slab bound (dropped, not clipped); the heuristic is always a
    member.  Sorted ascending.  K4's own grid steps are
    ``ops/sqrt_grid.row_chunk_candidates``."""
    base = choose_row_chunk(r, k, batch)
    out = {base}
    for s in range(-span, span + 1):
        c = base << s if s >= 0 else base >> (-s)
        if (ROW_CHUNK_FLOOR <= c <= r and r % c == 0
                and row_chunk_within_bound(c, k, batch)):
            out.add(c)
    return sorted(out)


def eval_contract_batched(seeds, cw1, cw2, table, *, prf_method: int,
                          row_chunk: int | None = None,
                          grid_rows: int | None = None) -> torch.Tensor:
    """Fused batched sqrt-N evaluation: seeds ``[B, K, 4]``, codewords
    ``[B, R, 4]`` (int32 limbs) and the natural-order ``[R*K, E]`` int32
    table on one device -> ``[B, E]`` int32 shares,
    ``sum_x leaf32[b, x] * table[x]`` mod 2^32.

    Routed as ``dpf_tpu``'s ``kernel_impl="pallas"`` resolution, with
    every PRF id on the grid kernel: K4 on CUDA tensors, the plain scan
    on CPU ones (``ops/sqrt_grid.sqrt_grid_contract``).  ``row_chunk``
    follows the TPU kernel's rules (``sqrt_grid.sqrt_row_chunk``);
    ``grid_rows`` names K4's grid step exactly (the tuner's knob).
    Neither changes a bit of the result."""
    from ..ops.sqrt_grid import sqrt_grid_contract
    return sqrt_grid_contract(seeds, cw1, cw2, table, prf_method=prf_method,
                              row_chunk=row_chunk, grid_rows=grid_rows)


def eval_contract_per_key_tables(seeds, cw1, cw2, tables, *,
                                 prf_method: int,
                                 row_chunk: int | None = None
                                 ) -> torch.Tensor:
    """Fused batched sqrt-N evaluation where every key has its own table
    (port of ``sqrtn.eval_contract_per_key_tables``, the sqrt-N
    construction's batch-PIR surface).

    tables: ``[B, N, E]`` int32 in natural order (no permutation) and
    contiguous.  Returns ``[B, E]`` int32: ``out[b] = sum_x leaf32[b, x]
    * tables[b, x]`` mod 2^32.  K4's per-key mode on CUDA tensors, the
    plain scan on CPU ones; ``row_chunk`` (the rows of a per-key item)
    must divide R and be a multiple of 4 below R, else ValueError; None
    = ``sqrt_grid.pkt_row_chunk``.  It changes no bit of the result."""
    from ..ops.sqrt_grid import sqrt_grid_contract
    if tables.dim() != 3 or tables.shape[0] != seeds.shape[0]:
        raise ValueError("per-key tables %s for %d keys"
                         % (tuple(tables.shape), seeds.shape[0]))
    return sqrt_grid_contract(seeds, cw1, cw2, tables, prf_method=prf_method,
                              row_chunk=row_chunk)


def sharded_sqrt_program(keys: dict, table, *, prf_method: int, mesh,
                         row_chunk: int | None = None,
                         psum_group: int | None = None) -> torch.Tensor:
    """The sqrt-N mesh program over keys already on each device
    (``keys[device] = (seeds, cw1, cw2)``, ``[B, K, 4]`` and ``[B, R,
    4]``) and a ``parallel.sharded.shard_table_sqrt`` table.  Each shard
    runs K4 (the plain scan on CPU tensors) over its own R / shards grid
    rows with ``row0`` its first row, in groups of ``psum_group`` steps
    of ``row_chunk`` rows when that divides them; the partials sum mod
    2^32.  A split the grid kernel cannot take raises ``ValueError``:
    the card has no other path."""
    from ..ops.sqrt_grid import sqrt_grid_contract
    from ..parallel.sharded import _valid_psum_group, mesh_sum
    seeds = next(iter(keys.values()))[0]
    bsz, k = seeds.shape[0], seeds.shape[1]
    r = next(iter(keys.values()))[1].shape[1]
    n_shards, nb = mesh.shape["table"], mesh.shape["batch"]
    if r % n_shards:
        raise ValueError("sqrt-N grid rows R=%d must divide over %d table "
                         "shards" % (r, n_shards))
    if bsz % nb:
        raise ValueError("batch %d does not split over %d batch shards"
                         % (bsz, nb))
    r_local = r // n_shards
    if n_shards > 1 and prf_method in _BLK_WORDS \
            and r_local % ROW_CHUNK_FLOOR:
        raise ValueError(
            "block-PRG sqrt-N sharding needs R/shards (%d) to be a "
            "multiple of 4 (one core block serves 4 grid rows and K4 "
            "cannot split it over shards); use fewer table shards or a "
            "wider n_keys split" % r_local)
    rc = _resolve_row_chunk(r_local, k, bsz, row_chunk)
    steps = r_local // rc
    g = _valid_psum_group(psum_group, steps)
    n_groups = steps // g if g else 1
    span, bb = r_local // n_groups, bsz // nb

    def partial(idx, grp):
        ib, it = mesh.coord(idx, "batch"), mesh.coord(idx, "table")
        s, c1, c2 = keys[mesh.devices[idx]]
        sl = slice(ib * bb, (ib + 1) * bb)
        r0 = it * r_local + grp * span
        rows = slice(grp * span * k, (grp + 1) * span * k)
        return sqrt_grid_contract(
            s[sl], c1[sl, r0:r0 + span], c2[sl, r0:r0 + span],
            table.blocks[idx][rows], prf_method=prf_method,
            row_chunk=rc, row0=r0)

    return mesh_sum(mesh, bsz, table.shape[1], partial, n_groups)


def eval_sharded_sqrt(seeds, cw1, cw2, table, *, prf_method: int, mesh,
                      row_chunk: int | None = None,
                      psum_group: int | None = None) -> torch.Tensor:
    """Mesh-parallel fused sqrt-N evaluation (port of
    ``sqrtn.eval_sharded_sqrt``): int32 ``seeds`` ``[B, K, 4]`` and
    codewords ``[B, R, 4]`` on any device, the natural-order table from
    ``parallel.sharded.shard_table_sqrt``.  ``row_chunk`` grid rows per
    step of each shard (None = ``choose_row_chunk`` over R / shards)
    must divide R / shards (a multiple of 4 when it chunks);
    ``psum_group`` steps are summed over the mesh at a time.  Where the
    JAX package falls back to its XLA scan (a block-PRG split of R /
    shards % 4 != 0), this raises ``ValueError``.  Returns ``[B, E]``
    int32 on the mesh's output device."""
    from ..parallel.sharded import keys_on_devices
    return sharded_sqrt_program(
        keys_on_devices(mesh, seeds, cw1, cw2), table,
        prf_method=prf_method, mesh=mesh, row_chunk=row_chunk,
        psum_group=psum_group)


def eval_points_sqrt(keys: list, indices, prf_method: int,
                     device=None) -> torch.Tensor:
    """Sparse evaluation at the given indices: [B, Q] int32 shares.

    Index x = r*K + j costs one PRF call (seed j at row r); the whole
    [B, Q] block is one vectorized PRF call over the gathered (seed,
    row) pairs."""
    idx = np.asarray(indices, dtype=np.int64).reshape(-1)
    seeds, cw1, cw2 = (from_u32(a).to(device) for a in pack_sqrt_keys(keys))
    k = keys[0].n_keys
    rows = torch.from_numpy(idx // k).to(seeds.device)
    cols = torch.from_numpy(idx % k).to(seeds.device)
    sel_seeds = seeds[:, cols]                         # [B, Q, 4]
    vals = prf_v(prf_method, sel_seeds, rows.to(torch.int32))
    lsb = (sel_seeds[..., 0] & 1).bool()[..., None]
    cw = torch.where(lsb, cw2[:, rows], cw1[:, rows])  # [B, Q, 4]
    return u128.add128(vals, cw)[..., 0]
