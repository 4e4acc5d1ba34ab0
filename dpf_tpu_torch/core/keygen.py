"""Client-side DPF key generation (log-N GGM construction) + key codec.

Port of ``dpf_tpu/core/keygen.py``: the same numpy host code, copied so
the port imports nothing of the JAX package.  Keys are byte-identical
to ``dpf_tpu``'s for the same ``(alpha, n, seed, prf)``.

The construction is the reference's seed-LSB-as-control-bit GGM: each
tree level owns a pair of 128-bit codewords per server view
(``cw_1[2i+b]``, ``cw_2[2i+b]`` with flat level index ``i`` and branch
``b``); an evaluator picks ``cw_1`` or ``cw_2`` by the LSB of its
current seed.  Index bits are consumed LSB-first.

Wire format (reference ``dpf_wrapper.cu:26-46``): 524 int32 = 131
uint128 little-endian slots: ``[0]=depth, [1..64]=cw_1, [65..128]=cw_2,
[129]=last_key, [130]=n``.  Every secret is drawn from a SHAKE-256 XOF
over the caller's seed.

``gen_batched`` derives B keys at once: one DRBG squeeze per key, then
``O(log N)`` PRF calls over ``[B, 4]`` int32 limb tensors
(``core/prf.py``, ``core/u32.py``), on the host.  Its rows are
byte-identical to ``generate_keys`` for each key's seed.
"""

from __future__ import annotations

import hashlib
import os
from dataclasses import dataclass

import numpy as np
import torch

from . import u128
from .prf import prf_v
from .prf_ref import MASK128, PRF_FUNCS
from .u32 import from_u32, i32

KEY_WORDS = 524          # int32 words per serialized key
MAX_DEPTH = 32           # => tables up to 2^32 entries


class Shake256Drbg:
    """Deterministic byte stream: SHAKE-256(seed || counter) blocks."""

    def __init__(self, seed: bytes):
        self._seed = bytes(seed)
        self._ctr = 0
        self._buf = b""

    def _refill(self):
        h = hashlib.shake_256(self._seed + self._ctr.to_bytes(8, "little"))
        self._ctr += 1
        self._buf += h.digest(1024)

    def bytes(self, n: int) -> bytes:
        while len(self._buf) < n:
            self._refill()
        out, self._buf = self._buf[:n], self._buf[n:]
        return out

    def u128(self) -> int:
        return int.from_bytes(self.bytes(16), "little")

    def u128_odd(self) -> int:
        return self.u128() | 1


@dataclass
class FlatKey:
    """One server's flattened DPF key (host representation)."""
    depth: int
    cw1: np.ndarray      # [64, 4] uint32 limbs (slots beyond 2*depth zero)
    cw2: np.ndarray      # [64, 4] uint32
    last_key: int        # 128-bit start seed for this server
    n: int               # table size the key was generated for

    def serialize(self) -> np.ndarray:
        """-> [524] int32, reference wire format."""
        slots = np.zeros((131, 4), dtype=np.uint32)
        slots[0] = u128.int_to_limbs(self.depth)
        slots[1:65] = self.cw1
        slots[65:129] = self.cw2
        slots[129] = u128.int_to_limbs(self.last_key)
        slots[130] = u128.int_to_limbs(self.n)
        return slots.reshape(-1).view(np.int32).copy()


def _wire_words(k) -> np.ndarray:
    """One wire key to a flat int32 array (torch tensors, device ones
    included, are copied to the host first)."""
    if hasattr(k, "detach"):
        k = k.detach().cpu().numpy()
    return np.asarray(k, dtype=np.int32).reshape(-1)


def stack_wire_keys(keys, words: int | None = KEY_WORDS) -> np.ndarray:
    """Key batch (list of flat int32 array-likes, torch tensors included,
    or one [B, W] array) -> one contiguous [B, W] int32 buffer.

    ``words`` is the required wire width; None accepts any width the
    batch agrees on (the sqrt-N codec's O(sqrt N)-sized keys; there a
    ragged batch raises the stacking ``ValueError``)."""
    if len(keys) == 0:
        raise ValueError("empty key batch")
    if isinstance(keys, np.ndarray) and keys.ndim == 2:
        arr = np.ascontiguousarray(keys, dtype=np.int32)
    else:
        try:  # uniform numpy inputs stack in one C call
            arr = np.asarray(keys, dtype=np.int32)
        except (ValueError, TypeError, RuntimeError):
            arr = np.stack([_wire_words(k) for k in keys])
        if arr.ndim != 2:
            arr = arr.reshape(len(keys), -1)
    if words is not None and arr.shape[1] != words:
        raise ValueError("DPF key must be %d int32 words, got %d"
                         % (words, arr.shape[1]))
    return np.ascontiguousarray(arr)


@dataclass
class PackedKeys:
    """A whole key batch decoded straight into device-layout arrays."""
    cw1: np.ndarray      # [B, 64, 4] uint32
    cw2: np.ndarray      # [B, 64, 4] uint32
    last: np.ndarray     # [B, 4] uint32 start seeds
    depth: int
    n: int               # shared table size (uniform across the batch)

    @property
    def batch(self) -> int:
        return self.last.shape[0]

    def slice(self, lo: int, hi: int) -> "PackedKeys":
        return PackedKeys(self.cw1[lo:hi], self.cw2[lo:hi],
                          self.last[lo:hi], self.depth, self.n)


def wire_headers(arr: np.ndarray):
    """Per-key ``(radix marker, table size n)`` from a stacked [B, 524]
    wire buffer: the container's header limbs (marker at slot 0 limb 1:
    0 = binary, 4 = mixed-radix; n at slot 130, limbs 0/1), read before
    a full decode so that a batch caller can name the key at fault."""
    slots = arr.view(np.uint32).reshape(-1, 131, 4)
    n = (slots[:, 130, 0].astype(np.int64)
         | (slots[:, 130, 1].astype(np.int64) << 32))
    return slots[:, 0, 1], n



def decode_keys_batched(keys) -> PackedKeys:
    """Vectorized wire -> packed-arrays codec for a uniform key batch:
    the wire words are stacked once and every cw1/cw2/last limb is
    decoded with views and reshapes."""
    slots = stack_wire_keys(keys).view(np.uint32).reshape(-1, 131, 4)
    if (slots[:, 0, 1] == 4).any():
        raise ValueError("mixed-radix key: serve radix-4 keys with "
                         "DPF(config=EvalConfig(radix=4))")
    depth = slots[:, 0, 0]
    # n <= 2^32 spills into limb 1; limbs 2/3 are zero on every writer
    n = (slots[:, 130, 0].astype(np.uint64)
         | (slots[:, 130, 1].astype(np.uint64) << np.uint64(32)))
    if (n != n[0]).any() or (depth != depth[0]).any():
        raise ValueError("keys for mixed table sizes")
    return PackedKeys(
        cw1=np.ascontiguousarray(slots[:, 1:65]),
        cw2=np.ascontiguousarray(slots[:, 65:129]),
        last=np.ascontiguousarray(slots[:, 129]),
        depth=int(depth[0]), n=int(n[0]))


def deserialize_key(key) -> FlatKey:
    """[524] int32 (array-like; torch tensors accepted) -> FlatKey."""
    arr = _wire_words(key)
    if arr.shape[0] != KEY_WORDS:
        raise ValueError("DPF key must be %d int32 words, got %d"
                         % (KEY_WORDS, arr.shape[0]))
    slots = arr.view(np.uint32).reshape(131, 4)
    if slots[0, 1] == 4:  # radix marker (binary keys keep this limb zero)
        raise ValueError("mixed-radix key: serve radix-4 keys with "
                         "DPF(config=EvalConfig(radix=4))")
    return FlatKey(
        depth=int(slots[0, 0]),
        cw1=slots[1:65].copy(),
        cw2=slots[65:129].copy(),
        last_key=u128.limbs_to_int(slots[129]),
        n=u128.limbs_to_int(slots[130]),  # n=2^32 spills into limb 1
    )


def generate_keys(alpha: int, n: int, seed: bytes, prf_method: int,
                  beta: int = 1):
    """Generate the two servers' keys for point function f(alpha) = beta.

    Returns (FlatKey for server 0, FlatKey for server 1).
    Cost is O(log N) PRF calls, on the host.
    """
    if n & (n - 1) != 0 or n < 2:
        raise ValueError("table size (%d) must be a power of two >= 2" % n)
    if not 0 <= alpha < n:
        raise ValueError("alpha (%d) must be in [0, %d)" % (alpha, n))
    depth = n.bit_length() - 1
    if depth > MAX_DEPTH:
        raise ValueError("table size 2^%d exceeds max 2^32" % depth)

    prf = PRF_FUNCS[prf_method]
    rng = Shake256Drbg(seed)

    cw1 = np.zeros((64, 4), dtype=np.uint32)
    cw2 = np.zeros((64, 4), dtype=np.uint32)

    def put(arr, i, b, val):
        arr[2 * i + b] = u128.int_to_limbs(val)

    bits = [(alpha >> l) & 1 for l in range(depth)]

    # --- base level (flat index depth-1) handles bit 0 of alpha ----------
    k1 = rng.u128() & ~1          # server 0 start seed: LSB 0
    k2 = rng.u128() | 1           # server 1 start seed: LSB 1
    beta_l = beta if depth == 1 else rng.u128_odd()
    i = depth - 1
    c1 = [rng.u128() for _ in range(2)]
    for b in range(2):
        d = (prf(k1, b) - prf(k2, b)) & MASK128
        if b == bits[0]:
            d = (d - beta_l) & MASK128
        put(cw1, i, b, c1[b])
        put(cw2, i, b, (c1[b] + d) & MASK128)
    # evaluated seeds at the target path after the base level
    s1 = (prf(k1, bits[0]) + c1[bits[0]]) & MASK128                 # k1 LSB=0
    s2 = (prf(k2, bits[0]) + u128.limbs_to_int(cw2[2 * i + bits[0]])) & MASK128

    # --- upper levels, bottom to top --------------------------------------
    for l in range(1, depth):
        if not ((s1 - s2) & MASK128 == beta_l and (s1 ^ s2) & 1):
            raise AssertionError(
                "keygen invariant broken at level %d: seed shares must "
                "differ by the odd beta'" % l)
        i = depth - 1 - l
        beta_l = beta if l == depth - 1 else rng.u128_odd()
        tb = bits[l]
        s1_even = (s1 & 1) == 0
        c1 = [rng.u128() for _ in range(2)]
        for b in range(2):
            d = (prf(s2, b) - prf(s1, b)) & MASK128
            if s1_even:
                d = (-d) & MASK128
            put(cw2, i, b, (c1[b] + d) & MASK128)
        # fold beta into cw1 at the target branch (after cw2 is fixed)
        c1[tb] = (c1[tb] + (beta_l if s1_even else -beta_l)) & MASK128
        for b in range(2):
            put(cw1, i, b, c1[b])
        # step both servers' target-path seeds through this level
        n1 = (prf(s1, tb) + (c1[tb] if s1_even
                             else u128.limbs_to_int(cw2[2 * i + tb]))) & MASK128
        n2 = (prf(s2, tb) + (u128.limbs_to_int(cw2[2 * i + tb]) if s1_even
                             else c1[tb])) & MASK128
        s1, s2 = n1, n2

    ka = FlatKey(depth=depth, cw1=cw1, cw2=cw2, last_key=k1, n=n)
    kb = FlatKey(depth=depth, cw1=cw1.copy(), cw2=cw2.copy(), last_key=k2, n=n)
    return ka, kb


# ---------------------------------------------------------------------------
# Batched key generation (vectorized over B independent indices)
# ---------------------------------------------------------------------------

def drbg_u128_batch(seeds, n_draws: int, *,
                    squeeze_draws: int | None = None) -> torch.Tensor:
    """Every key's first ``n_draws`` DRBG u128 draws: ``[B, n_draws, 4]``
    int32 limbs.

    ``Shake256Drbg`` is a byte stream, so ``16 * n_draws`` bytes read at
    once are the same draws as ``n_draws`` calls of ``u128()``; the
    batched generators' one loop over keys is this squeeze.  The draw
    sites' ``& ~1`` / ``| 1`` are the callers' (on the limb tensors).
    ``squeeze_draws`` caps the draws read per ``bytes()`` call: the same
    stream in chunks."""
    sq = n_draws if not squeeze_draws else max(1, int(squeeze_draws))
    out = np.empty((len(seeds), n_draws, 4), dtype=np.uint32)
    for i, s in enumerate(seeds):
        rng = Shake256Drbg(s)
        for lo in range(0, n_draws, sq):
            m = min(sq, n_draws - lo)
            out[i, lo:lo + m] = np.frombuffer(
                rng.bytes(16 * m), dtype=np.uint32).reshape(m, 4)
    return torch.from_numpy(out.view(np.int32))


def _keygen_knob_fns(prf_method: int, knobs):
    """The batched generators' PRF call shapes for the keygen knobs, each
    the same function as the default (``knobs=None``), since a PRF acts
    on each row alone:

    * ``prf_group="stacked"``: one ``prf_v`` call a branch over the
      stacked s1 | s2 seeds instead of two calls of half the rows;
    * ``path_reuse="reuse"``: the target path's PRF values picked from
      the saved per-branch outputs instead of computed again with a
      per-row position;
    * ``squeeze_draws``: the DRBG's read size (``drbg_u128_batch``).

    Returns ``(prf_pair_v, path_pick, squeeze_draws)``."""
    kn = dict(knobs or {})
    stacked = kn.get("prf_group") == "stacked"
    reuse = kn.get("path_reuse") == "reuse"

    def prf_pair_v(sa, sb, b):
        if stacked:
            both = prf_v(prf_method, torch.cat([sa, sb]), b)
            return both[:sa.shape[0]], both[sa.shape[0]:]
        return prf_v(prf_method, sa, b), prf_v(prf_method, sb, b)

    def path_pick(saved, seeds, tb, rows):
        if reuse:
            return torch.stack(saved, dim=1)[rows, tb]
        return prf_v(prf_method, seeds, tb.to(torch.int32))

    return prf_pair_v, path_pick, kn.get("squeeze_draws")


def _check_batch_args(alphas, n: int, seeds):
    """Validate a batch's indices, domain and per-key seeds (fresh
    ``os.urandom`` seeds when None); -> (int64 alphas, seeds)."""
    alphas = np.asarray(alphas, dtype=np.int64).reshape(-1)
    if alphas.size == 0:
        raise ValueError("empty index batch")
    if n & (n - 1) != 0 or n < 2:
        raise ValueError("table size (%d) must be a power of two >= 2" % n)
    if (alphas < 0).any() or (alphas >= n).any():
        bad = int(alphas[(alphas < 0) | (alphas >= n)][0])
        raise ValueError("alpha (%d) must be in [0, %d)" % (bad, n))
    if seeds is None:
        seeds = [os.urandom(128) for _ in range(alphas.size)]
    if isinstance(seeds, (bytes, bytearray)):
        # one seed would be read as per-BYTE seeds (ints, which bytes()
        # turns into all-zero DRBG seeds)
        raise TypeError(
            "seeds must be a LIST of per-key byte strings, got a single "
            "%s — every key needs its own DRBG seed"
            % type(seeds).__name__)
    if len(seeds) != alphas.size:
        raise ValueError("need one seed per index (%d != %d)"
                         % (len(seeds), alphas.size))
    for s in seeds:
        if not isinstance(s, (bytes, bytearray, memoryview)):
            raise TypeError("per-key seeds must be bytes, got %s"
                            % type(s).__name__)
    return alphas, seeds


def _wire_batch(cw1, cw2, last, depth: int, n: int,
                radix_slot0=None) -> torch.Tensor:
    """Serialize a key batch: ``[B, 64, 4]`` codewords and ``[B, 4]``
    start seeds -> ``[B, 524]`` int32 (``FlatKey.serialize`` for every
    row; ``radix_slot0`` = (marker, binary levels) of a radix-4 key)."""
    bsz = last.shape[0]
    slots = torch.zeros((bsz, 131, 4), dtype=torch.int32)
    slots[:, 0, 0] = depth
    if radix_slot0 is not None:
        slots[:, 0, 1], slots[:, 0, 2] = radix_slot0
    slots[:, 1:65] = cw1
    slots[:, 65:129] = cw2
    slots[:, 129] = last
    slots[:, 130, 0] = i32(n)
    slots[:, 130, 1] = n >> 32
    return slots.reshape(bsz, -1)


def _odd(v: torch.Tensor) -> torch.Tensor:
    v = v.clone()
    v[:, 0] |= 1
    return v


def _even(v: torch.Tensor) -> torch.Tensor:
    v = v.clone()
    v[:, 0] &= -2
    return v


def beta_limbs(beta: int, bsz: int) -> torch.Tensor:
    """``beta`` as ``[bsz, 4]`` int32 limbs."""
    return from_u32(u128.int_to_limbs(beta)).expand(bsz, 4)


def gen_batched(alphas, n: int, seeds=None, *, prf_method: int,
                beta: int = 1, knobs=None):
    """Two servers' keys for B point functions over one domain ``n``.

    The batched ``generate_keys``: one DRBG squeeze per key
    (``drbg_u128_batch``), then ``O(log N)`` PRF calls over ``[B, 4]``
    limb tensors instead of ``O(B log N)`` calls on Python ints.  Row i
    is byte-identical to ``generate_keys(alphas[i], n, seeds[i])``.
    ``knobs``: see ``_keygen_knob_fns`` (None = the default shapes).

    Returns ``(wire_a, wire_b)``, two ``[B, 524]`` int32 CPU tensors."""
    alphas, seeds = _check_batch_args(alphas, n, seeds)
    depth = n.bit_length() - 1
    if depth > MAX_DEPTH:
        raise ValueError("table size 2^%d exceeds max 2^32" % depth)
    bsz = alphas.size
    prf_pair_v, path_pick, squeeze_draws = _keygen_knob_fns(
        prf_method, knobs)
    n_draws = 4 if depth == 1 else 3 * depth + 1
    draws = iter(drbg_u128_batch(seeds, n_draws,
                                 squeeze_draws=squeeze_draws).unbind(1))
    beta_c = beta_limbs(beta, bsz)
    bits = torch.from_numpy(
        (alphas[:, None] >> np.arange(depth, dtype=np.int64)[None, :]) & 1)
    cw1 = torch.zeros((bsz, 64, 4), dtype=torch.int32)
    cw2 = torch.zeros((bsz, 64, 4), dtype=torch.int32)
    rows = torch.arange(bsz)

    # --- base level (flat index depth-1) handles bit 0 of alpha ----------
    k1 = _even(next(draws))                           # server 0: LSB 0
    k2 = _odd(next(draws))                            # server 1: LSB 1
    beta_l = beta_c if depth == 1 else _odd(next(draws))
    i = depth - 1
    b0 = bits[:, 0]
    c1 = [next(draws), next(draws)]
    p1, p2 = [], []
    for b in (0, 1):
        v1, v2 = prf_pair_v(k1, k2, b)
        p1.append(v1)
        p2.append(v2)
        d = u128.sub128(v1, v2)
        d = torch.where((b0 == b)[:, None], u128.sub128(d, beta_l), d)
        cw1[:, 2 * i + b] = c1[b]
        cw2[:, 2 * i + b] = u128.add128(c1[b], d)
    c1_t = torch.where((b0 == 1)[:, None], c1[1], c1[0])
    s1 = u128.add128(path_pick(p1, k1, b0, rows), c1_t)
    s2 = u128.add128(path_pick(p2, k2, b0, rows), cw2[rows, 2 * i + b0])

    # --- upper levels, bottom to top --------------------------------------
    for l in range(1, depth):
        if not (torch.equal(u128.sub128(s1, s2), beta_l.expand_as(s1))
                and bool((((s1[:, 0] ^ s2[:, 0]) & 1) == 1).all())):
            raise AssertionError(
                "batched keygen invariant broken at level %d: seed shares "
                "must differ by the odd beta' (and so in LSB)" % l)
        i = depth - 1 - l
        beta_l = beta_c if l == depth - 1 else _odd(next(draws))
        tb = bits[:, l]
        s1_even = ((s1[:, 0] & 1) == 0)[:, None]
        c1 = [next(draws), next(draws)]
        p1, p2 = [], []
        for b in (0, 1):
            v1, v2 = prf_pair_v(s1, s2, b)
            p1.append(v1)
            p2.append(v2)
            d = u128.sub128(v2, v1)
            d = torch.where(s1_even, u128.neg128(d), d)
            cw2[:, 2 * i + b] = u128.add128(c1[b], d)
        # fold beta into cw1 at the target branch (after cw2 is fixed)
        adj = torch.where(s1_even, beta_l, u128.neg128(beta_l))
        c1 = [torch.where((tb == b)[:, None], u128.add128(c1[b], adj), c1[b])
              for b in (0, 1)]
        for b in (0, 1):
            cw1[:, 2 * i + b] = c1[b]
        # step both servers' target-path seeds through this level
        c1_t = torch.where((tb == 1)[:, None], c1[1], c1[0])
        cw2_t = cw2[rows, 2 * i + tb]
        n1 = u128.add128(path_pick(p1, s1, tb, rows),
                         torch.where(s1_even, c1_t, cw2_t))
        n2 = u128.add128(path_pick(p2, s2, tb, rows),
                         torch.where(s1_even, cw2_t, c1_t))
        s1, s2 = n1, n2

    return (_wire_batch(cw1, cw2, k1, depth, n),
            _wire_batch(cw1, cw2, k2, depth, n))


def evaluate_flat(key: FlatKey, indx: int, prf_method: int) -> int:
    """Scalar reference evaluation at one index (O(log N) PRF calls)."""
    prf = PRF_FUNCS[prf_method]
    cur = key.last_key
    rem = indx
    for i in range(key.depth - 1, -1, -1):
        b = rem & 1
        val = prf(cur, b)
        cw = key.cw1 if (cur & 1) == 0 else key.cw2
        cur = (val + u128.limbs_to_int(cw[2 * i + b])) & MASK128
        rem >>= 1
    return cur
