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

Batched keygen (``gen_batched``) comes with a later slice.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

import numpy as np

from . import u128
from .prf_ref import MASK128, PRF_FUNCS

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

    def pad_to(self, size: int) -> "PackedKeys":
        """Pad the batch axis to ``size`` by repeating the last key (pad
        rows are computed and discarded).  No-op when already at least
        ``size``."""
        reps = size - self.batch
        if reps <= 0:
            return self
        return PackedKeys(
            np.concatenate([self.cw1, np.repeat(self.cw1[-1:], reps, 0)]),
            np.concatenate([self.cw2, np.repeat(self.cw2[-1:], reps, 0)]),
            np.concatenate([self.last, np.repeat(self.last[-1:], reps, 0)]),
            self.depth, self.n)


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
