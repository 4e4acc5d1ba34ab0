"""128-bit unsigned arithmetic as 4 x 32-bit little-endian limbs.

Port of ``dpf_tpu/core/u128.py``.  Host conversions stay numpy (uint32
limb arrays, as the key codec uses them); tensor arithmetic works on
``[..., 4]`` int32 tensors read as uint32 (``core/u32.py``), limb 0
least significant, on any device.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .u32 import shr, ult

U32_MASK = 0xFFFFFFFF
NLIMBS = 4


# ---------------------------------------------------------------------------
# Host-side conversions (Python int <-> numpy uint32 limb arrays)
# ---------------------------------------------------------------------------

def int_to_limbs(x: int) -> np.ndarray:
    """Python int (mod 2^128) -> [4] uint32 little-endian limb array."""
    x &= (1 << 128) - 1
    return np.array([(x >> (32 * i)) & U32_MASK for i in range(NLIMBS)],
                    dtype=np.uint32)


def limbs_to_int(limbs) -> int:
    """[4] uint32 (or int32) limbs -> Python int."""
    arr = np.asarray(limbs).astype(np.int64).reshape(-1) & U32_MASK
    if arr.shape != (NLIMBS,):
        raise ValueError("expected 4 limbs, got %d" % arr.shape[0])
    return sum(int(arr[i]) << (32 * i) for i in range(NLIMBS))


def ints_to_limbs(xs) -> np.ndarray:
    """Iterable of Python ints -> [len, 4] uint32 limb array."""
    return np.stack([int_to_limbs(int(x)) for x in xs])


def limbs_to_ints(limbs) -> list:
    """[..., 4] limb array -> flat list of Python ints."""
    arr = np.asarray(limbs).astype(np.int64).reshape(-1, NLIMBS) & U32_MASK
    return [sum(int(r[i]) << (32 * i) for i in range(NLIMBS)) for r in arr]


# ---------------------------------------------------------------------------
# Tensor limb arithmetic.  All take/return [..., 4] int32 tensors.
# ---------------------------------------------------------------------------

def add128(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a + b) mod 2^128, elementwise over leading axes.

    The carry out of ``a_i + b_i + c_in`` is two unsigned compares: the
    first add wraps iff ``s < a_i``; adding the carry-in can wrap only
    when the first add did not, so the two conditions OR together.
    """
    out = []
    carry = None
    for i in range(NLIMBS):
        ai = a[..., i]
        s = ai + b[..., i]
        c1 = ult(s, ai).to(torch.int32)
        if carry is not None:
            s2 = s + carry
            carry = c1 | ult(s2, s).to(torch.int32)
            s = s2
        else:
            carry = c1
        out.append(s)
    return torch.stack(out, dim=-1)


def sub128(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a - b) mod 2^128.  The borrow out of ``a_i - b_i - c_in`` is two
    unsigned compares, as ``add128``'s carry: the first subtraction
    borrows iff ``a_i < b_i``; taking the borrow-in off can borrow only
    when ``d < c_in``, that is when ``d`` is 0 and the first did not."""
    out = []
    borrow = None
    for i in range(NLIMBS):
        ai, bi = a[..., i], b[..., i]
        d = ai - bi
        b1 = ult(ai, bi).to(torch.int32)
        if borrow is not None:
            d2 = d - borrow
            borrow = b1 | ult(d, borrow).to(torch.int32)
            d = d2
        else:
            borrow = b1
        out.append(d)
    return torch.stack(out, dim=-1)


def neg128(a: torch.Tensor) -> torch.Tensor:
    """(-a) mod 2^128."""
    return sub128(torch.zeros_like(a), a)


def _mul32_parts(a: torch.Tensor, b: torch.Tensor):
    """Full 32x32 -> (hi32, lo32) product from 16-bit halves."""
    al = a & 0xFFFF
    ah = shr(a, 16)
    bl = b & 0xFFFF
    bh = shr(b, 16)
    lo_lo = al * bl
    mid1 = ah * bl
    mid2 = al * bh
    cross = shr(lo_lo, 16) + (mid1 & 0xFFFF) + (mid2 & 0xFFFF)
    hi = ah * bh + shr(mid1, 16) + shr(mid2, 16) + shr(cross, 16)
    return hi, a * b


def mul128_small(a: torch.Tensor, c) -> torch.Tensor:
    """(a * c) mod 2^128 for a uint32-ranged ``c``: a Python int, or an
    int32 tensor read as uint32 that broadcasts against ``a[..., 0]``
    (per-row positions of the sqrt-N grid)."""
    zero = torch.zeros_like(a[..., 0])
    if isinstance(c, torch.Tensor):
        b = zero + c
        zero = torch.zeros_like(b)
    else:
        b = zero + (c if c < (1 << 31) else c - (1 << 32))
    r = []
    carry = zero
    for i in range(NLIMBS):
        hi, lo = _mul32_parts(a[..., i] + zero, b)
        s = lo + carry
        r.append(s)
        carry = hi + ult(s, lo).to(torch.int32)
    return torch.stack(r, dim=-1)


def mul128(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a * b) mod 2^128: schoolbook over 32-bit limbs, the low 128 bits
    kept."""
    zero = torch.zeros_like(a[..., 0] + b[..., 0])
    r = [zero] * NLIMBS
    for i in range(NLIMBS):
        carry = zero
        for j in range(NLIMBS - i):
            k = i + j
            hi, lo = _mul32_parts(a[..., i] + zero, b[..., j] + zero)
            s = r[k] + lo
            c1 = ult(s, r[k]).to(torch.int32)
            s2 = s + carry
            c2 = ult(s2, s).to(torch.int32)
            r[k] = s2
            # hi + c1 + c2 cannot wrap: when hi is at its largest
            # (2^32 - 2, at a = b = 2^32 - 1) lo is 1, so c1 and c2
            # exclude each other
            carry = hi + c1 + c2
    return torch.stack(r, dim=-1)


def lsb(a: torch.Tensor) -> torch.Tensor:
    """Least significant bit of each 128-bit value, shape ``[...]``."""
    return a[..., 0] & 1


def low32(a: torch.Tensor) -> torch.Tensor:
    """The value mod 2^32 (limb 0), read as uint32."""
    return a[..., 0]


# ---------------------------------------------------------------------------
# Bit reversal (host side; used once per eval_init to pre-permute the table)
# ---------------------------------------------------------------------------

def next_pow2(n: int) -> int:
    """Smallest power of two >= n (n >= 1)."""
    p = 1
    while p < n:
        p *= 2
    return p


@functools.lru_cache(maxsize=64)
def bit_reverse_indices(n: int) -> np.ndarray:
    """Permutation p with p[i] = bit_reverse(i) over log2(n) bits.

    Breadth-first GGM expansion emits leaf j at position bit_reverse(j),
    so permuting the table once at init lets the fused contraction read
    rows in the order the leaves come out.
    """
    if n <= 0 or n & (n - 1):
        raise ValueError("n (%d) must be a power of two" % n)
    bits = n.bit_length() - 1
    idx = np.arange(n, dtype=np.uint64)
    rev = np.zeros_like(idx)
    for b in range(bits):
        rev |= ((idx >> np.uint64(b)) & np.uint64(1)) << np.uint64(
            bits - 1 - b)
    out = rev.astype(np.int64)
    out.setflags(write=False)  # cached: guard against accidental mutation
    return out
