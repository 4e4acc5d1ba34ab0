"""Machine-derived composite-field circuit for the AES S-box.

Port of ``dpf_tpu/core/aes_sbox_circuit.py``, which uses only numpy: a
copy, so this package imports no JAX. The circuits are ``^`` and ``&``
over plane lists of any type that has them: numpy arrays for the
derivation, int32 tensors on any device in the bitsliced AES
(``core/aes_bitsliced.py``).

The bitsliced S-box cost dominates bitsliced AES (SubBytes is ~90% of the
gates).  This module derives — at import time, from the field definitions,
with no transcribed magic tables — a compact boolean circuit for
``inv(x)`` via the tower field GF((2^4)^2):

    GF(2^8) --iso--> GF(2^4)[z]/(z^2 + z + lam)
    (a + b z)^-1 = (c + d z),  c = (a+b) D^-1,  d = b D^-1,
    D = a^2 + a b + lam b^2
    result --iso^-1 + affine--> S-box output

All linear steps (isomorphism in/out folded with squarings, lam-scaling,
and the final affine) are 8x8 or 4x4 GF(2) matrices applied as XOR
combinations; the nonlinear steps are three GF(2^4) multiplications
(16 AND + ~15 XOR each) and one 4-bit inversion (ANF, ~20 ops).  Total
193 plane ops (symbolic count) vs ~760 for the x^254
square-and-multiply chain.

Everything is verified at import against the true S-box for all 256
inputs (cheap scalar check); tests additionally exercise the bitsliced
application.
"""

from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------------------
# Scalar field arithmetic used only for derivation (import time)
# ---------------------------------------------------------------------------

AES_POLY = 0x11B


def _gf8_mul(a, b):
    r = 0
    while b:
        if b & 1:
            r ^= a
        a <<= 1
        if a & 0x100:
            a ^= AES_POLY
        b >>= 1
    return r


def _gf4_mul(a, b):
    """GF(2^4) = GF(2)[y]/(y^4 + y + 1)."""
    r = 0
    while b:
        if b & 1:
            r ^= a
        a <<= 1
        if a & 0x10:
            a ^= 0x13
        b >>= 1
    return r


def _gf4_inv_table():
    inv = [0] * 16
    for a in range(1, 16):
        for b in range(1, 16):
            if _gf4_mul(a, b) == 1:
                inv[a] = b
                break
    return inv


_GF4_INV = _gf4_inv_table()


def _tower_mul(u, v, lam):
    """(a + b z)(c + d z) with z^2 = z + lam; elements packed b<<4 | a."""
    a, b = u & 0xF, u >> 4
    c, d = v & 0xF, v >> 4
    bd = _gf4_mul(b, d)
    lo = _gf4_mul(a, c) ^ _gf4_mul(lam, bd)
    hi = _gf4_mul(a, d) ^ _gf4_mul(b, c) ^ bd
    return (hi << 4) | lo


def _find_lambda():
    """lam making z^2 + z + lam irreducible over GF(2^4)."""
    for lam in range(1, 16):
        # irreducible iff no root: r^2 + r + lam != 0 for all r
        if all((_gf4_mul(r, r) ^ r ^ lam) != 0 for r in range(16)):
            return lam
    raise AssertionError("no irreducible lambda")


_LAM = _find_lambda()


def _derive_isomorphism():
    """8x8 GF(2) matrices T (GF(2^8)->tower) and T^-1.

    Find X in the tower field whose minimal polynomial is the AES polynomial
    (i.e. X^8 + X^4 + X^3 + X + 1 = 0 computed with tower arithmetic); then
    x^i -> X^i defines the isomorphism; its matrix has columns = tower
    coordinates of X^i.
    """
    def tower_pow(x, k):
        r = 1
        for _ in range(k):
            r = _tower_mul(r, x, _LAM)
        return r

    for cand in range(2, 256):
        acc = tower_pow(cand, 8) ^ tower_pow(cand, 4) ^ tower_pow(cand, 3) \
            ^ cand ^ 1
        if acc == 0:
            X = cand
            break
    else:  # pragma: no cover
        raise AssertionError("no root of the AES polynomial in the tower")

    cols = [tower_pow(X, i) for i in range(8)]  # tower coords of x^i
    T = np.zeros((8, 8), dtype=np.uint8)
    for i, c in enumerate(cols):
        for bit in range(8):
            T[bit, i] = (c >> bit) & 1
    Tinv = _gf2_mat_inv(T)
    return T, Tinv


def _gf2_mat_inv(m):
    n = m.shape[0]
    a = m.astype(np.uint8).copy()
    inv = np.eye(n, dtype=np.uint8)
    for col in range(n):
        piv = next(r for r in range(col, n) if a[r, col])
        if piv != col:
            a[[col, piv]] = a[[piv, col]]
            inv[[col, piv]] = inv[[piv, col]]
        for r in range(n):
            if r != col and a[r, col]:
                a[r] ^= a[col]
                inv[r] ^= inv[col]
    assert (a == np.eye(n, dtype=np.uint8)).all()
    return inv


_T, _TINV = _derive_isomorphism()

# affine layer of the S-box: out_i = inv_i ^ inv_{(i+4)%8} ^ inv_{(i+5)%8}
# ^ inv_{(i+6)%8} ^ inv_{(i+7)%8} ^ bit_i(0x63) -> row i has ones at
# columns (i+j)%8 for j in {0,4,5,6,7}
_AFFINE = np.zeros((8, 8), dtype=np.uint8)
for i in range(8):
    for j in (0, 4, 5, 6, 7):
        _AFFINE[i, (i + j) % 8] ^= 1
_OUT_MAT = (_AFFINE @ _TINV % 2).astype(np.uint8)  # fold iso^-1 into affine

# lam * b^2 and a^2 as 4x4 linear maps over GF(2)
_SQ4 = np.zeros((4, 4), dtype=np.uint8)
_LAMSQ4 = np.zeros((4, 4), dtype=np.uint8)
for i in range(4):
    sq = _gf4_mul(1 << i, 1 << i)
    lsq = _gf4_mul(_LAM, sq)
    for bit in range(4):
        _SQ4[bit, i] = (sq >> bit) & 1
        _LAMSQ4[bit, i] = (lsq >> bit) & 1

# 4-bit inversion as ANF (XOR of AND-monomials), derived from the table
def _anf_from_table(table, n_in=4):
    """Moebius transform: truth table -> ANF coefficient list per output bit.

    Returns per output bit the list of monomial masks (subsets of inputs)."""
    out_bits = []
    for bit in range(4):
        f = [(table[x] >> bit) & 1 for x in range(1 << n_in)]
        # fast Moebius transform
        for i in range(n_in):
            for x in range(1 << n_in):
                if x & (1 << i):
                    f[x] ^= f[x ^ (1 << i)]
        out_bits.append([m for m in range(1 << n_in) if f[m]])
    return out_bits


_INV4_ANF = _anf_from_table(_GF4_INV)


# ---------------------------------------------------------------------------
# Import-time self check (scalar)
# ---------------------------------------------------------------------------

def _scalar_sbox_via_tower(x):
    t = 0
    for bit in range(8):
        if np.bitwise_xor.reduce(_T[bit] & np.array(
                [(x >> i) & 1 for i in range(8)], dtype=np.uint8)):
            t |= 1 << bit
    a, b = t & 0xF, t >> 4
    d_ = _gf4_mul(a, a) ^ _gf4_mul(a, b) ^ _gf4_mul(_LAM, _gf4_mul(b, b))
    dinv = _GF4_INV[d_]
    c = _gf4_mul(a ^ b, dinv)
    d2 = _gf4_mul(b, dinv)
    inv_t = (d2 << 4) | c
    out = 0x63
    for bit in range(8):
        if np.bitwise_xor.reduce(_OUT_MAT[bit] & np.array(
                [(inv_t >> i) & 1 for i in range(8)], dtype=np.uint8)):
            out ^= 1 << bit
    return out


def _self_check():
    from .prf_ref import SBOX
    for x in range(256):
        assert _scalar_sbox_via_tower(x) == SBOX[x], x


_self_check()


# ---------------------------------------------------------------------------
# Bitsliced circuit application (plane lists; backend generic)
# ---------------------------------------------------------------------------

def _apply_gf2_matrix(mat, bits):
    """out_bit[i] = XOR over j with mat[i,j] of bits[j]."""
    out = []
    for i in range(mat.shape[0]):
        acc = None
        for j in range(mat.shape[1]):
            if mat[i, j]:
                acc = bits[j] if acc is None else acc ^ bits[j]
        out.append(acc)
    return out


def _mul4_bits(a, b):
    """GF(2^4) product circuit on 4-plane lists (16 AND + reduction)."""
    t = [None] * 7
    for i in range(4):
        for j in range(4):
            p = a[i] & b[j]
            k = i + j
            t[k] = p if t[k] is None else t[k] ^ p
    # reduce with y^4 = y + 1: y^d -> y^(d-4) + y^(d-3)
    for d in (6, 5, 4):
        v = t[d]
        t[d - 4] = t[d - 4] ^ v
        t[d - 3] = t[d - 3] ^ v
    return t[:4]


def _inv4_bits(a, ones):
    """GF(2^4) inversion via its ANF (monomials shared across output bits)."""
    # precompute needed monomials
    needed = set()
    for monos in _INV4_ANF:
        needed.update(monos)
    mono_val = {}
    for m in sorted(needed):
        if m == 0:
            mono_val[0] = ones
            continue
        acc = None
        for i in range(4):
            if m & (1 << i):
                acc = a[i] if acc is None else acc & a[i]
        mono_val[m] = acc
    out = []
    for monos in _INV4_ANF:
        acc = None
        for m in monos:
            acc = mono_val[m] if acc is None else acc ^ mono_val[m]
        out.append(acc)
    return out


def sbox_bits_tower(x, ones):
    """AES S-box on an 8-plane list via the tower-field circuit."""
    t = _apply_gf2_matrix(_T, x)
    a, b = t[:4], t[4:]
    ab = [a[i] ^ b[i] for i in range(4)]
    # D = a^2 + a*b + lam*b^2  (squarings folded into linear maps)
    asq = _apply_gf2_matrix(_SQ4, a)
    lbsq = _apply_gf2_matrix(_LAMSQ4, b)
    mul_ab = _mul4_bits(a, b)
    d_ = [asq[i] ^ mul_ab[i] ^ lbsq[i] for i in range(4)]
    dinv = _inv4_bits(d_, ones)
    c = _mul4_bits(ab, dinv)
    d2 = _mul4_bits(b, dinv)
    inv_t = c + d2
    out = _apply_gf2_matrix(_OUT_MAT, inv_t)
    # constant 0x63
    for i in range(8):
        if (0x63 >> i) & 1:
            out[i] = out[i] ^ ones
    return out
