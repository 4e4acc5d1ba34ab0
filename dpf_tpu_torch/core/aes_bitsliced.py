"""Bitsliced AES-128: no table lookups, boolean ops on bit planes.

Port of ``dpf_tpu/core/aes_bitsliced.py`` on int32 tensors (read as
uint32, ``core/u32.py``) on any device.  32 AES instances are packed per
32-bit lane ("bitslicing"): the state is held as 8 *bit tensors* of
shape ``[n_bytes, W]`` (bit i, byte position, word; word w bit j of a
plane = that bit of instance ``32w + j'`` for a fixed permutation j' --
harmless, every op is elementwise and the unpack applies the exact
inverse).  Every AES step is then AND/XOR/relabel:

* SubBytes: one of three S-box circuits (``_sbox_bits``): Boyar-Peralta
  (``aes_sbox_bp``, the default), the composite-field tower
  (``aes_sbox_circuit``) or the x^254 square-and-multiply chain.  One
  circuit pass covers every state's 16 bytes and the key schedule's 4
  (the byte axis is just tensor width).
* ShiftRows: static byte-axis permutation.
* MixColumns: a roll on the row axis + xtime (bit-index shift) + XORs.
* Key schedule: computed once, shared by the ``n_pts`` encryptions of
  positions 0..n_pts-1 (they differ only in plaintext byte 0, whose
  planes are constants).

Bit-transpose in/out of the sliced layout is the classic 32x32 masked
shift-swap (5 rounds), vectorized over blocks; its right shifts are
logical (``u32.shr``).

This is ``EvalConfig.aes_impl = "bitsliced"``'s formulation of the plain
AES (``core/prf.prf_multi``).  On the card the AES levels run K1
(``csrc/aes_level.cu``, T-tables) whatever ``aes_impl`` says: a
bitsliced kernel would hold 32 lanes' state and round keys, 256 words,
in one thread's registers, and K1's output bits are the same.
Semantics identical to ``prf_ref.prf_aes128`` (key = seed LE bytes, pt
= pos LE bytes, output LE).
"""

from __future__ import annotations

import numpy as np
import torch

from .u32 import i32, shr

_MASKS = {
    16: 0x0000FFFF,
    8: 0x00FF00FF,
    4: 0x0F0F0F0F,
    2: 0x33333333,
    1: 0x55555555,
}


def _transpose32(words):
    """32x32 bit transpose (masked shift-swap), vectorized over blocks.

    `words`: list of 32 int32 tensors [W].  Involution up to a fixed
    reversal: element j bit b of the input appears at row 31-b bit 31-j.
    """
    x = list(words)
    for j in (16, 8, 4, 2, 1):
        m = i32(_MASKS[j])
        for k in range(32):
            if k & j:
                continue
            t = (x[k] ^ shr(x[k + j], j)) & m
            x[k] = x[k] ^ t
            x[k + j] = x[k + j] ^ (t << j)
    return x


def pack_planes(values: torch.Tensor):
    """[M] int32 (M % 32 == 0) -> 32 planes [M/32]; plane b holds bit b
    of every element (element order within a word is permuted -- see
    above)."""
    m = values.shape[0]
    blocks = values.reshape(m // 32, 32)
    rows = [blocks[:, k] for k in range(32)]
    return _transpose32(rows)[::-1]


def unpack_planes(planes) -> torch.Tensor:
    """Inverse of pack_planes: 32 planes [W] -> [32*W] int32 values."""
    rows = _transpose32(list(planes)[::-1])
    return torch.stack(rows, dim=1).reshape(-1)


# ---------------------------------------------------------------------------
# GF(2^8) circuits on 8 bit-tensors (LSB-first; any common shape)
# ---------------------------------------------------------------------------

def _gf_mul(a, b):
    """Schoolbook product reduced mod x^8 + x^4 + x^3 + x + 1."""
    t = [None] * 15
    for i in range(8):
        for j in range(8):
            p = a[i] & b[j]
            k = i + j
            t[k] = p if t[k] is None else t[k] ^ p
    for d in range(14, 7, -1):  # x^d -> x^(d-4)+x^(d-5)+x^(d-7)+x^(d-8)
        v = t[d]
        t[d - 4] = t[d - 4] ^ v
        t[d - 5] = t[d - 5] ^ v
        t[d - 7] = t[d - 7] ^ v
        t[d - 8] = t[d - 8] ^ v
    return t[:8]


def _sq_table():
    rows = [[0] * 8 for _ in range(8)]
    for i in range(8):
        v = 1
        for _ in range(2 * i):
            v <<= 1
            if v & 0x100:
                v ^= 0x11B
        for bit in range(8):
            if (v >> bit) & 1:
                rows[bit][i] = 1
    return rows


_SQ_ROWS = _sq_table()


def _gf_sq(a):
    """Squaring is GF(2)-linear: fixed XOR combination per output bit."""
    out = []
    for bit in range(8):
        acc = None
        for i in range(8):
            if _SQ_ROWS[bit][i]:
                acc = a[i] if acc is None else acc ^ a[i]
        out.append(acc)
    return out


def _sbox_bits_chain(a, ones):
    """AES S-box via the x^254 square-and-multiply chain (~760 plane ops).

    Kept as the independently-derived cross-check for the tower circuit."""
    x2 = _gf_sq(a)
    x3 = _gf_mul(x2, a)
    x15 = _gf_mul(_gf_sq(_gf_sq(x3)), x3)
    x63 = _gf_mul(_gf_sq(_gf_sq(x15)), x3)
    x127 = _gf_mul(_gf_sq(x63), a)
    inv = _gf_sq(x127)
    out = []
    for i in range(8):
        acc = (inv[i] ^ inv[(i + 4) % 8] ^ inv[(i + 5) % 8]
               ^ inv[(i + 6) % 8] ^ inv[(i + 7) % 8])
        if (0x63 >> i) & 1:
            acc = acc ^ ones
        out.append(acc)
    return out


SBOXES = ("bp", "tower", "chain")
SBOX_IMPL = "bp"  # the default: the smallest circuit


def _sbox_bits(a, ones, impl: str | None = None):
    """AES S-box on 8 bit-tensors.  Three interchangeable circuits:

    * ``bp``    -- Boyar-Peralta shared-signal circuit, ~120 plane ops
      (``aes_sbox_bp``; the default).
    * ``tower`` -- composite-field GF((2^4)^2) circuit, ~193 ops
      (``aes_sbox_circuit.py``).
    * ``chain`` -- x^254 square-and-multiply, ~760 ops (cross-check).
    """
    impl = impl or SBOX_IMPL
    if impl == "bp":
        from .aes_sbox_bp import sbox_bits_bp
        return sbox_bits_bp(a, ones)
    if impl == "tower":
        from .aes_sbox_circuit import sbox_bits_tower
        return sbox_bits_tower(a, ones)
    if impl != "chain":
        raise ValueError("sbox must be one of %s (got %r)" % (SBOXES, impl))
    return _sbox_bits_chain(a, ones)


# ---------------------------------------------------------------------------
# AES steps.  A state is a list of 8 tensors [16, W] (bit, byte, word) with
# byte = FIPS flat index 4*col + row.
# ---------------------------------------------------------------------------

_SHIFT_ROWS_BYTE = np.array(
    [(4 * ((i // 4 + i % 4) % 4)) + i % 4 for i in range(16)])


def _shift_rows(bits, m: int = 1):
    """Byte permutation; ``m`` fused states tile the 16-byte pattern."""
    perm = np.concatenate([_SHIFT_ROWS_BYTE + 16 * k for k in range(m)])
    idx = torch.from_numpy(perm).to(bits[0].device)
    return [b[idx] for b in bits]


def _xtime_bits(bits):
    out = [bits[7]]
    for i in range(1, 8):
        v = bits[i - 1]
        if (0x1B >> i) & 1:
            v = v ^ bits[7]
        out.append(v)
    return out


def _mix_columns(bits):
    """Works on any multiple of 16 bytes (M fused states = 4M columns)."""
    a4 = [b.reshape(-1, 4, b.shape[-1]) for b in bits]  # [col, row, W]
    nxt = [torch.roll(a, -1, dims=1) for a in a4]
    x = [a4[i] ^ nxt[i] for i in range(8)]
    xt = _xtime_bits(x)
    out = []
    for i in range(8):
        t = (a4[i][:, 0:1] ^ a4[i][:, 1:2] ^ a4[i][:, 2:3]
             ^ a4[i][:, 3:4])
        out.append((a4[i] ^ t ^ xt[i]).reshape(bits[i].shape))
    return out


_ROT_WORD = np.array([13, 14, 15, 12])


def _ark(st, rk, m_cnt):
    """AddRoundKey on a fused state: st planes [16*M, W] ^ rk [16, W],
    broadcast through a [M, 16, W] view."""
    if m_cnt == 1:
        return [st[i] ^ rk[i] for i in range(8)]
    return [(st[i].reshape(m_cnt, 16, -1) ^ rk[i]).reshape(st[i].shape)
            for i in range(8)]


def _round_fused(st, rk, m_cnt, rcon: int, ones, sbox: str | None = None):
    """One AES SubBytes + schedule step on a FUSED state of M instances.

    ``st``: 8 planes [16*M, W] (states back to back on the byte axis);
    ``rk``: 8 planes [16, W].  All ``16*M + 4`` S-box byte positions (the
    states' SubBytes and the schedule's RotWord) ride a single circuit
    pass.  Returns (sub, new_rk), sub pre-ShiftRows."""
    rot = torch.from_numpy(_ROT_WORD).to(ones.device)
    fused_in = [torch.cat([st[i], rk[i][rot]]) for i in range(8)]
    fused_out = _sbox_bits(fused_in, ones, sbox)
    sub = [f[:16 * m_cnt] for f in fused_out]
    t = [f[16 * m_cnt:16 * m_cnt + 4] for f in fused_out]
    # rcon into byte 0 of the rotated word
    t = [torch.cat([t[i][0:1] ^ ones, t[i][1:]]) if (rcon >> i) & 1
         else t[i] for i in range(8)]
    # words: out_w0 = rk_w0 ^ t; out_wk = out_w{k-1} ^ rk_wk
    new_rk = []
    for i in range(8):
        r = rk[i].reshape(4, 4, -1)                   # [word, byte, W]
        w0 = r[0] ^ t[i]
        w1 = w0 ^ r[1]
        w2 = w1 ^ r[2]
        w3 = w2 ^ r[3]
        new_rk.append(torch.cat([w0, w1, w2, w3]))
    return sub, new_rk


_RCON_VALS = [None, 1, 2, 4, 8, 16, 32, 64, 128, 0x1B, 0x36]


def aes128_pair_bitsliced(seeds: torch.Tensor, sbox: str | None = None):
    """Bitsliced AES of positions 0 and 1 under per-element keys:
    ``aes128_multi_bitsliced(seeds, 2, sbox)``."""
    return aes128_multi_bitsliced(seeds, 2, sbox)


def aes128_multi_bitsliced(seeds: torch.Tensor, n_pts: int,
                           sbox: str | None = None):
    """Bitsliced AES of positions 0..n_pts-1 under per-element keys.

    seeds: [..., 4] int32 limb tensor on any device -> a tuple of
    ``n_pts`` limb tensors shaped like ``seeds``, bit-identical to
    ``prf_ref.prf_aes128(seed, b)``.  All plaintexts share one key (the
    seed), so the key schedule and the S-box circuit passes are fused
    across them: one round evaluates a single circuit over
    ``16 * n_pts + 4`` byte positions.  ``sbox`` selects the circuit
    (``_sbox_bits``)."""
    if not 1 <= n_pts <= 255:
        raise ValueError("n_pts must be in [1, 255], got %r" % (n_pts,))
    if seeds.dtype != torch.int32 or seeds.shape[-1] != 4:
        raise TypeError("seeds must be an int32 [..., 4] limb tensor")
    orig_shape = seeds.shape
    flat = seeds.reshape(-1, 4)
    m = flat.shape[0]
    pad = (-m) % 32
    if pad:
        flat = torch.cat([flat, flat.new_zeros((pad, 4))])

    # plane p (= seed bit p = LE key byte p//8, bit p%8) -> bit tensors
    # bits[i][byte] with byte-major state order matching the key bytes
    planes = []
    for l in range(4):
        planes.extend(pack_planes(flat[:, l].contiguous()))
    w = planes[0].shape[0]
    rk = [torch.stack([planes[8 * byte + i] for byte in range(16)])
          for i in range(8)]                          # 8 x [16, W]
    ones = torch.full((w,), -1, dtype=torch.int32, device=seeds.device)

    # Fused initial state [16*M, W]: instance b's plaintext has only
    # byte 0 nonzero (value b), so plane i's block b is rk[i] with row 0
    # xored by (b >> i) & 1 -- built directly on the fused tensor.
    st = []
    for i in range(8):
        bits = torch.tensor([-((b >> i) & 1) for b in range(n_pts)],
                            dtype=torch.int32, device=seeds.device)
        row0 = ones[None, None, :] & bits[:, None, None]
        pt = torch.cat([row0, row0.new_zeros((n_pts, 15, w))], dim=1)
        st.append((pt ^ rk[i]).reshape(16 * n_pts, w))

    for rnd in range(1, 10):
        sub, rk = _round_fused(st, rk, n_pts, _RCON_VALS[rnd], ones, sbox)
        st = _ark(_mix_columns(_shift_rows(sub, n_pts)), rk, n_pts)
    # final round: Sub + Shift + ARK (no MixColumns)
    sub, rk = _round_fused(st, rk, n_pts, _RCON_VALS[10], ones, sbox)
    fin = _ark(_shift_rows(sub, n_pts), rk, n_pts)

    def to_limbs(b):
        # instance b planes bits[i][byte] -> planes p = 8*byte + i -> limbs
        limbs = []
        for l in range(4):
            pl = [fin[p % 8][16 * b + p // 8]
                  for p in range(32 * l, 32 * l + 32)]
            limbs.append(unpack_planes(pl))
        return torch.stack(limbs, dim=-1)[:m].reshape(orig_shape)

    return tuple(to_limbs(b) for b in range(n_pts))
