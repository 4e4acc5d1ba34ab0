"""Vectorized PRFs over [..., 4] int32 limb tensors (plain PyTorch).

Port of ``prf_v`` / ``prf_pair`` / ``prf_multi`` in
``dpf_tpu/core/prf.py`` for PRF ids 0-5.  Each function maps a batch of
128-bit seeds (trailing axis = 4 little-endian 32-bit limbs, int32
tensors read as uint32, see ``core/u32.py``) and a position ``pos`` to
a batch of 128-bit outputs, bit-identical to ``core/prf_ref.py``.
``pos`` is a Python int (the branch 0..3 of the GGM walk) or an int32
tensor of positions below 2^32, read as uint32, that broadcasts against
``seeds[..., 0]`` (the rows of the sqrt-N grid; JAX's ``_pos_word`` /
``_pos_bytes``).

These are the plain versions the CUDA kernels are held against: the
kernels in ``csrc/`` re-implement the same ciphers per thread.
"""

from __future__ import annotations

import torch

from . import u128
from .prf_ref import (PRF_AES128, PRF_CHACHA20, PRF_CHACHA20_BLK,
                      PRF_DUMMY, PRF_SALSA20, PRF_SALSA20_BLK, SBOX)
from .u32 import i32, rotl, shr

_SIGMA = (0x65787061, 0x6E642033, 0x322D6279, 0x7465206B)


def _const(zero: torch.Tensor, value: int) -> torch.Tensor:
    return zero + i32(value)


def _pos_word(zero: torch.Tensor, pos, word: int) -> torch.Tensor:
    """32-bit word ``word`` of the 128-bit position, broadcast like
    ``zero``: a tensor position is below 2^32, so only word 0 is set."""
    if isinstance(pos, torch.Tensor):
        return zero + pos if word == 0 else zero
    return _const(zero, (int(pos) >> (32 * word)) & 0xFFFFFFFF)


# ---------------------------------------------------------------------------
# DUMMY
# ---------------------------------------------------------------------------

def prf_dummy_v(seeds: torch.Tensor, pos) -> torch.Tensor:
    """seed * (pos+4242) + (pos+4242) mod 2^128."""
    if isinstance(pos, torch.Tensor):
        t = pos + 4242                  # row indices < 2^32 - 4242
        prod = u128.mul128_small(seeds, t)
        zero = torch.zeros_like(prod[..., 0])
        tb = torch.stack([zero + t, zero, zero, zero], dim=-1)
        return u128.add128(prod, tb)
    t = int(pos) + 4242
    tb = torch.zeros_like(seeds)
    tb[..., 0] = t
    return u128.add128(u128.mul128_small(seeds, t), tb)


# ---------------------------------------------------------------------------
# Salsa20/12 & ChaCha20/12 (16-word blocks as lists of int32 tensors)
# ---------------------------------------------------------------------------

def _salsa_qr(x, a, b, c, d):
    x[b] = x[b] ^ rotl(x[a] + x[d], 7)
    x[c] = x[c] ^ rotl(x[b] + x[a], 9)
    x[d] = x[d] ^ rotl(x[c] + x[b], 13)
    x[a] = x[a] ^ rotl(x[d] + x[c], 18)


def _salsa20_12_words(seeds: torch.Tensor, ctr):
    """Full 16-word Salsa20/12 block: key in words 1..4 (MSW first),
    64-bit counter in words 8..9 (high word first)."""
    zero = torch.zeros_like(seeds[..., 0])
    if isinstance(ctr, torch.Tensor):
        zero = zero + torch.zeros_like(ctr)
    x = [zero] * 16
    x[0] = _const(zero, _SIGMA[0])
    x[5] = _const(zero, _SIGMA[1])
    x[10] = _const(zero, _SIGMA[2])
    x[15] = _const(zero, _SIGMA[3])
    x[1], x[2], x[3], x[4] = (seeds[..., 3], seeds[..., 2], seeds[..., 1],
                              seeds[..., 0])
    x[8] = _pos_word(zero, ctr, 1)
    x[9] = _pos_word(zero, ctr, 0)
    init = list(x)
    for _ in range(6):  # 6 double rounds = 12 rounds
        _salsa_qr(x, 0, 4, 8, 12)
        _salsa_qr(x, 5, 9, 13, 1)
        _salsa_qr(x, 10, 14, 2, 6)
        _salsa_qr(x, 15, 3, 7, 11)
        _salsa_qr(x, 0, 1, 2, 3)
        _salsa_qr(x, 5, 6, 7, 4)
        _salsa_qr(x, 10, 11, 8, 9)
        _salsa_qr(x, 15, 12, 13, 14)
    return [x[i] + init[i] for i in range(16)]


def prf_salsa20_12_v(seeds: torch.Tensor, pos) -> torch.Tensor:
    """12-round Salsa20 core; output words 4..1 as limbs 0..3."""
    out = _salsa20_12_words(seeds, pos)
    return torch.stack([out[4], out[3], out[2], out[1]], dim=-1)


def _chacha_qr(x, a, b, c, d):
    x[a] = x[a] + x[b]
    x[d] = rotl(x[d] ^ x[a], 16)
    x[c] = x[c] + x[d]
    x[b] = rotl(x[b] ^ x[c], 12)
    x[a] = x[a] + x[b]
    x[d] = rotl(x[d] ^ x[a], 8)
    x[c] = x[c] + x[d]
    x[b] = rotl(x[b] ^ x[c], 7)


def _chacha20_12_words(seeds: torch.Tensor, ctr):
    """Full 16-word ChaCha20/12 block: key in words 4..7 (MSW first),
    64-bit counter in words 12..13 (high word first)."""
    zero = torch.zeros_like(seeds[..., 0])
    if isinstance(ctr, torch.Tensor):
        zero = zero + torch.zeros_like(ctr)
    x = [_const(zero, _SIGMA[i]) for i in range(4)] + [zero] * 12
    x[4], x[5], x[6], x[7] = (seeds[..., 3], seeds[..., 2], seeds[..., 1],
                              seeds[..., 0])
    x[12] = _pos_word(zero, ctr, 1)
    x[13] = _pos_word(zero, ctr, 0)
    init = list(x)
    for _ in range(6):  # 12 rounds
        _chacha_qr(x, 0, 4, 8, 12)
        _chacha_qr(x, 1, 5, 9, 13)
        _chacha_qr(x, 2, 6, 10, 14)
        _chacha_qr(x, 3, 7, 11, 15)
        _chacha_qr(x, 0, 5, 10, 15)
        _chacha_qr(x, 1, 6, 11, 12)
        _chacha_qr(x, 2, 7, 8, 13)
        _chacha_qr(x, 3, 4, 9, 14)
    return [x[i] + init[i] for i in range(16)]


def prf_chacha20_12_v(seeds: torch.Tensor, pos) -> torch.Tensor:
    """12-round ChaCha core; output words 7..4 as limbs 0..3."""
    out = _chacha20_12_words(seeds, pos)
    return torch.stack([out[7], out[6], out[5], out[4]], dim=-1)


# ---------------------------------------------------------------------------
# Block-PRG ("wide") ids 4/5: child pos = word group pos%4 of the block at
# counter pos//4 -- one 512-bit core call serves four GGM children
# ---------------------------------------------------------------------------

_BLK_WORDS = {PRF_SALSA20_BLK: _salsa20_12_words,
              PRF_CHACHA20_BLK: _chacha20_12_words}


def _blk_group(out, g: int) -> torch.Tensor:
    """128-bit child from block words [g, g+3] (MSW-first packing)."""
    return torch.stack([out[g + 3], out[g + 2], out[g + 1], out[g]], dim=-1)


def _prf_blk(words_fn, seeds: torch.Tensor, pos) -> torch.Tensor:
    """A static position slices its word group; a tensor position picks
    the group ``pos & 3`` of the block at counter ``pos >> 2`` per
    element."""
    if not isinstance(pos, torch.Tensor):
        return _blk_group(words_fn(seeds, int(pos) >> 2), 4 * (int(pos) & 3))
    out = words_fn(seeds, shr(pos, 2))
    sel = (pos & 3)[..., None]
    res = _blk_group(out, 0)
    for g in (1, 2, 3):
        res = torch.where(sel == g, _blk_group(out, 4 * g), res)
    return res


def prf_salsa20_12_blk_v(seeds: torch.Tensor, pos) -> torch.Tensor:
    return _prf_blk(_salsa20_12_words, seeds, pos)


def prf_chacha20_12_blk_v(seeds: torch.Tensor, pos) -> torch.Tensor:
    return _prf_blk(_chacha20_12_words, seeds, pos)


# ---------------------------------------------------------------------------
# AES-128 with a gather S-box (byte planes as int32 tensors)
# ---------------------------------------------------------------------------

# ShiftRows on flat byte index i = 4*col + row:
# new[4c + r] = old[4*((c + r) % 4) + r]
_SHIFT_ROWS = [(4 * ((i // 4 + i % 4) % 4)) + i % 4 for i in range(16)]


def _xtime(b: torch.Tensor) -> torch.Tensor:
    """GF(2^8) doubling on byte lanes."""
    return ((b << 1) ^ (shr(b, 7) * 0x1B)) & 0xFF


def _bytes_of_limbs(seeds: torch.Tensor):
    """[..., 4] limbs -> 16 little-endian byte tensors [...]."""
    return [shr(seeds[..., i], s) & 0xFF for i in range(4)
            for s in (0, 8, 16, 24)]


def _limbs_of_bytes(b) -> torch.Tensor:
    """16 LE byte tensors -> [..., 4] limbs."""
    return torch.stack([b[4 * i] | (b[4 * i + 1] << 8) | (b[4 * i + 2] << 16)
                        | (b[4 * i + 3] << 24) for i in range(4)], dim=-1)


def _mix_columns(st):
    ns = list(st)
    for c in range(4):
        a = st[4 * c:4 * c + 4]
        t = a[0] ^ a[1] ^ a[2] ^ a[3]
        ns[4 * c + 0] = a[0] ^ t ^ _xtime(a[0] ^ a[1])
        ns[4 * c + 1] = a[1] ^ t ^ _xtime(a[1] ^ a[2])
        ns[4 * c + 2] = a[2] ^ t ^ _xtime(a[2] ^ a[3])
        ns[4 * c + 3] = a[3] ^ t ^ _xtime(a[3] ^ a[0])
    return ns


def _pos_bytes(zero: torch.Tensor, pos) -> list:
    """16 little-endian plaintext bytes of a position (int or tensor),
    as ints or tensors; None for a zero byte of an int position."""
    if isinstance(pos, torch.Tensor):
        return [zero + (shr(pos, 8 * k) & 0xFF) for k in range(4)] + \
            [None] * 12
    pt = (int(pos) & ((1 << 128) - 1)).to_bytes(16, "little")
    return [b or None for b in pt]


def aes128_multi(seeds: torch.Tensor, positions) -> tuple:
    """FIPS-197 AES-128 of each plaintext position in ``positions`` (ints
    or int32 tensors below 2^32 that broadcast against ``seeds[..., 0]``)
    under the per-seed key (key = seed LE bytes, plaintext = position LE
    bytes, ciphertext re-read LE).  The key schedule is computed once
    and shared by all positions, one round key live at a time."""
    sbox = torch.tensor(SBOX, dtype=torch.int32, device=seeds.device)

    def sub(v):
        return sbox[v.long()]

    rk = _bytes_of_limbs(seeds)
    zero = torch.zeros_like(seeds[..., 0])
    for pos in positions:
        if isinstance(pos, torch.Tensor):
            zero = zero + torch.zeros_like(pos)
    sts = []
    for pos in positions:
        pt = _pos_bytes(zero, pos)
        sts.append([rk[i] ^ pt[i] if pt[i] is not None else rk[i] + zero
                    for i in range(16)])
    rcon = 1
    for rnd in range(1, 11):
        for k, st in enumerate(sts):
            st = [sub(st[_SHIFT_ROWS[i]]) for i in range(16)]
            sts[k] = _mix_columns(st) if rnd < 10 else st
        # next round key (fused schedule)
        t = [sub(rk[13]) ^ rcon, sub(rk[14]), sub(rk[15]), sub(rk[12])]
        rcon = ((rcon << 1) ^ (0x11B if rcon & 0x80 else 0)) & 0xFF
        nk = [rk[i] ^ t[i] for i in range(4)]
        for i in range(4, 16):
            nk.append(nk[i - 4] ^ rk[i])
        rk = nk
        sts = [[st[i] ^ rk[i] for i in range(16)] for st in sts]
    return tuple(_limbs_of_bytes(st) for st in sts)


def prf_aes128_v(seeds: torch.Tensor, pos) -> torch.Tensor:
    return aes128_multi(seeds, (pos,))[0]


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------

PRF_V = {
    PRF_DUMMY: prf_dummy_v,
    PRF_SALSA20: prf_salsa20_12_v,
    PRF_CHACHA20: prf_chacha20_12_v,
    PRF_AES128: prf_aes128_v,
    PRF_SALSA20_BLK: prf_salsa20_12_blk_v,
    PRF_CHACHA20_BLK: prf_chacha20_12_blk_v,
}


def prf_v(method: int, seeds: torch.Tensor, pos) -> torch.Tensor:
    """Vectorized PRF of one position: a Python int, or an int32 tensor
    of positions that broadcasts against ``seeds[..., 0]``."""
    return PRF_V[method](seeds, pos)


def prf_multi(method: int, seeds: torch.Tensor, arity: int) -> tuple:
    """All ``arity`` children PRF(seed, 0..arity-1): one shared key
    schedule for AES, one core block for the block-PRG ids (child ``b``
    = block words [4b..4b+3]), one ``prf_v`` call per position
    otherwise."""
    if method in _BLK_WORDS:
        if arity > 4:
            raise ValueError("a block-PRG core block yields 4 children")
        out = _BLK_WORDS[method](seeds, 0)
        return tuple(_blk_group(out, 4 * b) for b in range(arity))
    if method == PRF_AES128:
        return aes128_multi(seeds, range(arity))
    return tuple(prf_v(method, seeds, b) for b in range(arity))


def prf_pair(method: int, seeds: torch.Tensor) -> tuple:
    """Both children PRF(seed, 0), PRF(seed, 1)."""
    return prf_multi(method, seeds, 2)
