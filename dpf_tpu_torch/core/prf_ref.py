"""Scalar reference PRFs over Python ints (the framework's ground truth).

A copy of ``dpf_tpu/core/prf_ref.py`` (pure Python), kept so the port
imports nothing of the JAX package.

These are independent, spec-derived implementations of the four PRFs the
reference framework supports (semantics documented at
``dpf_base/dpf.h:65-235``):

* ``DUMMY``    : ``seed * (i + 4242) + (i + 4242)  (mod 2^128)`` — cheap,
  deterministic fake used for differential testing of fast paths.
* ``SALSA20``  : 12-round Salsa20 core with a 128-bit key placed in state
  words 1..4 (most-significant word first) and the 64-bit stream position in
  words 8..9 (high word first); output is state words 1..4 re-packed the same
  way.  (The reference labels this "20 rounds" but iterates 12 —
  ``dpf_base/dpf.h:113`` — we match 12 and say so.)
* ``CHACHA20`` : 12-round ChaCha core, key in words 4..7 (MSW first),
  position in words 12..13 (high word first), output words 4..7.
* ``AES128``   : standard FIPS-197 AES-128; key = 16 little-endian bytes of
  the seed, plaintext = 16 little-endian bytes of the position, ciphertext
  re-read little-endian.

Everything is mod 2^128; positions are 0/1 in the GGM tree walk.
"""

from __future__ import annotations

MASK128 = (1 << 128) - 1
MASK32 = 0xFFFFFFFF

PRF_DUMMY = 0
PRF_SALSA20 = 1
PRF_CHACHA20 = 2
PRF_AES128 = 3
# Block-PRG ("wide") variants — ids 4/5 extend the reference's 0..3
# (dpf_base/dpf.h:221-235); see ``prf_salsa20_12_blk``.
PRF_SALSA20_BLK = 4
PRF_CHACHA20_BLK = 5

PRF_NAMES = {
    PRF_DUMMY: "DUMMY",
    PRF_SALSA20: "SALSA20",
    PRF_CHACHA20: "CHACHA20",
    PRF_AES128: "AES128",
    PRF_SALSA20_BLK: "SALSA20_BLK",
    PRF_CHACHA20_BLK: "CHACHA20_BLK",
}


def prf_dummy(seed: int, pos: int) -> int:
    t = (pos + 4242) & MASK128
    return (seed * t + t) & MASK128


# ---------------------------------------------------------------------------
# Salsa20/12 core
# ---------------------------------------------------------------------------

def _rotl32(x: int, b: int) -> int:
    return ((x << b) | (x >> (32 - b))) & MASK32


_SIGMA = (0x65787061, 0x6E642033, 0x322D6279, 0x7465206B)  # "expand 32-byte k"


def _seed_words_msw_first(seed: int):
    return ((seed >> 96) & MASK32, (seed >> 64) & MASK32,
            (seed >> 32) & MASK32, seed & MASK32)


def _salsa20_12_words(seed: int, ctr: int):
    """Full 16-word Salsa20/12 block: key in words 1..4 (MSW first),
    64-bit counter in words 8..9 (high word first)."""
    s = _seed_words_msw_first(seed)
    x = [0] * 16
    x[0], x[5], x[10], x[15] = _SIGMA
    x[1], x[2], x[3], x[4] = s
    x[8] = (ctr >> 32) & MASK32
    x[9] = ctr & MASK32
    init = list(x)

    def qr(a, b, c, d):
        x[b] ^= _rotl32((x[a] + x[d]) & MASK32, 7)
        x[c] ^= _rotl32((x[b] + x[a]) & MASK32, 9)
        x[d] ^= _rotl32((x[c] + x[b]) & MASK32, 13)
        x[a] ^= _rotl32((x[d] + x[c]) & MASK32, 18)

    for _ in range(6):  # 6 double rounds = 12 rounds
        qr(0, 4, 8, 12)
        qr(5, 9, 13, 1)
        qr(10, 14, 2, 6)
        qr(15, 3, 7, 11)
        qr(0, 1, 2, 3)
        qr(5, 6, 7, 4)
        qr(10, 11, 8, 9)
        qr(15, 12, 13, 14)

    return [(x[i] + init[i]) & MASK32 for i in range(16)]


def prf_salsa20_12(seed: int, pos: int) -> int:
    out = _salsa20_12_words(seed, pos)
    return (out[1] << 96) | (out[2] << 64) | (out[3] << 32) | out[4]


# ---------------------------------------------------------------------------
# ChaCha20/12 core
# ---------------------------------------------------------------------------

def _chacha20_12_words(seed: int, ctr: int):
    """Full 16-word ChaCha20/12 block: key in words 4..7 (MSW first),
    64-bit counter in words 12..13 (high word first)."""
    s = _seed_words_msw_first(seed)
    x = [0] * 16
    x[0], x[1], x[2], x[3] = _SIGMA
    x[4], x[5], x[6], x[7] = s
    x[12] = (ctr >> 32) & MASK32
    x[13] = ctr & MASK32
    init = list(x)

    def qr(a, b, c, d):
        x[a] = (x[a] + x[b]) & MASK32
        x[d] = _rotl32(x[d] ^ x[a], 16)
        x[c] = (x[c] + x[d]) & MASK32
        x[b] = _rotl32(x[b] ^ x[c], 12)
        x[a] = (x[a] + x[b]) & MASK32
        x[d] = _rotl32(x[d] ^ x[a], 8)
        x[c] = (x[c] + x[d]) & MASK32
        x[b] = _rotl32(x[b] ^ x[c], 7)

    for _ in range(6):  # 12 rounds
        qr(0, 4, 8, 12)
        qr(1, 5, 9, 13)
        qr(2, 6, 10, 14)
        qr(3, 7, 11, 15)
        qr(0, 5, 10, 15)
        qr(1, 6, 11, 12)
        qr(2, 7, 8, 13)
        qr(3, 4, 9, 14)

    return [(x[i] + init[i]) & MASK32 for i in range(16)]


def prf_chacha20_12(seed: int, pos: int) -> int:
    out = _chacha20_12_words(seed, pos)
    return (out[4] << 96) | (out[5] << 64) | (out[6] << 32) | out[7]


# ---------------------------------------------------------------------------
# Block-PRG ("wide") variants: the full 512-bit core output as 4 children
# ---------------------------------------------------------------------------

def _blk_child(out, pos: int) -> int:
    g = 4 * (pos & 3)
    return ((out[g] << 96) | (out[g + 1] << 64)
            | (out[g + 2] << 32) | out[g + 3])


def prf_salsa20_12_blk(seed: int, pos: int) -> int:
    """Salsa20/12 as a length-quadrupling counter-mode PRG.

    The classic GGM step above burns one full 512-bit core block per
    child and keeps 128 bits of it (as the reference's kernels do,
    ``dpf_gpu/prf/prf.cu:46-96`` — one uint128 out per call).  Here child
    ``pos`` is the 128-bit word group ``pos % 4`` of the block at counter
    ``pos // 4``: one core call yields FOUR children, so a radix-4 GGM
    level costs one core evaluation per node (6x fewer core calls per
    leaf than the reference's binary scheme).  Standard counter-mode PRG
    construction; keys are NOT wire-compatible with the reference (new
    method id, same 524-int32 container)."""
    return _blk_child(_salsa20_12_words(seed, pos >> 2), pos)


def prf_chacha20_12_blk(seed: int, pos: int) -> int:
    """ChaCha20/12 as a length-quadrupling counter-mode PRG (see
    ``prf_salsa20_12_blk``)."""
    return _blk_child(_chacha20_12_words(seed, pos >> 2), pos)


# ---------------------------------------------------------------------------
# AES-128 (FIPS-197), byte-oriented scalar implementation
# ---------------------------------------------------------------------------

def _build_sbox():
    # Multiplicative inverse in GF(2^8) + affine transform, computed from the
    # field definition rather than pasted as a table.
    p, q = 1, 1
    inv = [0] * 256
    # generate via the 3/0xf6 exponentiation trick
    while True:
        # p = p * 3 in GF(2^8)
        p = p ^ ((p << 1) & 0xFF) ^ (0x1B if p & 0x80 else 0)
        # q = q / 3 (multiply by 0xf6)
        q ^= (q << 1) & 0xFF
        q ^= (q << 2) & 0xFF
        q ^= (q << 4) & 0xFF
        if q & 0x80:
            q ^= 0x09
        inv[p] = q
        if p == 1:
            break
    inv[0] = 0
    sbox = [0] * 256
    for i in range(256):
        b = inv[i] if i else 0
        sbox[i] = (b ^ _rotl8(b, 1) ^ _rotl8(b, 2) ^ _rotl8(b, 3)
                   ^ _rotl8(b, 4) ^ 0x63)
    return sbox


def _rotl8(x, n):
    return ((x << n) | (x >> (8 - n))) & 0xFF


SBOX = _build_sbox()


def _xtime(b):
    b <<= 1
    if b & 0x100:
        b ^= 0x11B
    return b & 0xFF


def _key_expand(key_bytes):
    rcon = 1
    w = [list(key_bytes[4 * i:4 * i + 4]) for i in range(4)]
    for i in range(4, 44):
        t = list(w[i - 1])
        if i % 4 == 0:
            t = t[1:] + t[:1]
            t = [SBOX[b] for b in t]
            t[0] ^= rcon
            rcon = _xtime(rcon)
        w.append([w[i - 4][j] ^ t[j] for j in range(4)])
    return [[w[4 * r + c] for c in range(4)] for r in range(11)]


def _aes128_encrypt_block(key_bytes, pt_bytes):
    round_keys = _key_expand(key_bytes)
    # state[c][r]: column-major per FIPS-197 (byte 4c+r)
    st = [[pt_bytes[4 * c + r] for r in range(4)] for c in range(4)]

    def add_round_key(rk):
        for c in range(4):
            for r in range(4):
                st[c][r] ^= rk[c][r]

    def sub_bytes():
        for c in range(4):
            for r in range(4):
                st[c][r] = SBOX[st[c][r]]

    def shift_rows():
        for r in range(1, 4):
            row = [st[c][r] for c in range(4)]
            row = row[r:] + row[:r]
            for c in range(4):
                st[c][r] = row[c]

    def mix_columns():
        for c in range(4):
            a = st[c]
            t = a[0] ^ a[1] ^ a[2] ^ a[3]
            u = a[0]
            a0 = a[0] ^ t ^ _xtime(a[0] ^ a[1])
            a1 = a[1] ^ t ^ _xtime(a[1] ^ a[2])
            a2 = a[2] ^ t ^ _xtime(a[2] ^ a[3])
            a3 = a[3] ^ t ^ _xtime(a[3] ^ u)
            st[c] = [a0, a1, a2, a3]

    add_round_key(round_keys[0])
    for rnd in range(1, 10):
        sub_bytes()
        shift_rows()
        mix_columns()
        add_round_key(round_keys[rnd])
    sub_bytes()
    shift_rows()
    add_round_key(round_keys[10])
    return bytes(st[c][r] for c in range(4) for r in range(4))


def prf_aes128(seed: int, pos: int) -> int:
    key = (seed & MASK128).to_bytes(16, "little")
    pt = (pos & MASK128).to_bytes(16, "little")
    ct = _aes128_encrypt_block(key, pt)
    return int.from_bytes(ct, "little")


PRF_FUNCS = {
    PRF_DUMMY: prf_dummy,
    PRF_SALSA20: prf_salsa20_12,
    PRF_CHACHA20: prf_chacha20_12,
    PRF_AES128: prf_aes128,
    PRF_SALSA20_BLK: prf_salsa20_12_blk,
    PRF_CHACHA20_BLK: prf_chacha20_12_blk,
}


def prf(method: int, seed: int, pos: int) -> int:
    return PRF_FUNCS[method](seed, pos)
