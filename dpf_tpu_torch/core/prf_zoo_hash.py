"""Hash-based PRF-zoo candidates: SipHash, BLAKE2s, Keccak, Highway-style,
MD5 and SHA-256.

Port of ``dpf_tpu/core/prf_zoo_hash.py`` on int32 tensors read as uint32
(``core/u32.py``: logical right shifts and rotations through ``shr`` /
``rotl``, unsigned compares through ``ult``), on any device.  64-bit
words stay pairs of 32-bit limbs, as in ``dpf_tpu`` (``_add64``,
``_rotl64``): nothing relies on int64 overflow.  The scalar references
(``siphash24_ref``, ``keccakf_ref``, ``sha3_256_ref``) and the derived
constants are copies.

* ``siphash24`` / ``siphash13`` -- SipHash-c-d over 64-bit ARX lanes as
  32-bit limb pairs.  128-bit output = two independent instances on
  domain-separated messages.
* ``blake2s`` -- full keyed BLAKE2s-128 (key = seed, message = position),
  RFC 7693 semantics.
* ``keccakf800`` -- a Keccak-f[800] sponge PRF: 32-bit lanes, seed +
  position absorbed into the state, one permutation, 128-bit squeeze;
  round constants and rotation offsets derived from the Keccak LFSR /
  (t+1)(t+2)/2 schedule.
* ``highway_proxy`` -- a HighwayHash-*style* candidate: the same op mix
  (4x64-bit lanes, 32x32->64 multiplies, shuffle + lane adds per round)
  with documented non-published constants.  It is NOT HighwayHash.
* ``md5`` / ``sha256`` -- one padded block of seed || position, constants
  derived (sin(), integer roots).

Zoo candidates are NOT wire-compatible with reference keys; they exist
for the throughput study.  All map ``(seeds [n, 4] int32, pos: int) ->
[n, 4] int32`` like the shipped PRFs, with ``dpf_tpu``'s bits.
"""

from __future__ import annotations

import torch

from .u32 import i32, rotl, shr, ult

M32 = 0xFFFFFFFF


def _stack(limbs) -> torch.Tensor:
    return torch.stack(list(limbs), dim=-1)


# ---------------------------------------------------------------------------
# 64-bit helpers over (lo, hi) 32-bit limb pairs
# ---------------------------------------------------------------------------

def _add64(a, b):
    lo = a[0] + b[0]
    return (lo, a[1] + b[1] + ult(lo, a[0]).to(lo.dtype))


def _xor64(a, b):
    return (a[0] ^ b[0], a[1] ^ b[1])


def _rotl64(a, n: int):
    lo, hi = a
    n %= 64
    if n == 0:
        return a
    if n == 32:
        return (hi, lo)
    if n > 32:
        lo, hi, n = hi, lo, n - 32
    return ((lo << n) | shr(hi, 32 - n), (hi << n) | shr(lo, 32 - n))


def _const64(v: int, like):
    z = torch.zeros_like(like)
    return (z + i32(v & M32), z + i32(v >> 32))


# ---------------------------------------------------------------------------
# SipHash-c-d (64-bit lanes as 32-bit limb pairs)
# ---------------------------------------------------------------------------

_SIP_IV = (0x736f6d6570736575, 0x646f72616e646f6d,
           0x6c7967656e657261, 0x7465646279746573)


def _sipround(v0, v1, v2, v3):
    v0 = _add64(v0, v1)
    v1 = _rotl64(v1, 13)
    v1 = _xor64(v1, v0)
    v0 = _rotl64(v0, 32)
    v2 = _add64(v2, v3)
    v3 = _rotl64(v3, 16)
    v3 = _xor64(v3, v2)
    v0 = _add64(v0, v3)
    v3 = _rotl64(v3, 21)
    v3 = _xor64(v3, v0)
    v2 = _add64(v2, v1)
    v1 = _rotl64(v1, 17)
    v1 = _xor64(v1, v2)
    v2 = _rotl64(v2, 32)
    return v0, v1, v2, v3


def _siphash64(k0, k1, m, c: int, d: int):
    """One SipHash-c-d of a single 8-byte message block (m 64-bit)."""
    z = k0[0]
    v0 = _xor64(k0, _const64(_SIP_IV[0], z))
    v1 = _xor64(k1, _const64(_SIP_IV[1], z))
    v2 = _xor64(k0, _const64(_SIP_IV[2], z))
    v3 = _xor64(k1, _const64(_SIP_IV[3], z))
    v3 = _xor64(v3, m)
    for _ in range(c):
        v0, v1, v2, v3 = _sipround(v0, v1, v2, v3)
    v0 = _xor64(v0, m)
    # final block: empty remainder, len = 8 -> m_final = 8 << 56
    mf = _const64(8 << 56, z)
    v3 = _xor64(v3, mf)
    for _ in range(c):
        v0, v1, v2, v3 = _sipround(v0, v1, v2, v3)
    v0 = _xor64(v0, mf)
    v2 = _xor64(v2, _const64(0xFF, z))
    for _ in range(d):
        v0, v1, v2, v3 = _sipround(v0, v1, v2, v3)
    return _xor64(_xor64(v0, v1), _xor64(v2, v3))


def make_siphash_core(c: int, d: int):
    """SipHash-c-d-based PRF: 128-bit out = two domain-separated instances."""

    def fn(seeds, pos: int):
        k0 = (seeds[..., 0], seeds[..., 1])
        k1 = (seeds[..., 2], seeds[..., 3])
        lo = _siphash64(k0, k1, _const64(2 * pos, seeds[..., 0]), c, d)
        hi = _siphash64(k0, k1, _const64(2 * pos + 1, seeds[..., 0]), c, d)
        return _stack([lo[0], lo[1], hi[0], hi[1]])

    fn.__name__ = "siphash%d%d" % (c, d)
    return fn


def siphash24_ref(key16: bytes, msg: bytes, c: int = 2, d: int = 4) -> int:
    """Scalar SipHash-c-d reference (arbitrary message length), for KATs."""
    mask = (1 << 64) - 1

    def rotl(x, b):
        return ((x << b) | (x >> (64 - b))) & mask

    def rnd(v0, v1, v2, v3):
        v0 = (v0 + v1) & mask
        v1 = rotl(v1, 13) ^ v0
        v0 = rotl(v0, 32)
        v2 = (v2 + v3) & mask
        v3 = rotl(v3, 16) ^ v2
        v0 = (v0 + v3) & mask
        v3 = rotl(v3, 21) ^ v0
        v2 = (v2 + v1) & mask
        v1 = rotl(v1, 17) ^ v2
        v2 = rotl(v2, 32)
        return v0, v1, v2, v3

    k0 = int.from_bytes(key16[:8], "little")
    k1 = int.from_bytes(key16[8:], "little")
    v = [k0 ^ _SIP_IV[0], k1 ^ _SIP_IV[1], k0 ^ _SIP_IV[2], k1 ^ _SIP_IV[3]]
    n = len(msg)
    for i in range(n // 8):
        m = int.from_bytes(msg[8 * i:8 * i + 8], "little")
        v[3] ^= m
        for _ in range(c):
            v = list(rnd(*v))
        v[0] ^= m
    m = (n & 0xFF) << 56
    for i, byte in enumerate(msg[8 * (n // 8):]):
        m |= byte << (8 * i)
    v[3] ^= m
    for _ in range(c):
        v = list(rnd(*v))
    v[0] ^= m
    v[2] ^= 0xFF
    for _ in range(d):
        v = list(rnd(*v))
    return v[0] ^ v[1] ^ v[2] ^ v[3]


# ---------------------------------------------------------------------------
# BLAKE2s (RFC 7693), keyed, digest 16 bytes
# ---------------------------------------------------------------------------

_B2S_IV = (0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
           0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19)
_B2S_SIGMA = (
    (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15),
    (14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3),
    (11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4),
    (7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8),
    (9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13),
    (2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9),
    (12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11),
    (13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10),
    (6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5),
    (10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0),
)


def _rotr32(x, b: int):
    return shr(x, b) | (x << (32 - b))


def _b2s_compress(h, m, t: int, final: bool, zeros):
    v = list(h) + [zeros + i32(iv) for iv in _B2S_IV]
    v[12] = v[12] ^ i32(t & M32)
    v[13] = v[13] ^ i32((t >> 32) & M32)
    if final:
        v[14] = ~v[14]

    def g(a, b, c, d, x, y):
        v[a] = v[a] + v[b] + x
        v[d] = _rotr32(v[d] ^ v[a], 16)
        v[c] = v[c] + v[d]
        v[b] = _rotr32(v[b] ^ v[c], 12)
        v[a] = v[a] + v[b] + y
        v[d] = _rotr32(v[d] ^ v[a], 8)
        v[c] = v[c] + v[d]
        v[b] = _rotr32(v[b] ^ v[c], 7)

    for r in range(10):
        s = _B2S_SIGMA[r]
        g(0, 4, 8, 12, m[s[0]], m[s[1]])
        g(1, 5, 9, 13, m[s[2]], m[s[3]])
        g(2, 6, 10, 14, m[s[4]], m[s[5]])
        g(3, 7, 11, 15, m[s[6]], m[s[7]])
        g(0, 5, 10, 15, m[s[8]], m[s[9]])
        g(1, 6, 11, 12, m[s[10]], m[s[11]])
        g(2, 7, 8, 13, m[s[12]], m[s[13]])
        g(3, 4, 9, 14, m[s[14]], m[s[15]])
    return [h[i] ^ v[i] ^ v[i + 8] for i in range(8)]


def blake2s_core(seeds, pos: int):
    """Keyed BLAKE2s-128(key=seed LE bytes, msg=pos as 8 LE bytes)."""
    zeros = torch.zeros_like(seeds[..., 0])
    h = [zeros + i32(iv) for iv in _B2S_IV]
    # param block word 0: digest 16 B | key 16 B | fanout 1 | depth 1
    h[0] = h[0] ^ (16 | (16 << 8) | (1 << 16) | (1 << 24))
    # key block: key padded to 64 bytes
    key_m = [seeds[..., i] if i < 4 else zeros for i in range(16)]
    h = _b2s_compress(h, key_m, 64, False, zeros)
    # message block: 8-byte position
    msg_m = [zeros] * 16
    msg_m[0] = zeros + i32(pos & M32)
    msg_m[1] = zeros + i32((pos >> 32) & M32)
    h = _b2s_compress(h, msg_m, 64 + 8, True, zeros)
    return _stack(h[:4])


# ---------------------------------------------------------------------------
# Keccak-f[800] sponge PRF (32-bit lanes; constants derived, not transcribed)
# ---------------------------------------------------------------------------

def keccak_round_constants(n_rounds: int, lane_log: int):
    """RC[i] from the Keccak LFSR x^8 + x^6 + x^5 + x^4 + 1."""
    def rc_bit(t):
        r = 1
        for _ in range(t % 255):
            r <<= 1
            if r & 0x100:
                r ^= 0x171
        return r & 1

    w = 1 << lane_log
    out = []
    for i in range(n_rounds):
        rc = 0
        for j in range(7):
            if rc_bit(j + 7 * i) and (1 << j) - 1 < w:
                rc |= 1 << ((1 << j) - 1)
        out.append(rc)
    return out


def keccak_rho_offsets():
    """Rotation offsets from the (x,y) -> (y, 2x+3y) walk."""
    off = [[0] * 5 for _ in range(5)]
    x, y = 1, 0
    for t in range(24):
        off[x][y] = (t + 1) * (t + 2) // 2
        x, y = y, (2 * x + 3 * y) % 5
    return off


_RHO = keccak_rho_offsets()
_RC800 = keccak_round_constants(22, 5)  # f[800]: 22 rounds, 32-bit lanes


def _rotl32(x, n: int):
    n %= 32
    return x if n == 0 else rotl(x, n)


def keccakf800_core(seeds, pos: int):
    """Keccak-f[800] PRF: absorb seed+pos+domain padding, permute, squeeze.

    State a[x][y], lane 32-bit.  Lanes (0,0)..(3,0) = seed limbs; lane
    (4,0) = pos; lane (0,1) = 0x1F domain/pad marker; lane (4,4) |= 0x80
    in the top bit (sponge-style closing pad).  One permutation, output =
    lanes (0,0),(1,0),(2,0),(3,0).
    """
    zeros = torch.zeros_like(seeds[..., 0])
    a = [[zeros for _ in range(5)] for _ in range(5)]
    for i in range(4):
        a[i][0] = seeds[..., i]
    a[4][0] = zeros + i32(pos & M32)
    a[0][1] = zeros + 0x1F
    a[4][4] = zeros + i32(0x80000000)

    for rc in _RC800:
        c = [a[x][0] ^ a[x][1] ^ a[x][2] ^ a[x][3] ^ a[x][4]
             for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rotl32(c[(x + 1) % 5], 1) for x in range(5)]
        a = [[a[x][y] ^ d[x] for y in range(5)] for x in range(5)]
        b = [[None] * 5 for _ in range(5)]
        for x in range(5):
            for y in range(5):
                b[y][(2 * x + 3 * y) % 5] = _rotl32(a[x][y], _RHO[x][y])
        a = [[b[x][y] ^ (~b[(x + 1) % 5][y] & b[(x + 2) % 5][y])
              for y in range(5)] for x in range(5)]
        a[0][0] = a[0][0] ^ i32(rc)
    return _stack([a[0][0], a[1][0], a[2][0], a[3][0]])


def keccakf_ref(state, w: int, n_rounds: int):
    """Scalar Keccak-f reference on a 5x5 int matrix (for KATs: w=64 with
    the SHA3 sponge validates the shared constant derivation)."""
    mask = (1 << w) - 1
    lane_log = w.bit_length() - 1
    rcs = keccak_round_constants(n_rounds, lane_log)

    def rot(v, n):
        n %= w
        return ((v << n) | (v >> (w - n))) & mask if n else v

    a = [row[:] for row in state]
    for rc in rcs:
        c = [a[x][0] ^ a[x][1] ^ a[x][2] ^ a[x][3] ^ a[x][4]
             for x in range(5)]
        d = [c[(x - 1) % 5] ^ rot(c[(x + 1) % 5], 1) for x in range(5)]
        for x in range(5):
            for y in range(5):
                a[x][y] ^= d[x]
        b = [[0] * 5 for _ in range(5)]
        for x in range(5):
            for y in range(5):
                b[y][(2 * x + 3 * y) % 5] = rot(a[x][y], _RHO[x][y])
        for x in range(5):
            for y in range(5):
                a[x][y] = b[x][y] ^ ((~b[(x + 1) % 5][y]) & b[(x + 2) % 5][y])
        a[0][0] ^= rc
    return a


def sha3_256_ref(msg: bytes) -> bytes:
    """Single-block SHA3-256 via keccakf_ref — the KAT anchor for the
    derived constants (validated against hashlib.sha3_256 in tests)."""
    rate = 136
    assert len(msg) <= rate - 2
    p = msg + b"\x06" + bytes(rate - len(msg) - 2) + b"\x80"
    st = [[0] * 5 for _ in range(5)]
    for i in range(rate // 8):
        st[i % 5][i // 5] ^= int.from_bytes(p[8 * i:8 * i + 8], "little")
    st = keccakf_ref(st, 64, 24)
    return b"".join(st[i % 5][i // 5].to_bytes(8, "little")
                    for i in range(4))


# ---------------------------------------------------------------------------
# HighwayHash-style proxy (op-mix model; constants NOT the published ones)
# ---------------------------------------------------------------------------

_HWY_INIT = tuple((0x9E3779B97F4A7C15 * (2 * i + 1)) & ((1 << 64) - 1)
                  for i in range(8))  # odd multiples of the golden ratio


def _mul32x32(a, b):
    """uint32 x uint32 -> (lo, hi) via 16-bit halves (no widening mul;
    the int32 products of two halves wrap to their uint32 bits)."""
    a_lo = a & 0xFFFF
    a_hi = shr(a, 16)
    b_lo = b & 0xFFFF
    b_hi = shr(b, 16)
    ll = a_lo * b_lo
    lh = a_lo * b_hi
    hl = a_hi * b_lo
    hh = a_hi * b_hi
    mid = shr(ll, 16) + (lh & 0xFFFF) + (hl & 0xFFFF)
    lo = (ll & 0xFFFF) | (mid << 16)
    hi = hh + shr(lh, 16) + shr(hl, 16) + shr(mid, 16)
    return lo, hi


def highway_proxy_core(seeds, pos: int):
    """HighwayHash-style update/finalize: 4 lanes of v0/v1/mul0/mul1,
    32x32->64 cross-multiplies and lane rotations per round, 4 update
    rounds + 4 permuted finalization rounds.  A cost model of the
    multiply-heavy hash family -- not the published HighwayHash."""
    z = seeds[..., 0]
    v0 = [_xor64(_const64(_HWY_INIT[i], z),
                 (seeds[..., i], seeds[..., (i + 1) % 4]))
          for i in range(4)]
    v1 = [_const64(_HWY_INIT[4 + i], z) for i in range(4)]
    mul0 = [_xor64(v0[i], _const64(_HWY_INIT[(i + 2) % 8], z))
            for i in range(4)]
    mul1 = [_xor64(v1[i], _const64(_HWY_INIT[(i + 5) % 8], z))
            for i in range(4)]
    packet = [_const64((pos << 1) ^ (i * 0x0123456789ABCDEF), z)
              for i in range(4)]

    def update(pkt):
        nonlocal v0, v1, mul0, mul1
        for i in range(4):
            v1[i] = _add64(v1[i], _add64(mul0[i], pkt[i]))
            mul0[i] = _xor64(mul0[i], _mul32x32(v1[i][0], v0[i][1]))
            v0[i] = _add64(v0[i], mul1[i])
            mul1[i] = _xor64(mul1[i], _mul32x32(v0[i][0], v1[i][1]))
        # cross-lane zipper-style mixing: rotate each 64-bit lane's halves
        v0 = [_add64(v0[i], (v1[(i + 1) % 4][1], v1[(i + 1) % 4][0]))
              for i in range(4)]
        v1 = [_add64(v1[i], (v0[(i + 2) % 4][1], v0[(i + 2) % 4][0]))
              for i in range(4)]

    update(packet)
    for r in range(3):
        update([_rotl64(packet[i], 17 * (r + 1)) for i in range(4)])
    for _ in range(4):  # permuted-state finalization rounds
        update([v0[(i + 2) % 4] for i in range(4)])
    out = [_add64(_add64(v0[i], v1[i]), _add64(mul0[i], mul1[i]))
           for i in range(4)]
    return _stack([out[0][0], out[0][1], out[1][0], out[1][1]])


# ---------------------------------------------------------------------------
# MD5 (the paper's md5 candidate) -- constants derived from sin(), RFC 1321
# ---------------------------------------------------------------------------

def _md5_k():
    """K[i] = floor(abs(sin(i+1)) * 2^32) — computed, not transcribed."""
    import math
    return [int(math.floor(abs(math.sin(i + 1)) * (1 << 32))) & 0xFFFFFFFF
            for i in range(64)]


_MD5_K = _md5_k()
_MD5_S = [7, 12, 17, 22] * 4 + [5, 9, 14, 20] * 4 \
    + [4, 11, 16, 23] * 4 + [6, 10, 15, 21] * 4
_MD5_IV = (0x67452301, 0xEFCDAB89, 0x98BADCFE, 0x10325476)


def md5_core(seeds, pos: int):
    """MD5(seed LE bytes || pos LE 4 bytes): one padded 64-byte block.

    The 20-byte message occupies m[0..4]; m[5] = 0x80 pad byte; m[14] =
    160 (bit length).  Output = the 128-bit digest as LE limbs (MD5 state
    words are little-endian, so A..D map to limbs directly).
    """
    zeros = torch.zeros_like(seeds[..., 0])
    m = [seeds[..., i] if i < 4 else zeros for i in range(16)]
    m[4] = zeros + i32(pos & M32)
    m[5] = zeros + 0x80
    m[14] = zeros + 160
    a, b, c, d = (zeros + i32(v) for v in _MD5_IV)
    for i in range(64):
        if i < 16:
            f = (b & c) | (~b & d)
            g = i
        elif i < 32:
            f = (d & b) | (~d & c)
            g = (5 * i + 1) % 16
        elif i < 48:
            f = b ^ c ^ d
            g = (3 * i + 5) % 16
        else:
            f = c ^ (b | ~d)
            g = (7 * i) % 16
        f = f + a + i32(_MD5_K[i]) + m[g]
        a, d, c = d, c, b
        b = b + _rotl32(f, _MD5_S[i])
    return _stack([a + i32(_MD5_IV[0]), b + i32(_MD5_IV[1]),
                   c + i32(_MD5_IV[2]), d + i32(_MD5_IV[3])])


# ---------------------------------------------------------------------------
# SHA-256 (the paper's sha256 candidate) -- constants derived exactly from
# the fractional parts of sqrt/cbrt of the first primes via integer roots
# ---------------------------------------------------------------------------

def _primes(n):
    ps, c = [], 2
    while len(ps) < n:
        if all(c % p for p in ps):
            ps.append(c)
        c += 1
    return ps


def _icbrt(n: int) -> int:
    x = 1 << ((n.bit_length() + 2) // 3 + 1)
    while True:
        y = (2 * x + n // (x * x)) // 3
        if y >= x:
            return x
        x = y


def _sha256_consts():
    import math
    h0 = [math.isqrt(p << 64) & 0xFFFFFFFF for p in _primes(8)]
    k = [_icbrt(p << 96) & 0xFFFFFFFF for p in _primes(64)]
    return h0, k


_SHA256_H0, _SHA256_K = _sha256_consts()


def _bswap32(x):
    return (shr(x, 24) | (x << 24) | (shr(x, 8) & 0xFF00)
            | ((x & 0xFF00) << 8))


def sha256_core(seeds, pos: int):
    """SHA-256(seed LE bytes || pos LE 4 bytes) truncated to 128 bits.

    Big-endian message words = byteswapped seed limbs; w[5] = 0x80000000
    pad; w[15] = 160 (bit length).  Output limbs = byteswapped H[0..3]
    (so limb bytes equal digest bytes 0..15).
    """
    zeros = torch.zeros_like(seeds[..., 0])
    w = [None] * 64
    for i in range(4):
        w[i] = _bswap32(seeds[..., i])
    w[4] = _bswap32(zeros + i32(pos & M32))
    w[5] = zeros + i32(0x80000000)
    for i in range(6, 15):
        w[i] = zeros
    w[15] = zeros + 160
    for t in range(16, 64):
        s0 = _rotl32(w[t - 15], 32 - 7) ^ _rotl32(w[t - 15], 32 - 18) \
            ^ shr(w[t - 15], 3)
        s1 = _rotl32(w[t - 2], 32 - 17) ^ _rotl32(w[t - 2], 32 - 19) \
            ^ shr(w[t - 2], 10)
        w[t] = w[t - 16] + s0 + w[t - 7] + s1
    a, b, c, d, e, f, g, h = (zeros + i32(v) for v in _SHA256_H0)
    for t in range(64):
        s1 = _rotl32(e, 32 - 6) ^ _rotl32(e, 32 - 11) ^ _rotl32(e, 32 - 25)
        ch = (e & f) ^ (~e & g)
        t1 = h + s1 + ch + i32(_SHA256_K[t]) + w[t]
        s0 = _rotl32(a, 32 - 2) ^ _rotl32(a, 32 - 13) ^ _rotl32(a, 32 - 22)
        maj = (a & b) ^ (a & c) ^ (b & c)
        t2 = s0 + maj
        h, g, f, e = g, f, e, d + t1
        d, c, b, a = c, b, a, t1 + t2
    out = [a + i32(_SHA256_H0[0]), b + i32(_SHA256_H0[1]),
           c + i32(_SHA256_H0[2]), d + i32(_SHA256_H0[3])]
    return _stack([_bswap32(x) for x in out])


HASH_ZOO = {
    "siphash24": make_siphash_core(2, 4),
    "siphash13": make_siphash_core(1, 3),
    "blake2s": blake2s_core,
    "keccakf800": keccakf800_core,
    "highway_proxy": highway_proxy_core,
    "md5": md5_core,
    "sha256": sha256_core,
}
