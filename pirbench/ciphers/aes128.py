"""AES-128 (FIPS-197) as the GGM tree's PRF, in plain PyTorch.

The seed (128 bits, four uint32 limbs, limb 0 least significant) is the
key as its 16 little-endian bytes; the plaintext is the position (0 or
1) as 16 little-endian bytes; the ciphertext is read back little-endian
into limbs.  This is the PRF the program states for ``prf=3``.  Written
byte by byte from the standard (S-box from the field inverse and the
affine map, ShiftRows, MixColumns by xtime, the key schedule with its
round constants), vectorized over rows; it shares no code with the
program.
"""

from __future__ import annotations

import functools

import torch


def _sbox() -> list:
    """The AES S-box: the inverse in GF(2^8) mod x^8+x^4+x^3+x+1, then
    the affine map with constant 0x63."""
    def mul(a, b):
        r = 0
        while b:
            if b & 1:
                r ^= a
            a = ((a << 1) ^ (0x11B if a & 0x80 else 0)) & 0x1FF
            b >>= 1
        return r & 0xFF

    inv = [0] * 256
    for a in range(1, 256):
        for b in range(1, 256):
            if mul(a, b) == 1:
                inv[a] = b
                break
    out = []
    for a in range(256):
        x = inv[a]
        y = x
        for s in range(1, 5):
            y ^= ((x << s) | (x >> (8 - s))) & 0xFF
        out.append(y ^ 0x63)
    return out


SBOX = _sbox()
RCON = (0x01, 0x02, 0x04, 0x08, 0x10, 0x20, 0x40, 0x80, 0x1B, 0x36)
# state byte 4c + r is row r of column c; ShiftRows moves row r left by r
SHIFT_ROWS = [4 * ((c + r) % 4) + r for c in range(4) for r in range(4)]


@functools.lru_cache(maxsize=None)
def _tables(device: str):
    dev = torch.device(device)
    return (torch.tensor(SBOX, dtype=torch.int64, device=dev),
            torch.tensor(SHIFT_ROWS, dtype=torch.int64, device=dev))


def _xtime(x: torch.Tensor) -> torch.Tensor:
    return ((x << 1) & 0xFF) ^ (((x >> 7) & 1) * 0x1B)


def _bytes_of(limbs: torch.Tensor) -> torch.Tensor:
    """[M, 4] uint32 limbs -> [M, 16] little-endian bytes."""
    sh = torch.arange(0, 32, 8, device=limbs.device)
    return ((limbs[:, :, None] >> sh) & 0xFF).reshape(limbs.shape[0], 16)


def _limbs_of(b: torch.Tensor) -> torch.Tensor:
    """[M, 16] bytes -> [M, 4] little-endian uint32 limbs."""
    b = b.reshape(b.shape[0], 4, 4)
    return b[:, :, 0] | (b[:, :, 1] << 8) | (b[:, :, 2] << 16) | (b[:, :, 3] << 24)


def encrypt(key: torch.Tensor, block: torch.Tensor) -> torch.Tensor:
    """AES-128 of [M, 16] plaintext bytes under [M, 16] key bytes; the key
    schedule runs round by round beside the block, so no more than one
    round key is held at a time."""
    sbox, shift = _tables(str(block.device))
    rk = key
    s = block ^ rk
    for r in range(1, 11):
        t = sbox[rk[:, [13, 14, 15, 12]]]           # SubWord(RotWord(w3))
        t[:, 0] ^= RCON[r - 1]
        words = [rk[:, 0:4] ^ t]
        for j in range(1, 4):
            words.append(rk[:, 4 * j:4 * j + 4] ^ words[-1])
        rk = torch.cat(words, dim=1)
        s = sbox[s][:, shift]
        if r < 10:
            a = s.reshape(-1, 4, 4)                   # [M, column, row]
            t = a[:, :, 0] ^ a[:, :, 1] ^ a[:, :, 2] ^ a[:, :, 3]
            nxt = torch.roll(a, shifts=-1, dims=2)
            s = (a ^ t[:, :, None] ^ _xtime(a ^ nxt)).reshape(-1, 16)
        s = s ^ rk
    return s


def prf_pair(seeds: torch.Tensor):
    """The outputs at positions 0 and 1 of the same seeds."""
    m = seeds.shape[0]
    key = _bytes_of(seeds)
    block = torch.zeros((2 * m, 16), dtype=torch.int64, device=seeds.device)
    block[m:, 0] = 1
    out = _limbs_of(encrypt(torch.cat([key, key]), block))
    return out[:m], out[m:]
