"""ChaCha20 with 12 rounds as the GGM tree's PRF, in plain PyTorch.

The state is the constant "expand 32-byte k" in words 0..3 (each four
ASCII bytes read big-endian, as the upstream GPU-DPF framework writes
them: 0x65787061 for "expa"), the seed in words 4..7 most significant
word first, zeros in 8..11, the 64-bit position in words 12..13 (high
word first) and zeros in 14..15; after six double rounds the input is
added back and words 4..7 are the output, most significant first.  This is the PRF the program states for
``prf=2`` (the reference framework's "ChaCha20" iterates 12 rounds).
Written from the specification, vectorized over rows with the column and
diagonal rounds on the state's four rows at once; it shares no code
with the program.
"""

from __future__ import annotations

import torch

SIGMA = tuple(int.from_bytes(b"expand 32-byte k"[i:i + 4], "big")
              for i in range(0, 16, 4))
MASK32 = 0xFFFFFFFF


def _rotl(x: torch.Tensor, b: int) -> torch.Tensor:
    return ((x << b) & MASK32) | (x >> (32 - b))


def _quarter(a, b, c, d):
    a = (a + b) & MASK32
    d = _rotl(d ^ a, 16)
    c = (c + d) & MASK32
    b = _rotl(b ^ c, 12)
    a = (a + b) & MASK32
    d = _rotl(d ^ a, 8)
    c = (c + d) & MASK32
    b = _rotl(b ^ c, 7)
    return a, b, c, d


def _core(seeds: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """[M, 4] seeds, [M] positions -> [M, 4] outputs."""
    m = seeds.shape[0]
    x = torch.zeros((4, 4, m), dtype=torch.int64, device=seeds.device)
    for i, s in enumerate(SIGMA):
        x[0, i] = s
    for i in range(4):
        x[1, i] = seeds[:, 3 - i]
    x[3, 1] = pos
    a, b, c, d = x[0], x[1], x[2], x[3]
    for _ in range(6):
        a, b, c, d = _quarter(a, b, c, d)          # column round
        b, c, d = (torch.roll(b, -1, 0), torch.roll(c, -2, 0),
                   torch.roll(d, -3, 0))
        a, b, c, d = _quarter(a, b, c, d)          # diagonal round
        b, c, d = (torch.roll(b, 1, 0), torch.roll(c, 2, 0),
                   torch.roll(d, 3, 0))
    out = (b + x[1]) & MASK32                       # words 4..7
    return torch.stack([out[3], out[2], out[1], out[0]], dim=1)


def prf_pair(seeds: torch.Tensor):
    """The outputs at positions 0 and 1 of the same seeds."""
    m = seeds.shape[0]
    pos = torch.zeros(2 * m, dtype=torch.int64, device=seeds.device)
    pos[m:] = 1
    out = _core(torch.cat([seeds, seeds]), pos)
    return out[:m], out[m:]
