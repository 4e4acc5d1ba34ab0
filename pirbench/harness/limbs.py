"""128-bit values as ``[..., 4]`` int64 tensors of uint32 limbs (limb 0
least significant), on any device.  Holding each 32-bit limb in an
int64 keeps every sum, shift and index exact without unsigned types."""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF


def add128(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a + b) mod 2^128."""
    out = []
    carry = 0
    for i in range(4):
        s = a[..., i] + b[..., i] + carry
        carry = s >> 32
        out.append(s & MASK32)
    return torch.stack(out, dim=-1)


def neg128(a: torch.Tensor) -> torch.Tensor:
    """(-a) mod 2^128."""
    one = torch.zeros_like(a)
    one[..., 0] = 1
    return add128(a ^ MASK32, one)


def sub128(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a - b) mod 2^128."""
    return add128(a, neg128(b))


def bswap32(x: torch.Tensor) -> torch.Tensor:
    """Byte order of each 32-bit word reversed."""
    return (((x & 0xFF) << 24) | ((x & 0xFF00) << 8)
            | ((x >> 8) & 0xFF00) | ((x >> 24) & 0xFF))
