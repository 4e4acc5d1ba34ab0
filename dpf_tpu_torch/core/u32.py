"""uint32 arithmetic on int32 tensors.

No ``dpf_tpu`` file holds this: JAX has a real ``uint32``.  torch's
``uint32`` on the CPU has ``*`` and ``^`` but no ``+``, ``<<``, ``>>``
or comparisons (they raise ``NotImplementedError``), so the port keeps
every 32-bit limb in an **int32** tensor whose bits are read as uint32:

* ``+``, ``*``, ``^``, ``&``, ``|`` and ``<<`` wrap in two's complement
  and give the uint32 bits unchanged;
* a logical shift right is an arithmetic shift followed by a mask;
* unsigned ``<`` (the carry test of ``u128.add128``) flips the sign bit
  of both sides, then compares signed.

The same helpers run on CUDA tensors, where they are the plain versions
the kernels are held against.
"""

from __future__ import annotations

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
_SIGN = -(1 << 31)   # int32 with only the sign bit set


def i32(x: int) -> int:
    """A Python uint32 value as the int32 with the same bits."""
    x &= MASK32
    return x - (1 << 32) if x >= (1 << 31) else x


def shr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical shift right by a static ``s`` in [0, 32)."""
    if s == 0:
        return x
    return (x >> s) & ((1 << (32 - s)) - 1)


def rotl(x: torch.Tensor, b: int) -> torch.Tensor:
    """Rotate left by a static ``b`` in (0, 32)."""
    return (x << b) | shr(x, 32 - b)


def ult(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Unsigned ``a < b`` (bool tensor)."""
    return (a ^ _SIGN) < (b ^ _SIGN)


def from_u32(arr) -> torch.Tensor:
    """numpy uint32 (or int32) array -> int32 tensor with the same bits
    (a copy, so the result owns writable memory)."""
    a = np.ascontiguousarray(arr)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    elif a.dtype != np.int32:
        raise TypeError("expected a uint32 or int32 array, got %s" % a.dtype)
    return torch.from_numpy(a.copy())


def to_u32(t: torch.Tensor) -> np.ndarray:
    """int32 tensor (any device) -> numpy uint32 array with the same bits."""
    if t.dtype != torch.int32:
        raise TypeError("expected an int32 tensor, got %s" % t.dtype)
    return t.detach().cpu().contiguous().numpy().view(np.uint32)
