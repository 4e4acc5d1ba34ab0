"""Carry server state across from the JAX package as numpy arrays.

``state_from_numpy(table, keys)`` takes the state ``dpf_tpu`` serves
from -- the ``[N, E]`` int32 table and ``[B, 524]`` int32 wire keys,
binary or radix-4 -- and returns the port's tensors on the device: the
table permuted into the tree's leaf order (bit-reversed, or
digit-reversed for radix-4 keys) and the packed codewords and start
seeds, ready for ``core.expand.expand_and_contract`` or
``core.radix4.expand_and_contract_mixed``.  Both packages then compute
on identical state.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .api import resolve_device
from .core import expand, keygen, radix4
from .core.u32 import from_u32


class DeviceState(NamedTuple):
    table_perm: torch.Tensor   # [N, E] int32, rows in leaf order
    cw1: torch.Tensor          # [B, 64, 4] int32 limbs
    cw2: torch.Tensor          # [B, 64, 4] int32 limbs
    last: torch.Tensor         # [B, 4] int32 start seeds
    radix: int = 2             # 4 for radix-4 keys

    @property
    def depth(self) -> int:
        return self.table_perm.shape[0].bit_length() - 1


def state_from_numpy(table: np.ndarray, keys: np.ndarray,
                     device=None) -> DeviceState:
    """[N, E] int32 table + [B, 524] int32 wire keys -> ``DeviceState``
    on ``device`` (None = CUDA)."""
    dev = resolve_device(device)
    tbl = np.asarray(table)
    if tbl.dtype != np.int32 or tbl.ndim != 2:
        raise ValueError("table must be a 2D int32 array")
    n = tbl.shape[0]
    if n < 2 or n & (n - 1):
        raise ValueError("table rows (%d) must be a power of two" % n)
    wire = keygen.stack_wire_keys(np.asarray(keys))
    radix = 4 if radix4.is_mixed_key(wire[0]) else 2
    if radix == 4:
        pk = radix4.decode_mixed_keys_batched(wire)
        rows = tbl[radix4.mixed_reverse_indices(radix4.arities(n))]
    else:
        pk = keygen.decode_keys_batched(wire)
        rows = expand.permute_table(tbl)
    if pk.n != n:
        raise ValueError("keys for n=%d, table has %d rows" % (pk.n, n))
    perm = torch.from_numpy(np.ascontiguousarray(rows)).to(dev)
    return DeviceState(perm, from_u32(pk.cw1).to(dev),
                       from_u32(pk.cw2).to(dev), from_u32(pk.last).to(dev),
                       radix)
