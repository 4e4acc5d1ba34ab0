"""Host-side one-hot DPF evaluation (the oracle behind ``DPF.eval_cpu``).

Port of ``dpf_tpu/core/evalref.py``: expand one key over all N leaves
level by level on the CPU, one PRF position at a time, and truncate each
128-bit leaf share to int32.  Breadth-first position p holds natural
index bit_reverse(p).
"""

from __future__ import annotations

import numpy as np
import torch

from . import u128
from .keygen import FlatKey
from .prf import prf_v
from .u32 import from_u32


def expand_bfs(key: FlatKey, prf_method: int) -> torch.Tensor:
    """Expand one key to all leaves in BFS (bit-reversed) order.

    Returns an [n, 4] int32 limb tensor (CPU) of 128-bit output shares.
    """
    seeds = from_u32(u128.int_to_limbs(key.last_key)[None, :])  # [1, 4]
    cw1 = from_u32(key.cw1)
    cw2 = from_u32(key.cw2)
    for i in range(key.depth - 1, -1, -1):
        sel = (seeds[:, 0] & 1).bool()[:, None]   # codeword row per node
        children = []
        for b in range(2):
            cw = torch.where(sel, cw2[2 * i + b], cw1[2 * i + b])
            children.append(u128.add128(prf_v(prf_method, seeds, b), cw))
        # interleave: new[2j+b] = children[b][j]
        seeds = torch.stack(children, dim=1).reshape(-1, 4)
    return seeds


def eval_one_hot_i32(key: FlatKey, prf_method: int) -> np.ndarray:
    """Server share of the one-hot vector, natural order, low 32 bits
    (the reference's ``eval_cpu`` output, ``dpf_wrapper.cu:70-84``)."""
    lo = expand_bfs(key, prf_method)[:, 0].numpy()
    return lo[u128.bit_reverse_indices(1 << key.depth)]
