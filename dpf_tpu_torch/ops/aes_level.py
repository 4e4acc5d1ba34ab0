"""One GGM level of arity 2 or 4 under AES-128: plain version and K1.

Port of ``dpf_tpu/ops/aes_planes.py::aes_level_step_pallas``:

    child[a*j+b] = AES_{seed_j}(b) + (lsb(seed_j) ? cw2[b] : cw1[b])  mod 2^128

for ``b < a``: seeds ``[B, w, 4]``, this level's codewords
``cw1_lvl``/``cw2_lvl`` ``[B, a, 4]`` (branch, limb) -> children
``[B, a*w, 4]`` node-major, all int32 limb tensors read as uint32.
Arity 2 serves the binary tree and the binary base level of a radix-4
tree at odd depth, arity 4 the radix-4 levels.  The TPU kernel
bit-slices 32 keys into planes; the card's kernel
(``csrc/aes_level.cu``) runs one thread per node with shared-memory
T-tables and gives the same bits.

* ``aes_level_step_plain`` -- the plain version (gather-S-box AES,
  ``core/prf.py``), used for CPU tensors and as the kernel's oracle.
* ``aes_level_step`` -- the wrapper: CUDA tensors launch K1, CPU
  tensors take the plain version.  It counts arity-2 launches in
  ``launches`` and arity-4 launches in ``launches_a4``, both forms.

``low32=True`` is the form of the last level of a frontier group: only
limb 0 of each child, ``[B, a*w]`` contiguous, which is all the
contraction (K3) reads.
"""

from __future__ import annotations

import torch

from ..core.expand import _level_step_multi
from ..core.prf_ref import PRF_AES128
from . import cuda_build


def aes_level_step_plain(seeds: torch.Tensor, cw1_lvl: torch.Tensor,
                         cw2_lvl: torch.Tensor, arity: int = 2,
                         low32: bool = False) -> torch.Tensor:
    """[B, w, 4] seeds, [B, a, 4] codewords -> [B, a*w, 4] children, or
    with ``low32`` their limb 0, [B, a*w] contiguous."""
    out = _level_step_multi(seeds, cw1_lvl, cw2_lvl, PRF_AES128, arity)
    return out[..., 0].contiguous() if low32 else out


def check_level_operands(seeds, cw1_lvl, cw2_lvl, arity,
                         name="aes_level_step") -> None:
    """The layout a level-step kernel takes, checked on every device:
    seeds [B, w, 4] contiguous, codewords [B, arity, 4] with contiguous
    (branch, limb) axes and equal strides."""
    if arity not in (2, 4):
        raise ValueError("%s: arity must be 2 or 4, got %r" % (name, arity))
    for t in (seeds, cw1_lvl, cw2_lvl):
        if t.dtype != torch.int32:
            raise TypeError("%s takes int32 limb tensors" % name)
        if t.device != seeds.device:
            raise ValueError("%s operands on different devices" % name)
    if seeds.dim() != 3 or seeds.shape[2] != 4:
        raise ValueError("seeds must be [B, w, 4], got %s"
                         % (tuple(seeds.shape),))
    for cw in (cw1_lvl, cw2_lvl):
        if tuple(cw.shape) != (seeds.shape[0], arity, 4):
            raise ValueError("level codewords must be [B, %d, 4], got %s"
                             % (arity, tuple(cw.shape)))
    if not seeds.is_contiguous():
        raise ValueError("%s: seeds must be contiguous" % name)
    if cw1_lvl.stride() != cw2_lvl.stride() or cw1_lvl.stride()[1:] != (4, 1):
        raise ValueError("%s: codewords need contiguous (branch, limb) axes "
                         "and equal strides" % name)


def aes_level_step(seeds: torch.Tensor, cw1_lvl: torch.Tensor,
                   cw2_lvl: torch.Tensor, arity: int = 2,
                   low32: bool = False) -> torch.Tensor:
    """One AES-128 GGM level; K1 on CUDA tensors, plain on CPU ones.
    ``low32``: return only limb 0 of each child, [B, a*w]."""
    check_level_operands(seeds, cw1_lvl, cw2_lvl, arity)
    if seeds.device.type == "cpu":
        return aes_level_step_plain(seeds, cw1_lvl, cw2_lvl, arity, low32)
    if seeds.device.type != "cuda":
        raise ValueError("aes_level_step: unsupported device %s"
                         % seeds.device)
    bsz, w, _ = seeds.shape
    shape = (bsz, arity * w) if low32 else (bsz, arity * w, 4)
    out = torch.empty(shape, dtype=torch.int32, device=seeds.device)
    with torch.cuda.device(seeds.device):
        cuda_build.launch(
            "aes_level", "aes_level_launch", seeds.data_ptr(),
            cw1_lvl.data_ptr(), cw2_lvl.data_ptr(), cw1_lvl.stride(0),
            out.data_ptr(), bsz, w, arity, int(low32),
            torch.cuda.current_stream().cuda_stream)
    if arity == 4:
        aes_level_step.launches_a4 += 1
    else:
        aes_level_step.launches += 1
    return out


aes_level_step.launches = 0      # arity-2 launches
aes_level_step.launches_a4 = 0   # arity-4 launches
