"""Exact mod-2^32 contraction ``[B, K] x [K, E] -> [B, E]`` (int32).

Port of ``dpf_tpu/ops/matmul128.py::dot_i32``.  The server's share is
``out[b, e] = sum_j leaf32[b, j] * table[j, e] (mod 2^32)``: mod 2^32
the 128-bit leaf times the entry reduces to the leaf's low limb times
the entry, so the contraction is a wrapping int32 product.

* ``dot_i32_plain`` -- the plain version.  On the CPU torch's int32
  ``@`` wraps exactly.  CUDA has no int32 matmul (``addmm_cuda`` is not
  implemented for Int), so on the card the plain version sums wrapped
  int32 products over slices of k in int64 and keeps the low 32 bits.
* ``dot_i32`` -- the wrapper of kernel K3 ``contract_i32``
  (``csrc/contract.cu``): CUDA tensors launch the kernel, CPU tensors
  take the plain version.  ``a`` may have any strides: the AES path
  hands in a contiguous plane of low limbs, DUMMY's binary path the
  low limbs of ``[B, K, 4]`` leaves (element stride 4).

The byte-limb ``torch._int_mm`` decomposition of ``dot_i32_mxu`` is not
ported: ``chip_smoke.py`` times it as the library yardstick only.
"""

from __future__ import annotations

import torch

from . import cuda_build


def _dot_i32_sliced(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Device-generic plain product: wrapped int32 products summed in
    int64 over slices of k (at most ~16M products live at once)."""
    bsz, k = a.shape
    e = b.shape[1]
    out = torch.zeros((bsz, e), dtype=torch.int64, device=a.device)
    step = max(1, (1 << 24) // max(1, bsz * e))
    for k0 in range(0, k, step):
        prod = a[:, k0:k0 + step, None] * b[None, k0:k0 + step, :]
        out += prod.sum(dim=1, dtype=torch.int64)
    return out.to(torch.int32)


def dot_i32_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[B, K] x [K, E] -> [B, E], wrapping int32 (plain PyTorch)."""
    if a.device.type == "cpu":
        return a @ b
    return _dot_i32_sliced(a, b)


def _check(a: torch.Tensor, b: torch.Tensor) -> None:
    if a.dtype != torch.int32 or b.dtype != torch.int32:
        raise TypeError("dot_i32 takes int32 operands, got %s, %s"
                        % (a.dtype, b.dtype))
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError("dot_i32 shapes %s x %s do not contract"
                         % (tuple(a.shape), tuple(b.shape)))
    if a.device != b.device:
        raise ValueError("dot_i32 operands on %s and %s"
                         % (a.device, b.device))
    # the kernel's layout, checked on every device so CPU runs catch it
    if not b.is_contiguous():
        raise ValueError("dot_i32: the table operand must be contiguous")


def dot_i32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact wrapping int32 product ``[B, K] x [K, E] -> [B, E]``.

    CPU tensors take ``dot_i32_plain``; CUDA tensors launch K3 (``a`` may
    be strided, ``b`` must be contiguous)."""
    _check(a, b)
    if a.device.type == "cpu":
        return dot_i32_plain(a, b)
    if a.device.type != "cuda":
        raise ValueError("dot_i32: unsupported device %s" % a.device)
    bsz, k = a.shape
    e = b.shape[1]
    out = torch.zeros((bsz, e), dtype=torch.int32, device=a.device)
    with torch.cuda.device(a.device):
        sms = torch.cuda.get_device_properties(a.device).multi_processor_count
        cuda_build.launch(
            "contract", "contract_i32_launch", a.data_ptr(), a.stride(0),
            a.stride(1), b.data_ptr(), out.data_ptr(), bsz, k, e, sms,
            torch.cuda.current_stream().cuda_stream)
    dot_i32.launches += 1
    return out


dot_i32.launches = 0
