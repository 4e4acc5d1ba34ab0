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
  take the plain version.  ``a`` may have any strides: the paths hand
  in a contiguous plane of low limbs; the low limbs of ``[B, K, 4]``
  leaves (element stride 4) are taken too.

* ``dot_i32_mxu`` -- the port of ``dot_i32_mxu``: both operands split
  into four byte limbs, biased into int8, the ten limb-pair products
  with shift < 32 run by ``torch._int_mm`` (int8 x int8 -> int32) and
  recombined with rank-1 bias corrections.  The JAX package computes it
  with XLA outside any Pallas kernel, so a library product serves; it
  is not on the server's path, which takes K3.

``IMPLS`` names both (``"i32"``, the default, and ``"mxu"``) for
``dot(a, b, impl)`` and ``utils/bench.test_matmul_perf``.
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


def _pad_to(x: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    if x.shape == (rows, cols):
        return x.contiguous()
    out = torch.zeros((rows, cols), dtype=x.dtype, device=x.device)
    out[:x.shape[0], :x.shape[1]] = x
    return out


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def dot_i32_mxu(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact wrapping int32 product ``[B, K] x [K, E]`` through
    ``torch._int_mm`` on byte limbs.

    For unsigned limbs ``u = s + 128`` (``s`` the int8 limb),
    ``U_a @ U_b = S_a @ S_b + 128 rowsum(S_a) + 128 colsum(S_b)
    + 128^2 K``, all mod 2^32.  ``torch._int_mm`` on CUDA takes more
    than 16 rows and a K and E that are multiples of 8, so the operands
    are zero-padded to such a shape on every device (the padded product
    is exact, and zero rows and columns add nothing) and the result is
    sliced back."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError("dot_i32_mxu shapes %s x %s do not contract"
                         % (tuple(a.shape), tuple(b.shape)))
    bsz, e = a.shape[0], b.shape[1]
    m, k, n = (max(24, _round_up(bsz, 8)), _round_up(a.shape[1], 8),
               _round_up(e, 8))
    a = _pad_to(a.to(torch.int32), m, k)
    b = _pad_to(b.to(torch.int32), k, n)
    a_bytes = [(a >> (8 * s)) & 0xFF for s in range(4)]
    b_bytes = [(b >> (8 * s)) & 0xFF for s in range(4)]
    a_s = [(x - 128).to(torch.int8) for x in a_bytes]
    b_s = [(x - 128).to(torch.int8) for x in b_bytes]
    a_rows = [x.sum(dim=1, keepdim=True, dtype=torch.int32) - 128 * k
              for x in a_bytes]
    b_cols = [x.sum(dim=0, keepdim=True, dtype=torch.int32) - 128 * k
              for x in b_bytes]
    bias = (128 * 128 * k) & 0xFFFFFFFF
    bias = bias - (1 << 32) if bias >= 1 << 31 else bias
    out = torch.zeros((m, n), dtype=torch.int32, device=a.device)
    for i in range(4):
        for j in range(4 - i):
            term = (torch._int_mm(a_s[i], b_s[j]) + 128 * a_rows[i]
                    + 128 * b_cols[j] + bias)
            out = out + (term << (8 * (i + j)))
    return out[:bsz, :e]


IMPLS = {"i32": dot_i32, "mxu": dot_i32_mxu}

_DEFAULT_IMPL = "i32"


def available_impls() -> tuple:
    """The registered contraction backends, in registry order; each is
    an exact wrapping int32 product."""
    return tuple(IMPLS)


def register_impl(name: str, fn) -> None:
    """Add a backend ``fn(a, b)``, an exact wrapping int32 product."""
    IMPLS[name] = fn


def set_dot_impl(name: str) -> None:
    """Select the backend ``dot`` uses when given none."""
    global _DEFAULT_IMPL
    if name not in IMPLS:
        raise KeyError(name)
    _DEFAULT_IMPL = name


def default_impl() -> str:
    return _DEFAULT_IMPL


def dot(a: torch.Tensor, b: torch.Tensor, impl: str | None = None):
    return IMPLS[impl or _DEFAULT_IMPL](a, b)
