"""Capability probes the tuner reads (port of the tuning part of
``dpf_tpu/utils/compat.py``).

``has_pallas_sqrt_kernel`` keeps ``dpf_tpu``'s name: there it says
whether the Pallas sqrt-N grid kernel can run (a TPU backend); here
whether K4, the sqrt-N grid kernel (``ops/sqrt_grid.py``), can run on
the given device: a CUDA device that is present and, for a PRF id and
grid, ``sqrt_grid_unsupported`` with nothing to object.  It never
initializes CUDA when the device is the CPU.  ``has_cpu_multiprocess``
says whether CPU processes can form a process group here.
``device_memory_stats`` is the card's memory (``torch.cuda.mem_get_info``
and the caching allocator's counters) that ``plan/capacity`` plans
around; the CPU has no such ceiling.
"""

from __future__ import annotations


def has_pallas_sqrt_kernel(device=None, prf_method: int | None = None,
                           r: int = 4, row0: int = 0) -> bool:
    """True when K4 can run on ``device`` (None = the card): a CUDA
    device with CUDA available, and when ``prf_method`` is given, a grid
    of ``r`` rows from ``row0`` that the kernel takes."""
    import torch
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return False
    if prf_method is None:
        return True
    from ..ops.sqrt_grid import sqrt_grid_unsupported
    return sqrt_grid_unsupported(prf_method, r, row0) is None


def device_memory_stats(device=None) -> dict | None:
    """The device's memory as a plain dict, or None on a CPU device.

    On a CUDA device (None = the card): ``bytes_limit`` is the card's
    total memory and ``bytes_free`` its free memory
    (``torch.cuda.mem_get_info``), ``bytes_in_use`` the tensors' bytes
    (``memory_allocated``) and ``bytes_reserved`` the caching allocator's
    (``memory_reserved``).  ``plan/capacity.detect_hbm_budget`` seeds a
    host's budget from ``bytes_limit``.  A failure on a CUDA device
    raises (no card, a lost context): only the CPU answers None."""
    import torch
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        return None
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' "
                           "for a device without a memory ceiling")
    free, total = torch.cuda.mem_get_info(dev)
    return {"bytes_limit": int(total), "bytes_free": int(free),
            "bytes_in_use": int(torch.cuda.memory_allocated(dev)),
            "bytes_reserved": int(torch.cuda.memory_reserved(dev))}


def has_cpu_multiprocess() -> bool:
    """True when processes on this machine can join a gloo process group
    (``torch.distributed`` built with gloo): the multi-process mesh of
    ``parallel/multihost.py`` on CPU devices, or ranks sharing a card."""
    import torch.distributed as dist
    return dist.is_available() and dist.is_gloo_available()
