"""Capability probes the tuner reads (port of the tuning part of
``dpf_tpu/utils/compat.py``).

``has_pallas_sqrt_kernel`` keeps ``dpf_tpu``'s name: there it says
whether the Pallas sqrt-N grid kernel can run (a TPU backend); here
whether K4, the sqrt-N grid kernel (``ops/sqrt_grid.py``), can run on
the given device: a CUDA device that is present and, for a PRF id and
grid, ``sqrt_grid_unsupported`` with nothing to object.  It never
initializes CUDA when the device is the CPU.  ``has_cpu_multiprocess``
says whether CPU processes can form a process group here.
``device_memory_stats`` comes with the port's planning item.
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


def has_cpu_multiprocess() -> bool:
    """True when processes on this machine can join a gloo process group
    (``torch.distributed`` built with gloo): the multi-process mesh of
    ``parallel/multihost.py`` on CPU devices, or ranks sharing a card."""
    import torch.distributed as dist
    return dist.is_available() and dist.is_gloo_available()
