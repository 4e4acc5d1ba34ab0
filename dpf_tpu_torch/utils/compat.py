"""Capability probes the tuner reads (port of the tuning part of
``dpf_tpu/utils/compat.py``).

``has_pallas_sqrt_kernel`` keeps ``dpf_tpu``'s name: there it says
whether the Pallas sqrt-N grid kernel can run (a TPU backend); here
whether K4, the sqrt-N grid kernel (``ops/sqrt_grid.py``), can run on
the given device: a CUDA device that is present and, for a PRF id and
grid, ``sqrt_grid_unsupported`` with nothing to object.  It never
initializes CUDA when the device is the CPU.  ``device_memory_stats``
and ``has_cpu_multiprocess`` come with the port's planning and
multi-GPU items.
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
