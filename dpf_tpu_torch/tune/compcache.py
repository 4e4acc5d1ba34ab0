"""The build cache of the CUDA kernels (port of ``dpf_tpu/tune/
compcache.py``'s role).

``dpf_tpu`` points JAX's persistent compilation cache at a directory so
that a second process deserializes its programs instead of compiling
them.  The port's programs are the kernel libraries that
``ops/cuda_build.py`` compiles with ``nvcc``: each is named by a digest
of its source, the shared headers and the flags, so a library present in
the build directory is reused by every later process and an edited
source is rebuilt.  ``enable(dir)`` points the build at another
directory (default: ``dpf_tpu_torch/_build/``); ``cuda_build.build``
counts a present library in ``CACHE_COUNTERS.compile_hits`` and a
compiled one in ``compile_misses``.
"""

from __future__ import annotations

from pathlib import Path

from ..ops import cuda_build


def default_dir() -> str:
    """``dpf_tpu_torch/_build/``."""
    return str(cuda_build.PACKAGE_DIR / "_build")


def enable(cache_dir: str | None = None) -> str:
    """Build and load the kernel libraries from ``cache_dir`` (None =
    ``default_dir()``); returns the directory in use.  Libraries loaded
    before the call stay loaded."""
    d = Path(cache_dir if cache_dir is not None else default_dir())
    d.mkdir(parents=True, exist_ok=True)
    cuda_build.BUILD_DIR = d.resolve()
    return str(cuda_build.BUILD_DIR)


def enabled_dir() -> str:
    """The directory the kernel libraries are built into."""
    return str(cuda_build.BUILD_DIR)
