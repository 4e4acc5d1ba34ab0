"""Build and load the port's CUDA kernels (``csrc/*.cu``).

No ``dpf_tpu`` counterpart: the JAX package compiles its Pallas kernels
through XLA.  Here each source is compiled by ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface, loaded with
``ctypes``.  Nothing is compiled when a module is imported: the first
call that launches a kernel builds its library, or ``build()`` compiles
all of them at once, one ``nvcc`` process per source, all started
together.

Libraries land in ``dpf_tpu_torch/_build/`` (git-ignored), named by a
digest of the source, the shared headers and the flags, so an edited
source is rebuilt and an unchanged one is reused (``tune/compcache.py``
points ``BUILD_DIR`` elsewhere; ``build`` counts a present library as a
``CACHE_COUNTERS.compile_hits`` and a compiled one as a
``compile_misses``).  Every C entry returns
``cudaGetLastError()`` after its launch; ``launch`` raises on a non-zero
code.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_IP = ctypes.POINTER(ctypes.c_int)

# source stem -> (C entry -> argtypes, error-string entry)
SOURCES = {
    "aes_level": ({"aes_level_launch": [_P, _P, _P, _LL, _P, _LL, _LL, _I,
                                        _I, _P]},
                  "aes_level_error_string"),
    "subtree": ({"subtree_contract_launch": [_P] * 5 + [_I] * 3
                 + [_IP] * 2 + [_I] * 5 + [_P],
                 "subtree_contract_window_launch": [_P] * 5 + [_I] * 3
                 + [_IP] * 2 + [_I] * 4 + [_LL, _I, _P]},
                "subtree_contract_error_string"),
    "contract": ({"contract_i32_launch": [_P, _LL, _LL, _P, _P, _LL, _LL,
                                          _I, _I, _P]},
                 "contract_i32_error_string"),
    "sqrt_grid": ({"sqrt_grid_launch": [_P, _LL, _P, _P, _LL, _P, _P]
                   + [_I] * 5 + [_LL, _I, _I, _P]},
                  "sqrt_grid_error_string"),
    "contract_pkt": ({"contract_pkt_launch": [_P, _LL, _LL, _P, _LL, _P,
                                              _LL, _LL, _I, _I, _P]},
                     "contract_pkt_error_string"),
    "chacha_level": ({"chacha_level_launch": [_P, _P, _P, _LL, _P, _LL, _LL,
                                              _P]},
                     "chacha_level_error_string"),
    "prf_zoo": ({"prf_zoo_launch": [_I, _P, _P, _LL, ctypes.c_ulonglong,
                                    _P]},
                "prf_zoo_error_string"),
}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update((CSRC_DIR / (name + ".cu")).read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / ("%s-%s.so" % (name, h.hexdigest()[:16]))


def build(names=tuple(SOURCES)) -> dict:
    """Compile every named source that has no current library, all
    ``nvcc`` processes at once.  Returns ``{name: compiler output}`` for
    the sources compiled now (``-Xptxas -v``: registers, shared memory,
    spills); raises with the compiler's output if any build fails."""
    from ..utils.profiling import CACHE_COUNTERS
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    procs = {}
    for name in names:
        target = library_path(name)
        if target.exists():
            CACHE_COUNTERS.compile_hits += 1
            continue
        CACHE_COUNTERS.compile_misses += 1
        nvcc = nvcc or nvcc_path()
        tmp = target.with_name("%s.%d.tmp" % (target.name, os.getpid()))
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC_DIR), "-o", str(tmp),
               str(CSRC_DIR / (name + ".cu"))]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, target)
    logs, failed = {}, []
    for name, (proc, tmp, target) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(name)
        else:
            os.replace(tmp, target)
    if failed:
        raise RuntimeError("nvcc failed for %s:\n%s" % (
            ", ".join(failed), "\n".join(logs[n] for n in failed)))
    return logs


@functools.lru_cache(maxsize=None)
def library(name: str) -> ctypes.CDLL:
    """The loaded library of one source, built on first use."""
    build((name,))
    lib = ctypes.CDLL(str(library_path(name)))
    entries, err_name = SOURCES[name]
    for fn_name, argtypes in entries.items():
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    err = getattr(lib, err_name)
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return lib


def launch(name: str, entry: str, *args) -> None:
    """Call one C launch entry; raise if it reports a CUDA error."""
    lib = library(name)
    code = getattr(lib, entry)(*args)
    if code != 0:
        msg = getattr(lib, SOURCES[name][1])(code).decode()
        raise RuntimeError("%s failed: CUDA error %d (%s)" % (entry, code, msg))
