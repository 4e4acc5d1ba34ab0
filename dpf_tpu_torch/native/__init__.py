"""ctypes loader of the port's host C++ library: keygen and a CPU oracle.

Port of ``dpf_tpu/native/__init__.py``.  ``src/`` holds a copy of
``dpf_tpu/native/src`` (the C++ binary-tree generator, full expansion
and expand + contract over a table, with a SHAKE-256 DRBG byte-identical
to ``core/keygen.py``'s), so keys from ``gen`` equal the Python
generators' for the same seed.  Only the binary tree is native; the
radix-4 and sqrt-N generators stay vectorized PyTorch.

The library is built with ``g++`` at first use into
``dpf_tpu_torch/_build/``, named by a digest of the sources, the flags
and the host CPU (the build is ``-march=native``, so a library built on
one machine is never loaded on another).  Nothing is built when the
module is imported.  If ``g++`` is missing or fails, ``available()`` is
False and ``build_error()`` returns the compiler's output; the callers
then use the Python generators.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import platform
import subprocess
from pathlib import Path

import numpy as np

SRC_DIR = Path(__file__).resolve().parent / "src"
BUILD_DIR = SRC_DIR.parent.parent / "_build"
FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
         "-pthread")
KEY_WORDS = 524

_I32P = ctypes.POINTER(ctypes.c_int32)


def _host_cpu() -> bytes:
    """The CPU's model and feature flags, which ``-march=native`` reads."""
    try:
        lines = Path("/proc/cpuinfo").read_text().splitlines()
    except OSError:
        return platform.processor().encode()
    return "\n".join(ln for ln in lines if ln.startswith(
        ("model name", "flags")))[:4096].encode()


def library_path() -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode() + platform.machine().encode()
                       + _host_cpu())
    for src in sorted(SRC_DIR.iterdir()):
        h.update(src.name.encode() + src.read_bytes())
    return BUILD_DIR / ("dpftpu-%s.so" % h.hexdigest()[:16])


def _build(target: Path) -> str | None:
    """Compile the library to ``target``; retry without ``-march=native``
    if that fails.  Returns None on success, else the compiler's
    output of each attempt."""
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = target.with_name("%s.%d.tmp" % (target.name, os.getpid()))
    errors = []
    for flags in (FLAGS, tuple(f for f in FLAGS if f != "-march=native")):
        cmd = ["g++", *flags, "-o", str(tmp), str(SRC_DIR / "dpftpu.cpp")]
        try:
            res = subprocess.run(cmd, capture_output=True, text=True)
        except OSError as exc:
            return "%s: %s" % (" ".join(cmd), exc)
        if res.returncode == 0:
            os.replace(tmp, target)
            return None
        errors.append("%s\n%s" % (" ".join(cmd), res.stderr))
    return "\n".join(errors)


@functools.lru_cache(maxsize=None)
def _load() -> tuple:
    """(library or None, build error or None), built on first use."""
    target = library_path()
    if not target.exists():
        err = _build(target)
        if err is not None:
            return None, err
    lib = ctypes.CDLL(str(target))
    lib.dpftpu_gen.argtypes = [ctypes.c_uint64, ctypes.c_uint64,
                               ctypes.c_char_p, ctypes.c_uint64,
                               ctypes.c_int, _I32P, _I32P]
    lib.dpftpu_eval_expand.argtypes = [_I32P, ctypes.c_int, _I32P]
    lib.dpftpu_eval_contract.argtypes = [
        _I32P, ctypes.c_uint64, ctypes.c_int, _I32P, ctypes.c_uint64,
        ctypes.c_int, _I32P]
    for fn in (lib.dpftpu_gen, lib.dpftpu_eval_expand,
               lib.dpftpu_eval_contract):
        fn.restype = ctypes.c_int
    return lib, None


def available() -> bool:
    """True when the library is built (building it now if needed)."""
    return _load()[0] is not None


def build_error() -> str | None:
    """The compiler's output when the build failed, else None."""
    return _load()[1]


def _lib():
    lib, err = _load()
    if lib is None:
        raise RuntimeError("the native library did not build:\n%s" % err)
    return lib


def _ptr(arr: np.ndarray):
    return arr.ctypes.data_as(_I32P)


def gen(alpha: int, n: int, seed: bytes, prf_method: int):
    """Binary-tree keygen -> two ``[524]`` int32 arrays, byte-identical
    to ``core.keygen.generate_keys(alpha, n, seed, prf_method)``."""
    seed = bytes(seed)
    k0 = np.zeros(KEY_WORDS, dtype=np.int32)
    k1 = np.zeros(KEY_WORDS, dtype=np.int32)
    rc = _lib().dpftpu_gen(alpha, n, seed, len(seed), prf_method,
                           _ptr(k0), _ptr(k1))
    if rc != 0:
        raise ValueError("native keygen failed (rc=%d): alpha %d, n %d"
                         % (rc, alpha, n))
    return k0, k1


def _key_words(key) -> np.ndarray:
    if hasattr(key, "detach"):
        key = key.detach().cpu().numpy()
    arr = np.ascontiguousarray(np.asarray(key, dtype=np.int32).reshape(-1))
    if arr.shape[0] != KEY_WORDS:
        raise ValueError("DPF key must be %d int32 words, got %d"
                         % (KEY_WORDS, arr.shape[0]))
    return arr


def eval_expand(key, prf_method: int) -> np.ndarray:
    """One binary key's full expansion -> ``[n]`` int32 low-32 shares in
    natural index order."""
    arr = _key_words(key)
    slots = arr.view(np.uint32)
    # n sits in wire slot 130, limbs 0 and 1: words 520 and 521
    n = int(slots[520]) | (int(slots[521]) << 32)
    out = np.zeros(n, dtype=np.int32)
    rc = _lib().dpftpu_eval_expand(_ptr(arr), prf_method, _ptr(out))
    if rc != 0:
        raise ValueError("native eval failed (rc=%d)" % rc)
    return out


def eval_contract(keys, prf_method: int, table,
                  n_threads: int = 1) -> np.ndarray:
    """Batched expand + contract on the CPU: binary keys ``[B, 524]``
    int32, table ``[n, E]`` int32 in natural row order -> ``[B, E]``
    int32 shares."""
    kb = np.ascontiguousarray(np.stack([_key_words(k) for k in keys]))
    tbl = np.ascontiguousarray(np.asarray(table, dtype=np.int32))
    slots = kb.view(np.uint32)
    n = slots[:, 520].astype(np.int64) | (slots[:, 521].astype(np.int64)
                                          << 32)
    if (n != tbl.shape[0]).any():
        raise ValueError("keys for n=%s but the table has %d rows"
                         % (sorted(set(n.tolist())), tbl.shape[0]))
    out = np.zeros((kb.shape[0], tbl.shape[1]), dtype=np.int32)
    rc = _lib().dpftpu_eval_contract(_ptr(kb), kb.shape[0], prf_method,
                                     _ptr(tbl), tbl.shape[1], n_threads,
                                     _ptr(out))
    if rc != 0:
        raise ValueError("native eval_contract failed (rc=%d)" % rc)
    return out
