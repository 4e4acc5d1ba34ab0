"""Benchmark helpers: the printed-dict throughput protocol and a kernel
timer.

``test_dpf_perf`` ports ``dpf_tpu/utils/bench.py::test_dpf_perf`` (the
reference's ``dpf.py:286-320`` protocol): distinct keys tiled to the
batch, one warm evaluation, then timed repetitions, each ending in a
device synchronise.  ``cuda_ms`` times launches on the card by CUDA
events.
"""

from __future__ import annotations

import json
import time

import numpy as np
import torch


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def cuda_ms(fn, reps: int) -> float:
    """Mean device ms of ``fn`` over ``reps`` calls after one warm-up,
    between two CUDA events on the current stream."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def test_dpf_perf(N=16384, batch=512, entrysize=16, prf=None, reps=10,
                  keys_distinct=None, quiet=False, check=False,
                  config=None, device=None):
    """Measure batched eval throughput; returns the result dict.

    ``keys_distinct`` distinct key pairs (default: ``batch``) are minted
    on the host (keygen is pure-Python, O(log N) PRF calls per pair) and
    tiled to ``batch``; device work is the same per key either way.

    check=True recovers every row of the tiled batch from both servers'
    shares before timing and raises unless each equals its table row.
    ``config``: an ``EvalConfig`` (e.g. ``EvalConfig(radix=4)`` or
    ``EvalConfig(scheme="sqrtn")``); ``prf`` wins over its
    ``prf_method``.
    """
    from ..api import DPF

    dpf = DPF(prf=prf, config=config, device=device)
    if keys_distinct is None:
        keys_distinct = batch
    # odd multiplier is bijective mod the pow2 table size: indices are
    # distinct (for keys_distinct <= N) and well spread
    idxs = [(i * 0x9E3779B1) % N for i in range(keys_distinct)]
    pairs = [dpf.gen(i, N) for i in idxs]
    keys = [pairs[i % keys_distinct][0] for i in range(batch)]

    table = np.random.default_rng(1).integers(
        0, 2 ** 31, (N, entrysize), dtype=np.int32, endpoint=False)
    dpf.eval_init(table)

    if check:
        a = dpf.eval_gpu(keys)
        b = dpf.eval_gpu([pairs[i % keys_distinct][1] for i in range(batch)])
        rec = (a - b).cpu().numpy()
        want = table[[idxs[i % keys_distinct] for i in range(batch)]]
        # explicit raise, not assert: the gate backs the "checked" field
        if not (rec == want).all():
            raise AssertionError("share recovery check failed")

    dpf.eval_gpu(keys)  # warm
    _sync(dpf.device)
    tstart = time.perf_counter()
    for _ in range(reps):
        dpf.eval_gpu(keys)
    _sync(dpf.device)
    elapsed = time.perf_counter() - tstart

    result = {
        "entries": N,
        "batch_size": batch,
        "entry_size": entrysize,
        "prf": dpf.prf_method_string,
        "scheme": dpf.scheme,
        "radix": dpf.radix,
        "device": (torch.cuda.get_device_name(dpf.device)
                   if dpf.device.type == "cuda" else "cpu"),
        "keys_distinct": keys_distinct,
        "reps": reps,
        "elapsed_s": elapsed,
        "ms_per_batch": 1e3 * elapsed / reps,
        "dpfs_per_sec": batch * reps / elapsed,
        "key_size_bytes": 4 * int(keys[0].numel()),
        "checked": bool(check),
    }
    if not quiet:
        print("%s Key Size: %d bytes, Perf: %d dpfs/sec"
              % (dpf, result["key_size_bytes"], result["dpfs_per_sec"]))
        print(json.dumps(result))
    return result
