"""Benchmark helpers: the printed-dict throughput protocol, a kernel
timer, kernel builds timed in turns, and end-to-end rates of several
trees in turns.

``test_dpf_perf`` ports ``dpf_tpu/utils/bench.py::test_dpf_perf`` (the
reference's ``dpf.py:286-320`` protocol): distinct keys tiled to the
batch, one warm evaluation, then timed repetitions, each ending in a
device synchronise.  ``cuda_ms`` times launches on the card by CUDA
events.  ``libraries_in_turns`` and ``held_ms`` serve the per-kernel
scripts (``k2_times``, ``k3_times``) that time this tree's build of a
kernel beside other builds of it, for example a parent commit's.

Run as a module, it measures the AES servers' dpfs/s at N = 2^20 and
65536 in each of the given checkouts (one process per checkout and
round, the order reversed every other round, so that a drift of the
host falls on every tree alike) and prints each sample (with the
process's CPU ms a batch, the host's work), then per configuration and
tree the median of each round, their median and quartiles, and the
rounds in which each tree beat the first.  Needs one
CUDA card:

    python -m dpf_tpu_torch.utils.bench [--rounds R] [--n N] TREE [TREE ...]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from ..ops import cuda_build


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


def load_entry(so, source: str, entry: str):
    """The C entry ``entry`` of another build of ``csrc/<source>.cu`` at
    path ``so``, typed as this tree's."""
    fn = getattr(ctypes.CDLL(str(so)), entry)
    fn.argtypes = cuda_build.SOURCES[source][0][entry]
    fn.restype = ctypes.c_int
    return fn


def libraries_in_turns(source: str, entry: str, others) -> list:
    """``[(label, entry)]``: this tree's build alone, or with the builds
    at the paths ``others`` in turns: the others, this tree's twice, the
    others again."""
    this = ("this", getattr(cuda_build.library(source), entry))
    if not others:
        return [this]
    other = [("other" if len(others) == 1 else "other %d" % i,
              load_entry(so, source, entry)) for i, so in enumerate(others)]
    return other + [this, this] + other[::-1]


def held_ms(libs, call, want, reps: int, name: str) -> list:
    """For each ``(label, entry)`` of ``libs`` in order: hold
    ``call(entry)`` bit for bit against ``want``, then time it over
    ``reps`` calls; ``[(label, ms)]``."""
    out = []
    for label, fn in libs:
        got = call(fn)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError("%s, %s library: differs from the plain "
                                 "version" % (name, label))
        out.append((label, cuda_ms(lambda: call(fn), reps)))
    return out


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


# (prf id, N, radix, scheme, distinct key pairs): the AES servers of the
# three constructions at the full width and the headline N
RATE_CONFIGS = ((3, 1 << 20, 2, "logn", 64), (3, 1 << 20, 4, "logn", 64),
                (3, 1 << 20, 2, "sqrtn", 16), (3, 1 << 16, 2, "logn", 64),
                (3, 1 << 16, 4, "logn", 64), (3, 1 << 16, 2, "sqrtn", 64))

# One process of ``rates``, run in a checkout through its public API only
# (``DPF``, ``EvalConfig``), so that another commit's tree can be timed
# by the same loop: per configuration, keys minted and the table loaded
# once, one warm batch, then ``samples`` timed runs of ``reps`` batches.
_RATE_WORKER = """
import json, sys, time
import numpy as np, torch
from dpf_tpu_torch.api import DPF
from dpf_tpu_torch.utils.config import EvalConfig
samples, reps = int(sys.argv[2]), int(sys.argv[3])
for prf, n, radix, scheme, distinct in json.loads(sys.argv[1]):
    dpf = DPF(prf=prf, config=EvalConfig(radix=radix, scheme=scheme))
    pairs = [dpf.gen((i * 0x9E3779B1) % n, n) for i in range(distinct)]
    keys = [pairs[i % distinct][0] for i in range(512)]
    dpf.eval_init(np.random.default_rng(1).integers(
        0, 2 ** 31, (n, 16), dtype=np.int32))
    dpf.eval_gpu(keys)
    torch.cuda.synchronize()
    rates, cpu = [], []
    for _ in range(samples):
        t0, c0 = time.perf_counter(), time.process_time()
        for _ in range(reps):
            dpf.eval_gpu(keys)
        torch.cuda.synchronize()
        rates.append(512 * reps / (time.perf_counter() - t0))
        cpu.append(1e3 * (time.process_time() - c0) / reps)
    print(json.dumps({"config": [prf, n, radix, scheme],
                      "dpfs_per_sec": rates, "cpu_ms_per_batch": cpu}),
          flush=True)
"""


def rates(trees, rounds: int = 10, samples: int = 5, reps: int = 10,
          configs=RATE_CONFIGS) -> dict:
    """dpfs/s of ``configs`` in each checkout of ``trees``, one process a
    checkout and round, the order reversed every other round;
    ``{config: {tree: [median of each round's samples]}}``."""
    out = {}
    for r in range(rounds):
        for tree in (trees if r % 2 == 0 else trees[::-1]):
            res = subprocess.run(
                [sys.executable, "-c", _RATE_WORKER,
                 json.dumps([list(c) for c in configs]), str(samples),
                 str(reps)], cwd=str(tree), capture_output=True, text=True,
                check=True)
            for line in res.stdout.splitlines():
                row = json.loads(line)
                key = "prf %d N=%d radix %d %s" % tuple(row["config"])
                out.setdefault(key, {}).setdefault(str(tree), []).append(
                    statistics.median(row["dpfs_per_sec"]))
                print(json.dumps(dict(row, tree=str(tree), round=r,
                                      config=key)), flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="+", type=Path,
                    help="checkouts of the repository to time in turns")
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--samples", type=int, default=5)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--n", type=int, action="append",
                    help="only the configurations at this N (repeatable)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench: no CUDA device", file=sys.stderr)
        return 2
    got = rates(args.trees, args.rounds, args.samples, args.reps,
                [c for c in RATE_CONFIGS if not args.n or c[1] in args.n])
    first = str(args.trees[0])
    for key, by_tree in got.items():
        for tree, vals in by_tree.items():
            q = statistics.quantiles(vals, n=4) if len(vals) > 1 else vals * 3
            row = {"config": key, "tree": tree, "rounds": vals,
                   "median": statistics.median(vals),
                   "quartiles": [q[0], q[2]]}
            if tree != first:   # rounds in which this tree beat the first
                row["wins_over_first"] = sum(
                    v > w for v, w in zip(vals, by_tree[first]))
            print(json.dumps(row))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
