"""Benchmark helpers: the printed-dict throughput protocol, a kernel
timer, kernel builds timed in turns, and end-to-end rates of several
trees in turns.

``test_dpf_perf``, ``test_dpf_latency`` and ``test_matmul_perf`` port
``dpf_tpu/utils/bench.py`` (the reference's ``dpf.py:286-320``
protocol, its latency mode and its contraction benchmark): keys minted
by one ``gen_batch`` call, one warm evaluation, then timed repetitions
ending in a device synchronise; the contraction's backends
(``ops/matmul128.IMPLS``) each held bit-equal to the plain version
before they are timed.  ``cuda_ms`` times launches on the card by CUDA
events, ``profiled_ms`` by the device time the profiler records (for
kernels of tens of microseconds, where events around the calls time the
host's enqueue).  ``libraries_in_turns`` and ``held_ms`` serve the
per-kernel scripts (``k2_times``, ``k3_times``, ``pkt_times``) that
time this tree's build of a kernel beside other builds of it, for
example a parent commit's.

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


def gpu_name_and_power() -> str:
    """``nvidia-smi``'s ``name, power.limit`` line of the first card."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]


def _device_name(device: torch.device) -> str:
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")


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


def profiled_ms(calls: dict, reps: int = 20, tries: int = 3) -> dict:
    """{name: device ms a call} of each ``calls[name] = (fn, kernel)``:
    the device time of the kernels whose name holds ``kernel``, all
    timed in one ``torch.profiler`` session after one warm call (the
    wrappers' host work and their outputs' zero fill left out).  Late in
    a long process a session on the card has recorded no or only some
    kernels; such a session is run again, up to ``tries`` sessions, then
    this raises."""
    from .profile_batch import _device_us

    def run():
        for fn, _ in calls.values():
            fn()
    run()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for _ in range(tries):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(reps):
                run()
            torch.cuda.synchronize()
        kernels = {evt.key: _device_us(evt) / 1e3 / reps
                   for evt in prof.key_averages()
                   if str(getattr(evt, "device_type", "")).endswith("CUDA")}
        out = {name: sum(v for k, v in kernels.items() if kernel in k)
               for name, (_, kernel) in calls.items()}
        if all(v > 0 for v in out.values()):
            return out
    raise AssertionError("no device time for %s in %d sessions: %s"
                         % ([kernel for name, (_, kernel) in calls.items()
                             if out[name] <= 0], tries, sorted(kernels)))


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

    ``keys_distinct`` distinct key pairs (default: ``batch``, every row
    its own key) are minted on the host by one ``gen_batch`` call
    (``keygen_s`` seconds, by the ``keygen`` generator: ``"native"`` or
    ``"vectorized"``) and tiled to ``batch``.

    check=True recovers every row of the batch from both servers'
    shares before timing and raises unless each equals its table row.
    ``config``: an ``EvalConfig`` (e.g. ``EvalConfig(radix=4)`` or
    ``EvalConfig(scheme="sqrtn")``); ``prf`` wins over its
    ``prf_method``.
    """
    from .. import native
    from ..api import DPF

    dpf = DPF(prf=prf, config=config, device=device)
    if keys_distinct is None:
        keys_distinct = batch
    # odd multiplier is bijective mod the pow2 table size: indices are
    # distinct (for keys_distinct <= N) and well spread
    idxs = np.array([(i * 0x9E3779B1) % N for i in range(keys_distinct)])
    # resolved (and the native library built) before the clock starts
    generator = ("native" if dpf.scheme == "logn" and dpf.radix == 2
                 and native.available() else "vectorized")
    t0 = time.perf_counter()
    wire_a, wire_b = dpf.gen_batch(idxs, N)
    keygen_s = time.perf_counter() - t0
    tile = torch.arange(batch) % keys_distinct
    keys = wire_a[tile]

    table = np.random.default_rng(1).integers(
        0, 2 ** 31, (N, entrysize), dtype=np.int32, endpoint=False)
    dpf.eval_init(table)

    if check:
        rec = (dpf.eval_gpu(keys) - dpf.eval_gpu(wire_b[tile])).cpu().numpy()
        # explicit raise, not assert: the gate backs the "checked" field
        if not (rec == table[idxs[tile.numpy()]]).all():
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
        "device": _device_name(dpf.device),
        "keys_distinct": keys_distinct,
        "keygen_s": keygen_s,
        "keygen": generator,
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


def test_dpf_latency(N=16384, entrysize=16, prf=None, reps=20, quiet=False,
                     config=None, device=None):
    """Single-query latency (the reference's latency mode,
    ``dpf_benchmark.cu:242-276``): one key, one dispatch ending in a
    device synchronise, wall-clock ms a query over ``reps`` queries,
    after the row is recovered once from both servers' shares."""
    from ..api import DPF

    dpf = DPF(prf=prf, config=config, device=device)
    alpha = N // 3
    k1, k2 = dpf.gen(alpha, N)
    table = np.random.default_rng(1).integers(
        0, 2 ** 31, (N, entrysize), dtype=np.int32, endpoint=False)
    dpf.eval_init(table)
    rec = (dpf.eval_gpu([k1]) - dpf.eval_gpu([k2])).cpu().numpy()
    if not (rec[0] == table[alpha]).all():
        raise AssertionError("share recovery check failed")
    dpf.eval_gpu([k1])  # warm
    _sync(dpf.device)
    t0 = time.perf_counter()
    for _ in range(reps):
        dpf.eval_gpu([k1])
        _sync(dpf.device)
    elapsed = time.perf_counter() - t0
    result = {
        "mode": "latency",
        "entries": N,
        "entry_size": entrysize,
        "prf": dpf.prf_method_string,
        "scheme": dpf.scheme,
        "radix": dpf.radix,
        "device": _device_name(dpf.device),
        "reps": reps,
        "latency_ms": 1e3 * elapsed / reps,
        "checked": True,
    }
    if not quiet:
        print(json.dumps(result))
    return result


def test_matmul_perf(B=512, K=65536, E=16, reps=10, quiet=False,
                     device=None):
    """The contraction alone (the reference's
    ``dpf_gpu/matmul_benchmark.cu``): ``[B, K] x [K, E]`` exact mod 2^32
    by each backend of ``ops/matmul128.IMPLS``, each held bit-equal to
    ``dot_i32_plain`` first; ``{impl: result dict}``.  ``gops_per_sec``
    (2 B K E operations a call) is kept unrounded, so a slow call never
    reads as 0."""
    from ..api import resolve_device
    from ..ops import matmul128

    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, (B, K),
                                      dtype=np.int64).astype(np.int32)).to(dev)
    b = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, (K, E),
                                      dtype=np.int64).astype(np.int32)).to(dev)
    want = matmul128.dot_i32_plain(a, b)
    results = {}
    for name, impl in matmul128.IMPLS.items():
        if not torch.equal(impl(a, b), want):
            raise AssertionError("matmul impl %r differs from the plain "
                                 "version" % name)
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(reps):
            impl(a, b)
        _sync(dev)
        elapsed = time.perf_counter() - t0
        r = {"impl": name, "B": B, "K": K, "E": E, "reps": reps,
             "device": _device_name(dev),
             "elapsed_s": elapsed,
             "gops_per_sec": 2e-9 * B * K * E * reps / elapsed}
        results[name] = r
        if not quiet:
            print(json.dumps(r))
    return results


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
    print(gpu_name_and_power())
    return 0


if __name__ == "__main__":
    sys.exit(main())
