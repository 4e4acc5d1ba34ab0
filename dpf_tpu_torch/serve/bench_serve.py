"""Streaming serving benchmark: the blocking loop against the engine.

Port of ``dpf_tpu/serve/bench_serve.py``:

* ``ingest_microbench`` / ``sqrt_ingest_microbench``: the scalar
  per-key codec against the batched codec on one key batch, asserted
  equal before timing.
* ``stream_bench``: sustained queries/s over one key stream through the
  pre-engine scalar loop, the blocking loop (``eval_gpu`` and a copy to
  the host per batch) and the ``ServingEngine``, gated on bit-exact
  equality first.
* ``overlap_bench``: the blocking loop and the engine at several
  windows over one stream, each pass timed on the host clock after a
  ``torch.cuda.synchronize()``, with the engine's pack / dispatch /
  wait host seconds per batch and, under ``torch.profiler``, the
  device's busy share (kernel and copy time over the unprofiled pass's
  wall time).

    python -m dpf_tpu_torch.serve.bench_serve [--n N] [--prf ID]
        [--device cpu] [--out FILE]

runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import json
import time

import numpy as np
import torch


def ingest_microbench(B=512, n=65536, distinct=32, reps=5):
    """Scalar per-key codec loop vs the batched codec on one key batch;
    both give the packed (cw1, cw2, last) arrays, asserted equal before
    timing.  Host seconds."""
    from ..core import expand, keygen

    ks = [keygen.generate_keys((i * 0x9E3779B1) % n, n, b"ingest-%d" % i,
                               prf_method=0)[0].serialize()
          for i in range(distinct)]
    keys = [ks[i % distinct] for i in range(B)]
    scalar = expand.pack_keys([keygen.deserialize_key(k) for k in keys])
    pk = keygen.decode_keys_batched(keys)
    if not (np.array_equal(scalar[0], pk.cw1)
            and np.array_equal(scalar[1], pk.cw2)
            and np.array_equal(scalar[2], pk.last)):
        raise AssertionError("batched codec diverged from the scalar one")
    t0 = time.perf_counter()
    for _ in range(reps):
        expand.pack_keys([keygen.deserialize_key(k) for k in keys])
    scalar_s = (time.perf_counter() - t0) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        keygen.decode_keys_batched(keys)
    batched_s = (time.perf_counter() - t0) / reps
    return {"batch": B, "entries": n, "reps": reps,
            "scalar_s": round(scalar_s, 6),
            "batched_s": round(batched_s, 6),
            "speedup": round(scalar_s / batched_s, 2)}


def sqrt_ingest_microbench(B=512, n=65536, distinct=32, reps=5):
    """The sqrt-N counterpart of ``ingest_microbench``."""
    from ..core import sqrtn

    ks = [sqrtn.generate_sqrt_keys((i * 0x9E3779B1) % n, n,
                                   b"sq-ingest-%d" % i,
                                   prf_method=0)[0].serialize()
          for i in range(distinct)]
    keys = [ks[i % distinct] for i in range(B)]
    scalar = sqrtn.pack_sqrt_keys([sqrtn.deserialize_sqrt_key(k)
                                   for k in keys])
    pk = sqrtn.decode_sqrt_keys_batched(keys)
    if not (np.array_equal(scalar[0], pk.seeds)
            and np.array_equal(scalar[1], pk.cw1)
            and np.array_equal(scalar[2], pk.cw2) and pk.n == n):
        raise AssertionError("batched sqrt-N codec diverged from the "
                             "scalar one")
    t0 = time.perf_counter()
    for _ in range(reps):
        sqrtn.pack_sqrt_keys([sqrtn.deserialize_sqrt_key(k) for k in keys])
    scalar_s = (time.perf_counter() - t0) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        sqrtn.decode_sqrt_keys_batched(keys)
    batched_s = (time.perf_counter() - t0) / reps
    return {"batch": B, "entries": n, "reps": reps,
            "scalar_s": round(scalar_s, 6),
            "batched_s": round(batched_s, 6),
            "speedup": round(scalar_s / batched_s, 2)}


def _key_stream(dpf, n, batch, batches, distinct=16, ragged=False):
    """A deterministic stream of key batches (server-0 keys from one
    ``gen_batch``, key i from seed ``serve-i``), each a list of keys."""
    ks = dpf.gen_batch([(i * 0x9E3779B1) % n for i in range(distinct)], n,
                       seeds=[b"serve-%d" % i for i in range(distinct)])[0]
    sizes = [max(1, batch >> (j % 3)) if ragged else batch
             for j in range(batches)]
    return [[ks[(j + i) % distinct] for i in range(b)]
            for j, b in enumerate(sizes)]


def _blocking_scalar_pass(dpf, stream):
    """The pre-engine serial path: per-key scalar deserialize and pack,
    dispatch, wait for the result on the host."""
    from ..core import expand, keygen
    outs = []
    for batch in stream:
        flat = [keygen.deserialize_key(k) for k in batch]
        cw1, cw2, last = expand.pack_keys(flat)
        pk = keygen.PackedKeys(cw1, cw2, last, depth=flat[0].depth,
                               n=flat[0].n)
        outs.append(dpf._dispatch_packed(pk).cpu().numpy())
    return outs


def _blocking_pass(dpf, stream):
    """The blocking loop: ``eval_gpu`` and a copy to the host a batch."""
    return [dpf.eval_gpu(b).cpu().numpy() for b in stream]


def _engine_pass(engine, stream):
    futs = [engine.submit(b) for b in stream]
    engine.drain()
    return [f.result() for f in futs]


def _sync(dpf):
    if dpf.device.type == "cuda":
        torch.cuda.synchronize(dpf.device)


def _timed(dpf, fn):
    """(result, host seconds) of ``fn()`` started on an idle device."""
    _sync(dpf)
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def device_ms(fn) -> float | None:
    """Device time (kernels and copies) of ``fn()`` under
    ``torch.profiler``, in ms; None when the profiler recorded none."""
    from ..utils.profile_batch import _device_us
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    us = sum(_device_us(e) for e in prof.key_averages()
             if str(getattr(e, "device_type", "")).endswith("CUDA"))
    return us / 1e3 if us > 0 else None


def overlap_bench(dpf, stream, windows=(1, 2, 4), profile=True) -> dict:
    """The blocking loop and the engine at each window over ``stream``
    (a list of key batches), every engine row bit-equal to the blocking
    loop's.  Per mode: seconds, dpfs/s, and for the engine the pack /
    dispatch / wait host ms a batch; with ``profile`` (on the card) the
    device ms of the same pass under ``torch.profiler`` and the busy
    share, device ms over the unprofiled pass's wall ms."""
    total = sum(len(b) for b in stream)
    _blocking_pass(dpf, stream[:1])                      # warm
    ref, sec = _timed(dpf, lambda: _blocking_pass(dpf, stream))
    modes = {"blocking": {"seconds": sec, "dpfs_per_sec": total / sec}}
    runs = {"blocking": lambda: _blocking_pass(dpf, stream)}
    for w in windows:
        engine = dpf.serving_engine(max_in_flight=w, warmup=True)
        out, sec = _timed(dpf, lambda: _engine_pass(engine, stream))
        for a, b in zip(ref, out):
            if not np.array_equal(a, b):
                raise AssertionError("engine (max_in_flight=%d) differs "
                                     "from the blocking loop" % w)
        st = engine.stats
        modes["engine_%d" % w] = {
            "seconds": sec, "dpfs_per_sec": total / sec,
            "max_in_flight": w, "in_flight_hwm": st.in_flight_hwm,
            "pack_ms_per_batch": 1e3 * st.pack_time_s / len(stream),
            "dispatch_ms_per_batch": 1e3 * st.dispatch_time_s / len(stream),
            "wait_ms_per_batch": 1e3 * st.wait_time_s / len(stream)}
        runs["engine_%d" % w] = (lambda e=engine: _engine_pass(e, stream))
    if profile and dpf.device.type == "cuda":
        for name, fn in runs.items():
            dms = device_ms(fn)
            modes[name]["device_ms"] = dms
            modes[name]["busy_share"] = (
                None if dms is None
                else dms / (1e3 * modes[name]["seconds"]))
    return {"batches": len(stream), "queries": total, "modes": modes}


def stream_bench(n=1024, entry_size=16, batch=256, batches=24, prf=None,
                 max_in_flight=2, ragged=False, device=None, quiet=False):
    """Sustained queries/s on one streamed workload: the pre-engine
    scalar loop (the baseline, ``vs_baseline``), the blocking loop
    (``vs_blocking_batched``) and the engine (``value``), all bit-equal
    first."""
    from ..api import DPF

    dpf = DPF(prf=0 if prf is None else prf, device=device)
    table = np.random.default_rng(3).integers(
        0, 2 ** 31, (n, entry_size), dtype=np.int32, endpoint=False)
    dpf.eval_init(table)
    stream = _key_stream(dpf, n, batch, batches, ragged=ragged)
    total = sum(len(b) for b in stream)
    engine = dpf.serving_engine(max_in_flight=max_in_flight, warmup=True)
    blocking_ref = _blocking_pass(dpf, stream)
    scalar_ref = _blocking_scalar_pass(dpf, stream)
    for ref, sc, out in zip(blocking_ref, scalar_ref,
                            _engine_pass(engine, stream)):
        if not (np.array_equal(ref, out) and np.array_equal(ref, sc)):
            raise AssertionError("serving passes diverged")
    _, scalar_s = _timed(dpf, lambda: _blocking_scalar_pass(dpf, stream))
    _, blocking_s = _timed(dpf, lambda: _blocking_pass(dpf, stream))
    engine = dpf.serving_engine(max_in_flight=max_in_flight, warmup=True)
    _, engine_s = _timed(dpf, lambda: _engine_pass(engine, stream))
    qps_engine = total / engine_s
    record = {
        "metric": "sustained queries/sec (serving engine, entries=%d, "
                  "entry_size=%d, %s, stream %dx%d%s, 1 device)"
                  % (n, entry_size, dpf.prf_method_string, batches, batch,
                     " ragged" if ragged else ""),
        "device": (torch.cuda.get_device_name(dpf.device)
                   if dpf.device.type == "cuda" else "cpu"),
        "value": int(qps_engine),
        "unit": "queries/sec",
        "vs_baseline": round(qps_engine * scalar_s / total, 4),
        "baseline": "pre-engine blocking loop (per-key scalar codec + "
                    "dispatch + wait), identical stream",
        "blocking_scalar_qps": int(total / scalar_s),
        "blocking_qps": int(total / blocking_s),
        "vs_blocking_batched": round(qps_engine * blocking_s / total, 4),
        "engine_elapsed_s": round(engine_s, 4),
        "max_in_flight": max_in_flight,
        "resolved_config": engine.resolved_config(),
        "engine_stats": engine.stats.as_dict(),
        "ingest_microbench": ingest_microbench(),
        "checked": True,  # bit-exact equality gate ran before timing
    }
    if not quiet:
        print(json.dumps(record), flush=True)
    return record


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1024)
    ap.add_argument("--entry-size", type=int, default=16)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--batches", type=int, default=24)
    ap.add_argument("--prf", type=int, default=None,
                    help="PRF id (default DUMMY; 2=ChaCha20, 3=AES128)")
    ap.add_argument("--max-in-flight", type=int, default=2)
    ap.add_argument("--ragged", action="store_true",
                    help="cycle ragged batch sizes (exercises buckets)")
    ap.add_argument("--device", default=None,
                    help="server device (default: the CUDA card)")
    ap.add_argument("--out", help="also write the JSON record to a file")
    args = ap.parse_args(argv)
    record = stream_bench(n=args.n, entry_size=args.entry_size,
                          batch=args.batch, batches=args.batches,
                          prf=args.prf, max_in_flight=args.max_in_flight,
                          ragged=args.ragged, device=args.device)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
            f.write("\n")
    return record


if __name__ == "__main__":
    main()
