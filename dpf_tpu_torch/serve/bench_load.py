"""Open-loop load benchmark: cost-model scheme router vs sticky engine.

Port of ``dpf_tpu/serve/bench_load.py``.  Replays one seeded bursty
mixed-shape arrival trace (``serve/loadgen.py``) through two serving
stacks over the same table and reports SLO accounting for each:

* **sticky**: one ``ServingEngine`` over the construction
  ``resolve_sticky`` pins (the binary-tree heuristic: the port has no
  tuning cache yet);
* **router**: ``SchemeRouter``, a construction per arrival by the live
  cost model (probe-seeded with CUDA events, EWMA-updated);
* **shed**: the router with admission control armed (``slo_s``,
  ``max_queue_depth``, ``shed=True``) under the trace squeezed 4x.

The replay is open-loop: arrivals fire at their scheduled times whether
or not the server kept up, and a latency is completion minus scheduled
arrival.  Every served batch is equality-gated against the CPU oracle
(``DPF.eval_cpu`` of each pool key, computed once); rejections are
counted and must be 0.  With ``on_rate=None`` the trace is calibrated to
the sticky engine's probed per-bucket costs: ON windows keep it busy
``on_load`` of the time (1.5: overloaded), OFF windows ``off_load``
(0.3), so a backlog builds in each burst and drains after it.

    python -m dpf_tpu_torch.serve.bench_load [--n N] [--prf ID]
        [--cap C] [--duration S] [--on-load X --off-load Y]
        [--device cpu] [--dryrun] [--out FILE]

runs on the card unless ``--device cpu`` is given; the record names the
device.
"""

from __future__ import annotations

import json
import time
from collections import deque

import numpy as np
import torch

from ..obs import FLIGHT, record_sections
from ..obs.tracer import span
from ..utils.profiling import quantile
from .engine import LoadShed, ServingEngine
from . import loadgen


def _key_pool(srv, n: int, distinct: int, tag: bytes):
    """``distinct`` server-0 keys for ``srv`` (one ``gen_batch``: the
    same keys as ``dpf_tpu``'s pool, key i from seed ``tag-i``) and their
    CPU-oracle shares (one ``eval_cpu`` call)."""
    idx = [(i * 0x9E3779B1) % n for i in range(distinct)]
    keys = srv.gen_batch(idx, n,
                         seeds=[tag + b"-%d" % i for i in range(distinct)])[0]
    return keys, srv.eval_cpu(keys).numpy()      # [distinct, E]


def _batch_for(pool, j: int, b: int):
    """Deterministic rotating view of the key pool: arrival j's batch
    of b keys (one ``[b, W]`` tensor) and their pool indices."""
    keys, _ = pool
    idxs = [(j + i) % len(keys) for i in range(b)]
    return keys[idxs], idxs


def replay(trace, submit, *, window: int = 8):
    """Open-loop replay of ``trace`` through ``submit(arrival, j)``.

    ``submit`` returns a future (``.result()``) or raises ``LoadShed``.
    Arrivals are released at their scheduled ``t`` (sleeping when
    ahead; when behind, back-to-back — the backlog is the server's
    problem, as in production).  While ahead of schedule the replay
    resolves outstanding futures (the polling client), and never holds
    more than ``window`` unresolved — per-arrival latency is
    completion − scheduled arrival, in seconds.

    One honesty note: the client is single-threaded, so a blocking
    ``result()`` in the idle gap can delay a later arrival's submit
    past its schedule.  The delay still lands in the MEASURED latency
    (which is against the scheduled time, not the actual submit), and
    both race legs replay through this identical loop, so the
    comparison is fair — but shed counts under overload are a floor
    (a threaded client would have offered, and shed, sooner).

    Returns ``(latencies, per_arrival, makespan_s, shed_batches,
    shed_queries)`` where ``per_arrival`` is ``(arrival, j, future)``
    for the equality gate (shed arrivals excluded).
    """
    t0 = time.perf_counter()
    outstanding = deque()               # (arrival, j, fut)
    done = []                           # (arrival, j, fut)
    lats = []
    sheds = shed_q = 0

    def resolve_oldest():
        a, j, fut = outstanding.popleft()
        fut.result()
        lats.append((time.perf_counter() - t0) - a.t)
        done.append((a, j, fut))

    for j, a in enumerate(trace):
        while True:
            now = time.perf_counter() - t0
            if now >= a.t:
                break
            if outstanding:             # use the idle gap to poll
                resolve_oldest()
            else:
                time.sleep(min(a.t - now, 0.02))
        while len(outstanding) >= window:
            resolve_oldest()
        try:
            fut = submit(a, j)
        except LoadShed:
            sheds += 1
            shed_q += a.batch
            continue
        outstanding.append((a, j, fut))
    while outstanding:
        resolve_oldest()
    return lats, done, time.perf_counter() - t0, sheds, shed_q


def _slo_stats(lats, slo_s: float) -> dict:
    if not lats:    # empty trace / everything shed: report, don't crash
        return {"p50_ms": None, "p95_ms": None, "p99_ms": None,
                "max_ms": None, "deadline_miss_batches": 0,
                "deadline_miss_rate": 0.0}
    ms = sorted(x * 1e3 for x in lats)
    miss = sum(1 for x in lats if x > slo_s)
    return {
        "p50_ms": round(quantile(ms, 0.50, presorted=True), 3),
        "p95_ms": round(quantile(ms, 0.95, presorted=True), 3),
        "p99_ms": round(quantile(ms, 0.99, presorted=True), 3),
        "max_ms": round(ms[-1], 3),
        "deadline_miss_batches": miss,
        "deadline_miss_rate": round(miss / len(lats), 4),
    }


def _gate(done, pools, label_of) -> int:
    """Bit-exact equality of every served batch against the scalar-
    oracle reference rows; returns the rejection count."""
    rejections = 0
    with span("gate", batches=len(done)):
        for a, j, fut in done:
            label = label_of(fut)
            _, refs = pools[label]
            _, idxs = _batch_for(pools[label], j, a.batch)
            if not np.array_equal(fut.result(), refs[idxs]):
                rejections += 1
    return rejections


def offered_rate(load: float, on: bool, buckets, cost_s,
                 draws: int = 20000) -> float:
    """Arrivals/s at which the ON (or OFF) windows of
    ``loadgen.bursty_trace`` keep an engine busy ``load`` of the time:
    ``load`` over the mean seconds an arrival costs, each of its chunks
    at its bucket's ``cost_s(bucket)`` (a fixed-seed sample of the
    trace's batch draw)."""
    rng = np.random.default_rng(0)
    total = 0.0
    for _ in range(draws):
        b = loadgen._bursty_batch(rng, on, buckets.max)
        total += sum(cost_s(buckets.bucket_for(hi - lo))
                     for lo, hi in buckets.chunks(b))
    return load * draws / total


def load_bench(n=4096, entry_size=16, cap=128, prf=0, *,
               trace=None, seed=11, duration_s=7.0, on_rate=320.0,
               off_rate=2.0, on_load=1.5, off_load=0.3, slo_ms=250.0,
               reps=2, distinct=16, window=8, shed_leg=True,
               shed_queue_depth=None, shed_window=None, device=None,
               quiet=False) -> dict:
    """Race the cost-model router against the sticky engine on one
    seeded open-loop bursty trace; returns the record.  ``on_rate=None``
    calibrates both rates to the sticky engine's probed costs: ON
    windows keep it busy ``on_load`` of the time, OFF windows
    ``off_load`` (``offered_rate``);
    ``shed_queue_depth`` is the shed leg's ``max_queue_depth`` (None =
    ``max(2, window // 2)``, ``dpf_tpu``'s) and ``shed_window`` its
    client's window (None = ``window``): a depth bound at or above the
    client's window never trips."""
    from ..api import resolve_device
    from .router import LABELS, SchemeRouter, resolve_sticky

    dev = resolve_device(device)
    FLIGHT.clear()      # scope the embedded flight tail to this bench
    table = np.random.default_rng(seed ^ 0x10ad).integers(
        0, 2 ** 31, (n, entry_size), dtype=np.int32, endpoint=False)
    slo_s = slo_ms / 1e3

    # ---- stacks: router (3 constructions) + sticky single engine ----
    router = SchemeRouter(table, prf=prf, cap=cap, probe=True, device=dev)
    sticky_label, sticky_from = resolve_sticky(n, entry_size, prf, cap)
    sticky_srv = router.server(sticky_label)     # same table upload
    sticky_engine = ServingEngine(sticky_srv, max_in_flight=2,
                                  buckets=router.buckets, warmup=True)
    calibration = None
    if trace is None:
        if on_rate is None:

            def cost(bucket):
                return router.cost(sticky_label, bucket)
            on_rate = offered_rate(on_load, True, router.buckets, cost)
            off_rate = offered_rate(off_load, False, router.buckets, cost)
            calibration = {
                "on_load": on_load, "off_load": off_load,
                "sticky_probe_ms": {b: 1e3 * cost(b)
                                    for b in router.buckets.sizes},
                "sticky_capacity_qps_at_cap":
                    router.buckets.max / cost(router.buckets.max)}
        trace = loadgen.bursty_trace(
            on_rate=on_rate, off_rate=off_rate, on_s=1.0, off_s=2.0,
            duration_s=duration_s, cap=cap, seed=seed, n=n)
    total_q = loadgen.total_queries(trace)
    pools = {lb: _key_pool(router.server(lb), n, distinct,
                           b"load-%s" % lb.encode())
             for lb in LABELS}

    def sticky_submit(a, j):
        keys, _ = _batch_for(pools[sticky_label], j, a.batch)
        return sticky_engine.submit(keys)

    def router_submit(a, j):
        dec = router.route(a.batch)
        keys, _ = _batch_for(pools[dec.construction], j, a.batch)
        return router.submit(dec, keys)

    def run_leg(submit, reset, stats_fn) -> tuple:
        """Best-qps rep; ``stats_fn()`` is snapshotted per rep so the
        record's counters describe the same run as its latencies."""
        best = None
        for _ in range(max(1, reps)):
            reset()
            lats, done, makespan, sheds, shed_q = replay(
                trace, submit, window=window)
            qps = int((total_q - shed_q) / makespan)
            if best is None or qps > best[0]:
                best = (qps, lats, done, makespan, stats_fn())
        return best

    q_s, lats_s, done_s, mk_s, stats_s = run_leg(
        sticky_submit, sticky_engine.stats.reset,
        lambda: sticky_engine.stats.as_dict())
    sticky_leg = {
        "construction": sticky_label, "resolved_from": sticky_from,
        "qps": q_s, "makespan_s": round(mk_s, 4),
        "served_queries": total_q,
        **_slo_stats(lats_s, slo_s),
        "engine_stats": stats_s,
    }
    q_r, lats_r, done_r, mk_r, stats_r = run_leg(
        router_submit, router.reset_counters, router.stats)
    router_leg = {
        "qps": q_r, "makespan_s": round(mk_r, 4),
        "served_queries": total_q,
        **_slo_stats(lats_r, slo_s),
        "router_stats": stats_r,
    }
    shed_rec = None
    if shed_leg:
        servers = {lb: router.server(lb) for lb in router.constructions}
        depth = (max(2, window // 2) if shed_queue_depth is None
                 else shed_queue_depth)
        shed_rec = _shed_leg(servers, cap, trace, pools, slo_s,
                             shed_window or window, depth)

    # ---- equality gate (post-timing; futures cache their results) ----
    rejections = _gate(done_s, pools, lambda f: sticky_label)
    rejections += _gate(done_r, pools,
                        lambda f: f.decision.construction)
    if shed_rec is not None:
        rejections += shed_rec["gate_rejections"]

    record = {
        "metric": "traffic-shaped serving: cost-model scheme router vs "
                  "sticky engine (entries=%d, entry_size=%d, prf=%d, "
                  "bursty open-loop trace: %d arrivals / %d queries, "
                  "cap=%d, slo=%dms, 1 device)"
                  % (n, entry_size, prf, len(trace), total_q, cap,
                     int(slo_ms)),
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "value": q_r,
        "unit": "queries/sec",
        "vs_baseline": round(q_r / q_s, 4) if q_s else None,
        "baseline": "sticky-scheme ServingEngine (the binary-GGM "
                    "heuristic) on the identical seeded trace and key "
                    "pools",
        "p99_vs_baseline": round(router_leg["p99_ms"]
                                 / sticky_leg["p99_ms"], 4)
        if sticky_leg["p99_ms"] and router_leg["p99_ms"] is not None
        else None,
        "slo_ms": slo_ms,
        "trace": {"kind": "bursty", "seed": seed,
                  "duration_s": duration_s, "on_rate": on_rate,
                  "off_rate": off_rate, "calibration": calibration,
                  "arrivals": len(trace), "queries": total_q,
                  "cap": cap, "reps": reps, "window": window},
        "sticky": sticky_leg,
        "router": router_leg,
        "cost_table": router.cost_table(),
        "gate_rejections": rejections,
        "checked": rejections == 0,  # every served batch matched the
        #                              CPU oracle (DPF.eval_cpu)
    }
    if shed_rec is not None:
        record["shed_leg"] = shed_rec
    record["obs"] = record_sections()
    if not quiet:
        print(json.dumps(record), flush=True)
    return record


def _shed_leg(servers, cap, trace, pools, slo_s, window, depth) -> dict:
    """The router with admission control armed (``slo_s``,
    ``max_queue_depth=depth``, ``shed=True``) on the trace squeezed 4x:
    p99 of admitted arrivals stays bounded and the overload shows up as
    counted sheds.  Reuses the main router's prepared servers."""
    from .router import SchemeRouter
    router = SchemeRouter(None, servers=servers, cap=cap, probe=True,
                          slo_s=slo_s, max_queue_depth=depth, shed=True)
    squeezed = loadgen.squeeze(trace, 4.0)

    def submit(a, j):
        dec = router.route(a.batch)
        keys, _ = _batch_for(pools[dec.construction], j, a.batch)
        return router.submit(dec, keys)

    lats, done, makespan, sheds, shed_q = replay(squeezed, submit,
                                                 window=window)
    counters = router.counters()
    return {
        "qps_admitted": int((loadgen.total_queries(squeezed) - shed_q)
                            / makespan),
        "makespan_s": round(makespan, 4),
        "shed_batches": sheds, "shed_queries": shed_q,
        **_slo_stats(lats, slo_s),
        "engine_shed_batches": counters.shed_batches,
        "slo_s": slo_s, "max_queue_depth": depth, "window": window,
        "gate_rejections": _gate(done, pools,
                                 lambda f: f.decision.construction),
    }


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--entry-size", type=int, default=16)
    ap.add_argument("--cap", type=int, default=128)
    ap.add_argument("--prf", type=int, default=0,
                    help="PRF id (default 0=DUMMY; 2=ChaCha20, "
                         "3=AES128)")
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--duration", type=float, default=7.0,
                    help="trace duration in seconds")
    ap.add_argument("--on-rate", type=float, default=320.0,
                    help="burst arrival rate (arrivals/sec in ON "
                         "windows)")
    ap.add_argument("--off-rate", type=float, default=2.0)
    ap.add_argument("--on-load", type=float, default=None,
                    help="calibrate instead: ON windows keep the sticky "
                         "engine busy this share of the time (by its "
                         "probed costs), OFF windows --off-load")
    ap.add_argument("--off-load", type=float, default=0.3)
    ap.add_argument("--slo-ms", type=float, default=250.0)
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--distinct", type=int, default=16)
    ap.add_argument("--shed-queue-depth", type=int, default=None)
    ap.add_argument("--shed-window", type=int, default=None)
    ap.add_argument("--no-shed-leg", action="store_true")
    ap.add_argument("--device", default=None,
                    help="server device (default: the CUDA card)")
    ap.add_argument("--dryrun", action="store_true",
                    help="tiny trace and table smoke: exercises every "
                         "leg in seconds, makes no performance claim")
    ap.add_argument("--out", help="also write the JSON record to a file")
    args = ap.parse_args(argv)
    common = dict(prf=args.prf, seed=args.seed, slo_ms=args.slo_ms,
                  shed_leg=not args.no_shed_leg, device=args.device,
                  shed_queue_depth=args.shed_queue_depth,
                  shed_window=args.shed_window)
    if args.dryrun:
        record = load_bench(n=512, entry_size=8, cap=16, duration_s=1.5,
                            on_rate=30.0, reps=1, distinct=8, **common)
    else:
        rates = (dict(on_rate=None, on_load=args.on_load,
                      off_load=args.off_load)
                 if args.on_load is not None
                 else dict(on_rate=args.on_rate, off_rate=args.off_rate))
        record = load_bench(n=args.n, entry_size=args.entry_size,
                            cap=args.cap, duration_s=args.duration,
                            reps=args.reps, distinct=args.distinct,
                            **rates, **common)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
            f.write("\n")
    return record


if __name__ == "__main__":
    main()
