"""Observability benchmark: joint trace digest, OpenMetrics export,
flight-recorder fault attribution, and the tracing overhead bound.

Port of ``dpf_tpu/obs/bench_trace.py`` (``benchmark.py --trace``).  Four
legs over one serving shape (entries=4096, entry_size=16, cap=128, seed
11, ``dpf_tpu``'s defaults), through the cost-model router
(``serve.router.SchemeRouter``) on the card:

* **profile**: a short closed-loop burst with both capture layers on,
  the host span tracer (``obs.tracer``) and a ``torch.profiler`` trace
  of the same run (``utils.profiling.trace``); the record embeds
  ``joint_digest``, host span self times beside the card's kernel and
  copy self times;
* **openmetrics**: the OpenMetrics exposition after that traffic; the
  gate asserts the engine, router, breaker and flight families;
* **chaos flight**: a replay slice under a seeded fault plan through
  ``submit_resilient``; every injected fault in the flight ring must
  join back to the route decision of its batch (arrival index and
  construction); the gate asserts at least one attributed fault;
* **overhead**: the closed-loop replay of the bursty trace, tracing off
  against on, as ``dpf_tpu`` times it: contiguous segments, each an
  adjacent (off, on) pair in alternating order, scored by the median of
  the paired relative makespan deltas; the gate bounds it at 2%.  On the
  card an arrival at 4096 rows is about a millisecond of host work and
  a pair's delta spreads by +-10% on a shared host, so the port takes
  more pairs than ``dpf_tpu``'s 36: segments of two engine windows
  (16 arrivals) and 16 passes, 976 pairs.  Both legs of a pair
  start from the same router state (cost model, exploration clocks,
  arrival rates) with the cost model held, so every arrival routes to
  the same construction in each.  The record also keeps the ratio of
  the two legs' summed makespans.

The replay is closed-loop (back to back, in arrival order): an
open-loop replay's rate is set by its arrival schedule and would hide
the overhead under test.

    python -m dpf_tpu_torch.obs.bench_trace [--dryrun] [--device cpu]
        [--python-spans] [--out FILE]

runs on the card unless ``--device cpu`` is given (the dryrun's gates
skip the overhead bound, as ``dpf_tpu``'s do).
"""

from __future__ import annotations

import gc
import json
import os
import time
from collections import deque

import numpy as np

from ..serve import loadgen
from ..serve.bench_load import _batch_for, _key_pool
from ..utils.profiling import DEFAULT_TRACE_DIR
from ..utils.profiling import trace as profiler_trace
from . import tracer as obs_tracer
from .flight import FLIGHT, flight_dump
from .metrics import REGISTRY
from .tracer import joint_digest

#: OpenMetrics families the gate requires
REQUIRED_FAMILIES = (
    "dpf_engine_batches_submitted_total",
    "dpf_engine_latency_seconds_bucket",
    "dpf_router_cost_seconds",
    "dpf_router_routed_from_total",
    "dpf_breaker_state",
    "dpf_flight_events_total",
)


def _closed_loop(submit, sizes, *, window: int = 8) -> float:
    """Back-to-back replay of ``sizes`` through ``submit(j, b)`` (a
    future) with at most ``window`` outstanding; the makespan in s."""
    t0 = time.perf_counter()
    outstanding = deque()
    for j, b in enumerate(sizes):
        while len(outstanding) >= window:
            outstanding.popleft().result()
        outstanding.append(submit(j, b))
    while outstanding:
        outstanding.popleft().result()
    return time.perf_counter() - t0


def _router_submit(router, pools):
    def submit(j, b):
        dec = router.route(b)
        keys, _ = _batch_for(pools[dec.construction], j, b)
        return router.submit(dec, keys)
    return submit


def _attribute_faults(events) -> list:
    """Join fault events to the route decision of their batch: the same
    arrival index and construction.  Returns ``[{fault, route}]``."""
    routes = {}
    for e in events:
        if e["kind"] == "route" and "arrival" in e:
            routes[(e["arrival"], e["construction"])] = e
    out = []
    for e in events:
        if e["kind"] != "fault":
            continue
        rt = routes.get((e.get("arrival"), e.get("construction")))
        if rt is not None:
            out.append({"fault": e, "route": rt})
    return out


def _median(xs):
    xs = sorted(xs)
    mid = len(xs) // 2
    return xs[mid] if len(xs) % 2 else (xs[mid - 1] + xs[mid]) / 2.0


def trace_bench(n=4096, entry_size=16, cap=128, prf=0, *, seed=11,
                duration_s=7.0, on_rate=320.0, distinct=16, reps=16,
                window=8, profile_arrivals=48,
                constructions=None,
                trace_dir=None, overhead_gate=True, device=None,
                native_spans=True, quiet=False) -> dict:
    """Run the four legs; returns the ``--trace`` record."""
    from ..api import resolve_device
    from ..serve.faults import FaultPlan, FaultSpec, RetryPolicy
    from ..serve.router import LABELS, SchemeRouter

    dev = resolve_device(device)
    labels = tuple(constructions or LABELS)
    trace_dir = trace_dir or DEFAULT_TRACE_DIR
    FLIGHT.clear()          # scope the ring to this bench
    table = np.random.default_rng(seed ^ 0x0b5).integers(
        0, 2 ** 31, (n, entry_size), dtype=np.int32, endpoint=False)
    arrivals = loadgen.bursty_trace(
        on_rate=on_rate, off_rate=2.0, on_s=1.0, off_s=2.0,
        duration_s=duration_s, cap=cap, seed=seed, n=n)
    sizes = loadgen.batch_sizes(arrivals)
    total_q = sum(sizes)

    router = SchemeRouter(table, prf=prf, cap=cap, probe=True,
                          constructions=labels, device=dev)
    pools = {lb: _key_pool(router.server(lb), n, distinct,
                           b"trace-%s" % lb.encode()) for lb in labels}
    submit = _router_submit(router, pools)

    # ---- leg 1: joint host + device profile over a short burst -------
    t = obs_tracer.enable()
    t.clear()
    cfg = "obs_trace_n%d_e%d_cap%d" % (n, entry_size, cap)
    with profiler_trace(cfg, base_dir=trace_dir) as tdir:
        _closed_loop(submit, sizes[:profile_arrivals], window=window)
    joint = joint_digest(tracer=t, trace_dir=tdir)
    host_spans = {s["span"] for s in
                  (joint["host"] or {}).get("top_spans", ())}
    spans_jsonl = os.path.join(tdir, "host_spans.jsonl")
    chrome_json = os.path.join(tdir, "host_spans.chrome.json")
    t.export_jsonl(spans_jsonl)
    t.export_chrome(chrome_json)
    obs_tracer.disable()

    # ---- leg 2: the OpenMetrics exposition after that traffic --------
    text = REGISTRY.openmetrics()
    families_present = {f: (("\n%s" % f) in ("\n" + text))
                        for f in REQUIRED_FAMILIES}

    # ---- leg 3: chaos slice -> flight-recorder fault attribution -----
    plan = FaultPlan([
        # max_fires below the retry policy's max_attempts: one arrival
        # can absorb every fire and still succeed on its last attempt
        FaultSpec(kind="dispatch_error", start=2, stop=24, p=0.5,
                  max_fires=3),
        FaultSpec(kind="latency", start=4, stop=24, p=0.25,
                  latency_s=0.005, max_fires=4),
    ], seed=seed)
    inj = plan.injector()
    chaos_router = SchemeRouter(
        None, servers={lb: router.server(lb) for lb in labels},
        cap=cap, probe=True, injector=inj,
        retry=RetryPolicy(max_attempts=4, backoff_s=0.001, seed=seed))
    flight_mark = FLIGHT.recorded

    def chaos_submit(j, b):
        inj.begin_arrival(j)
        return chaos_router.submit_resilient(
            b, lambda lb: _batch_for(pools[lb], j, b)[0])
    _closed_loop(chaos_submit, sizes[:max(24, profile_arrivals)],
                 window=window)
    chaos_events = [e for e in flight_dump() if e["seq"] > flight_mark]
    attributed = _attribute_faults(chaos_events)

    # ---- leg 4: tracing on against off, paired segment replays -------
    # dpf_tpu's estimator: the replay is cut into contiguous segments,
    # each timed as an adjacent (off, on) pair with the order alternating,
    # and the score is the median of the paired relative deltas (load on
    # a shared host moves whole replays by far more than the spans cost;
    # adjacent legs see the same load).  Both legs of a pair start from
    # one held router state (cost model, exploration clocks, arrival
    # rates) with the cost model frozen, so they route every arrival
    # alike.  Every traced leg records into one tracer, as a process
    # with tracing on does; an untimed traced pass over the whole replay
    # warms every shape and fills its ring, so the legs time the steady
    # state.  The segments are two engine windows long: the noise of a
    # pair's delta on a shared host falls more slowly with the segment's
    # length than the number of pairs a replay yields grows.
    start = tuple(dict(d) for d in (router._costs, router._obs_age,
                                    router._arrivals))
    tracer = obs_tracer.Tracer(native=native_spans)

    def held_observe(label, bucket, seconds):
        router._obs_age[(label, bucket)] = 0

    def timed(tracing_on: bool, seg) -> float:
        router._costs, router._obs_age, router._arrivals = (
            dict(d) for d in start)
        router._observe = held_observe
        obs_tracer._TRACER = tracer if tracing_on else None
        try:
            return _closed_loop(submit, seg, window=window)
        finally:
            obs_tracer._TRACER = None
            del router._observe

    timed(True, sizes)
    gc.collect()
    nseg = max(1, len(sizes) // (2 * window))
    bounds = [i * len(sizes) // nseg for i in range(nseg + 1)]
    segments = [sizes[a:b] for a, b in zip(bounds, bounds[1:]) if b > a]
    deltas, mk_off, mk_on = [], 0.0, 0.0
    pair = 0
    for _ in range(max(1, reps)):
        for seg in segments:
            t = {}
            for on in ((False, True) if pair % 2 == 0 else (True, False)):
                t[on] = timed(on, seg)
            pair += 1
            mk_off += t[False]
            mk_on += t[True]
            deltas.append((t[True] - t[False]) / t[False] * 100.0)
    overhead_pct = round(_median(deltas), 3)
    # makespans are per-leg sums over every pair (reps full replays)
    mk_off /= max(1, reps)
    mk_on /= max(1, reps)
    qps_off = int(total_q / mk_off)
    qps_on = int(total_q / mk_on)

    device_ok = joint["device"] is not None and (
        joint["device"]["device_ms"] > 0
        and (dev.type == "cpu" or joint["device"]["tracks"]
             == "cuda_device"))
    record = {
        "metric": "end-to-end serving observability: per-batch span "
                  "tracing + torch.profiler joint digest, OpenMetrics "
                  "export, flight-recorder fault attribution, and the "
                  "full-stack tracing overhead (entries=%d, entry_size=%d, "
                  "prf=%d, cap=%d, closed-loop replay of the seeded bursty "
                  "trace: %d arrivals / %d queries, device %s)"
                  % (n, entry_size, prf, cap, len(sizes), total_q, dev),
        "value": overhead_pct,
        "unit": "percent makespan overhead, tracing on vs off (median "
                "of paired adjacent segment replays)",
        "vs_baseline": round(qps_on / qps_off, 4) if qps_off else None,
        "baseline": "the identical closed-loop replay with the span "
                    "tracer disabled (flight recorder and counters stay "
                    "on in both legs)",
        "device": str(dev),
        "trace": {"kind": "bursty", "seed": seed,
                  "duration_s": duration_s, "on_rate": on_rate,
                  "arrivals": len(sizes), "queries": total_q,
                  "cap": cap, "reps": reps, "window": window,
                  "segment": 2 * window},
        "constructions": list(labels),
        "profile": {
            "config": cfg, "arrivals": profile_arrivals,
            "joint_digest": joint,
            "host_spans_jsonl": spans_jsonl,
            "host_spans_chrome": chrome_json,
        },
        "openmetrics": {
            "families_required": dict(families_present),
            "lines": len(text.splitlines()),
            "text": text,
        },
        "chaos_flight": {
            "plan": plan.as_dict(),
            "injected": dict(inj.injected),
            "events": len(chaos_events),
            "attributed_faults": len(attributed),
            "attribution_sample": attributed[:4],
            "flight_tail": chaos_events[-48:],
        },
        "overhead": {
            "qps_tracing_off": qps_off,
            "qps_tracing_on": qps_on,
            "makespan_off_s": round(mk_off, 4),
            "makespan_on_s": round(mk_on, 4),
            "makespan_ratio_pct": round((mk_on / mk_off - 1.0) * 100.0, 3),
            "segments": len(segments),
            "native_spans": tracer.native,
            "pairs": pair,
            "paired_deltas_pct": [round(d, 3) for d in sorted(deltas)],
            "overhead_pct": overhead_pct,
            "bound_pct": 2.0,
            "gated": bool(overhead_gate),
        },
        "checked": bool(
            joint["host"] is not None
            and {"submit", "dispatch"} <= host_spans
            and device_ok
            and all(families_present.values())
            and len(attributed) >= 1
            and (not overhead_gate or overhead_pct <= 2.0)),
    }
    if not quiet:
        print(json.dumps(record), flush=True)
    return record


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--entry-size", type=int, default=16)
    ap.add_argument("--cap", type=int, default=128)
    ap.add_argument("--prf", type=int, default=0,
                    help="PRF id (default 0=DUMMY; 2=ChaCha20, 3=AES128)")
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--duration", type=float, default=7.0)
    ap.add_argument("--on-rate", type=float, default=320.0)
    ap.add_argument("--reps", type=int, default=16,
                    help="passes over the replay's segment pairs")
    ap.add_argument("--trace-dir", default=None)
    ap.add_argument("--python-spans", action="store_true",
                    help="time the overhead leg with the plain-Python span "
                         "ring instead of the C one")
    ap.add_argument("--device", default=None,
                    help="cpu to run the plain versions (default: the card)")
    ap.add_argument("--dryrun", action="store_true",
                    help="tiny trace and table smoke: every leg in "
                         "seconds, no overhead gate")
    ap.add_argument("--out", help="also write the JSON record to a file")
    args = ap.parse_args(argv)
    if args.dryrun:
        record = trace_bench(n=512, entry_size=8, cap=16, prf=args.prf,
                             seed=args.seed, duration_s=1.5, on_rate=30.0,
                             distinct=8, reps=1, profile_arrivals=12,
                             constructions=("logn", "radix4"),
                             trace_dir=args.trace_dir, overhead_gate=False,
                             device=args.device)
    else:
        record = trace_bench(n=args.n, entry_size=args.entry_size,
                             cap=args.cap, prf=args.prf, seed=args.seed,
                             duration_s=args.duration, on_rate=args.on_rate,
                             reps=args.reps, trace_dir=args.trace_dir,
                             device=args.device,
                             native_spans=not args.python_spans)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
            f.write("\n")
    return record


if __name__ == "__main__":
    main()
