"""Capacity-planning benchmark: twin fidelity, planner, autoscaler.

Port of ``dpf_tpu/plan/bench_plan.py`` (``python -m
dpf_tpu_torch.benchmark --plan``).  Four gated legs over one cost table
probed on the device (``SchemeRouter``'s CUDA-event probes on the
card):

* **fidelity** — the headline gate.  The digital twin
  (``plan/twin.py``) simulates the IDENTICAL seeded traces the real
  open-loop harness (``serve/bench_load.replay``) replays through a
  real ``ServingEngine`` over the same bucket ladder, and the record
  gates predicted-vs-measured p99 (plain bursty + diurnal legs) and
  shed rate (admission-armed leg on the squeezed trace) within the
  tolerance band (``TOLERANCE``).  The twin's dispatch model is the
  engine's own (``ServingEngine.dispatch_blocking``): a CPU server
  computes in the client thread, the card's engine enqueues its parts
  on a CUDA stream and returns (at its ``max_in_flight``); the record
  names the model.
* **planner** — ``plan/capacity.plan_fleet`` headroom sweep; the
  record gates that the emitted curve is monotone in offered load
  (more qps never plans fewer engines — enforced by construction,
  asserted from the record).
* **autoscale (twin)** — ``plan/autoscale.AutoscalePolicy`` evaluated
  over a two-day diurnal trace (``loadgen.concat_traces``) with one
  injected engine death at the first peak; gates that the autoscaled
  fleet holds availability and p99-under-SLO while spending STRICTLY
  fewer engine-hours than the static peak-sized fleet on the same
  trace and fault plan.
* **autoscale (real)** — the same policy driving a ``ReplicaPool`` of
  real ``ServingEngine`` replicas: scale-up builds + warms a real
  engine, scale-down drains via ``ServingEngine.drain()`` then
  ``close()`` (post-close submit must raise ``EngineClosed``), every
  served batch equality-gated against the scalar oracle
  (``DPF.eval_cpu``), like every serving bench.

With ``on_rate=None`` the fidelity trace is calibrated to the sticky
engine's probed per-bucket costs: ON windows keep it busy ``on_load``
of the time (``bench_load.offered_rate``).  Runs on the card unless
``--device cpu`` is given:

    python -m dpf_tpu_torch.benchmark --plan [--dryrun] [--device cpu]
        [--on-load X | --on-rate R] [--out FILE]
"""

from __future__ import annotations

import json

import numpy as np
import torch

from ..obs import FLIGHT, record_sections
from ..obs.metrics import register_planner
from ..serve import loadgen
from ..serve.bench_load import (_batch_for, _gate, _key_pool,
                                offered_rate, replay)
from ..serve.engine import EngineClosed, ServingEngine
from ..utils.profiling import quantile
from .autoscale import AutoscalePolicy, ReplicaPool
from .capacity import plan_fleet, required_replicas
from .twin import PLAN_STATS, CostTable, FleetConfig, simulate

#: The diurnal fidelity trace's base rate as a share of its peak
#: (``dpf_tpu``'s 4/s under a peak of 80/s at its default ON rate).
DIURNAL_BASE_SHARE = 1 / 20

#: The fidelity tolerance band (``dpf_tpu``'s).  The twin
#: predicts from per-bucket blocking-dispatch costs alone — it carries
#: no host-side decode/GC/scheduler noise — so the p99 gate allows a
#: relative error plus a fixed slack (the slack dominates for
#: light-load legs where p99 is a few service times; the relative term
#: dominates under queueing, where p99 is backlog-shaped and scales
#: with the cost-table error).  Shed rate is gated absolutely: both
#: sides shed by the same ring-p99/queue-depth triggers, so the rates
#: must land close even when individual latencies wobble.
TOLERANCE = {"p99_rel": 0.50, "p99_slack_ms": 40.0, "shed_abs": 0.15}


def _p99_ms(lats) -> float | None:
    if not lats:
        return None
    ms = sorted(x * 1e3 for x in lats)
    return round(quantile(ms, 0.99, presorted=True), 3)


def _p99_within(real_ms, twin_ms, tol) -> bool:
    if real_ms is None or twin_ms is None:
        return real_ms is None and twin_ms is None
    return (abs(twin_ms - real_ms)
            <= tol["p99_slack_ms"] + tol["p99_rel"] * real_ms)


def _real_leg(make_engine, trace, pools, label, *, window, reps) -> dict:
    """Replay ``trace`` through a real engine (fresh per rep — the
    admission ring must start clean); keep the best-qps rep, the same
    selection rule as the --load legs.  ``"_blocking"`` is the engines'
    dispatch model."""
    total_q = loadgen.total_queries(trace)
    best = None
    for _ in range(max(1, reps)):
        eng = make_engine()

        def submit(a, j):
            keys, _ = _batch_for(pools[label], j, a.batch)
            return eng.submit(keys)

        lats, done, makespan, sheds, shed_q = replay(trace, submit,
                                                     window=window)
        offered = len(trace)
        qps = int((total_q - shed_q) / makespan) if makespan else 0
        leg = {
            "qps": qps, "makespan_s": round(makespan, 4),
            "p99_ms": _p99_ms(lats),
            "shed_batches": sheds, "shed_queries": shed_q,
            "shed_rate": round(sheds / offered, 4) if offered else 0.0,
            "_done": done, "_blocking": eng.dispatch_blocking,
        }
        if best is None or qps > best["qps"]:
            best = leg
    return best


def _twin_view(summary: dict) -> dict:
    """The slice of a twin summary the fidelity legs compare/record."""
    return {k: summary[k] for k in ("qps", "makespan_s", "p99_ms",
                                    "shed_batches", "shed_rate",
                                    "availability")}


def _autoscale_twin(cost, label: str, cap: int, sizes, *, window: int,
                    seed: int, max_replicas: int) -> dict:
    """The autoscaler's twin leg: two diurnal days + one engine death.

    The trace is generated at a fixed nominal rate and then
    ``scale_rate``-compressed so the PEAK offers ~2.5x one replica's
    service capacity (from the cost table) — the leg is calibrated in
    service units, so it exercises real scale-up pressure on any
    backend speed.  All policy clocks (decision cadence, cooldown,
    spin-up, rebuild) are sized relative to the compressed day for the
    same reason."""
    cap_bucket = sizes[-1]
    svc = max(cost.service_s(label, cap_bucket), 1e-7)
    nominal_peak, day_s = 40.0, 8.0
    day = loadgen.diurnal_trace(base_rate=nominal_peak / 10,
                                peak_rate=nominal_peak, period_s=day_s,
                                duration_s=day_s, cap=cap, seed=seed)
    two_days = loadgen.concat_traces(day, day)
    # compress so peak offered load = 2.5x one replica's capacity
    factor = 2.5 / (nominal_peak * svc)
    trace = loadgen.scale_rate(two_days, factor)
    span_s = trace[-1].t if trace else 1.0
    slo_s = 50 * svc
    dt = span_s / 64
    # one engine death at the first diurnal peak (the worst moment)
    peak_t = trace[len(day) // 2].t if len(day) // 2 < len(trace) else 0
    j_death = next((j for j, a in enumerate(trace) if a.t >= peak_t),
                   len(trace) // 4)
    fault_plan = {"seed": seed,
                  "specs": [{"kind": "engine_death", "start": j_death,
                             "p": 1.0}]}

    fleet_kw = dict(bucket_sizes=sizes, window=window,
                    spinup_s=dt / 2, rebuild_s=4 * dt,
                    retry_max_attempts=4)
    # the static comparator: the planner's peak-sized fleet, up for the
    # whole two days (what you deploy without an autoscaler)
    static_req = required_replicas(
        trace, cost, label=label, slo_s=slo_s, fleet_kw=dict(fleet_kw),
        seed=seed, max_replicas=max_replicas)
    r_static = max(2, static_req.replicas)
    static_fleet = FleetConfig(replicas={label: r_static},
                               dispatch_blocking=False, slo_s=slo_s,
                               **fleet_kw)
    static = simulate(trace, cost, static_fleet, seed=seed,
                      fault_plan=fault_plan,
                      record_events=False).summary()

    policy = AutoscalePolicy(min_replicas=1,
                             max_replicas=max(r_static + 1, 4),
                             decide_every_s=dt, cooldown_s=2 * dt,
                             p99_low_frac=0.6)
    auto_fleet = FleetConfig(replicas={label: 1},
                             dispatch_blocking=False, slo_s=slo_s,
                             **fleet_kw)
    auto = simulate(trace, cost, auto_fleet, seed=seed,
                    fault_plan=fault_plan, autoscaler=policy,
                    record_events=False).summary()

    slo_ms = round(slo_s * 1e3, 3)
    gates = {
        "availability": auto["availability"] >= 0.99,
        "p99_under_slo": (auto["p99_ms"] is not None
                          and auto["p99_ms"] <= slo_ms),
        "fewer_engine_hours": (auto["engine_hours"]
                               < static["engine_hours"]),
        "scaled_up": auto["autoscale"]["ups"] >= 1,
        "death_injected": auto["faults_injected"].get("engine_death",
                                                      0) == 1,
    }
    auto_rec = dict(auto)
    auto_rec["autoscale"] = {
        "ups": auto["autoscale"]["ups"],
        "downs": auto["autoscale"]["downs"],
        "log": auto["autoscale"]["log"][:24],   # bounded in the record
    }
    return {
        "trace": {"kind": "2x diurnal + engine_death", "seed": seed,
                  "arrivals": len(trace), "death_at_arrival": j_death,
                  "rate_scale": round(factor, 4),
                  "peak_util_target": 2.5},
        "slo_ms": slo_ms,
        "static_replicas": r_static,
        "static": {k: static[k] for k in
                   ("availability", "p99_ms", "engine_hours",
                    "shed_rate")},
        "autoscaled": auto_rec,
        "engine_hours_saved": round(
            static["engine_hours"] - auto["engine_hours"], 6),
        "policy": policy.as_dict(),
        "gates": gates,
        "ok": all(gates.values()),
    }


def _autoscale_real(router, label: str, pools, cap: int, *,
                    window: int, seed: int, slo_s: float) -> dict:
    """The autoscaler's real-engine smoke: the same policy driving a
    ``ReplicaPool`` of real engines over a short bursty trace, then a
    forced up/down cycle so both transitions run even if the policy
    held.  Gated on oracle equality of every served batch and on the
    post-close ``EngineClosed`` rejection."""
    srv = router.server(label)
    policy = AutoscalePolicy(min_replicas=1, max_replicas=3,
                             decide_every_s=0.05, cooldown_s=0.1)
    pool = ReplicaPool(
        lambda: ServingEngine(srv, max_in_flight=2,
                              buckets=router.buckets, warmup=True,
                              label=label),
        policy=policy, initial=1)
    trace = loadgen.bursty_trace(on_rate=30.0, off_rate=2.0, on_s=0.5,
                                 off_s=0.5, duration_s=1.5, cap=cap,
                                 seed=seed)

    def submit(a, j):
        pool.step(slo_s=slo_s)      # the serving-loop control tick
        keys, _ = _batch_for(pools[label], j, a.batch)
        return pool.submit(keys)

    lats, done, makespan, sheds, _ = replay(trace, submit,
                                            window=window)
    pool.scale_up()                 # force both transitions
    forced_down = pool.scale_down()
    rejections = _gate(done, pools, lambda f: label)
    eng0 = pool.replicas[0]
    engine_seconds = pool.close()
    try:
        eng0.submit([])
        closed_ok = False
    except EngineClosed:
        closed_ok = True
    ok = (rejections == 0 and forced_down and closed_ok
          and pool.scale_ups >= 1 and pool.scale_downs >= 1
          and sheds == 0)
    return {
        "arrivals": len(trace), "p99_ms": _p99_ms(lats),
        "makespan_s": round(makespan, 4),
        "scale_ups": pool.scale_ups, "scale_downs": pool.scale_downs,
        "engine_seconds": round(engine_seconds, 4),
        "gate_rejections": rejections,
        "closed_rejects_submit": closed_ok,
        "ok": ok,
    }


def plan_bench(n=4096, entry_size=16, cap=128, prf=0, *, seed=11,
               duration_s=6.0, on_rate=160.0, on_load=1.5, slo_ms=250.0,
               reps=2, distinct=16, window=8, max_replicas=16,
               device=None, quiet=False) -> dict:
    """Run the four planning legs on ``device`` (None = the card) and
    return the ``--plan`` record.  ``on_rate=None`` calibrates the
    fidelity trace's ON rate to the sticky engine's probed costs
    (``on_load`` busy)."""
    from ..api import resolve_device
    from ..serve.router import SchemeRouter, resolve_sticky
    from ..tune.serve_tune import cached_cost_table

    dev = resolve_device(device)
    FLIGHT.clear()      # scope the embedded flight tail to this bench
    register_planner(PLAN_STATS)
    table = np.random.default_rng(seed ^ 0x91a7).integers(
        0, 2 ** 31, (n, entry_size), dtype=np.int32, endpoint=False)
    router = SchemeRouter(table, prf=prf, cap=cap, probe=True, device=dev)
    # the construction under test: the sticky resolution (what a
    # DPF(scheme="auto") deployment pins), same rule as --load
    label, resolved_from = resolve_sticky(n, entry_size, prf, cap,
                                          device=dev)
    srv = router.server(label)
    pools = {label: _key_pool(srv, n, distinct,
                              b"plan-%s" % label.encode())}
    # the twin's service-time input: the probe-seeded live cost model
    # (satellite of the same snapshot --load now embeds); the tuning-
    # cache recovery path rides along for auditability
    cost_snapshot = router.cost_table()
    cached = cached_cost_table(n=n, entry_size=entry_size, cap=cap,
                               prf_method=prf, device=dev)
    cost = CostTable(cost_snapshot)
    sizes = tuple(router.buckets.sizes)
    slo_s = slo_ms / 1e3
    calibration = None
    if on_rate is None:
        on_rate = offered_rate(on_load, True, router.buckets,
                               lambda b: router.cost(label, b))
        calibration = {"on_load": on_load, "sticky_probe_ms": {
            b: 1e3 * router.cost(label, b) for b in sizes}}
    # ---- fidelity: twin vs the real harness on identical traces ------
    bursty = loadgen.bursty_trace(on_rate=on_rate, off_rate=2.0,
                                  on_s=1.0, off_s=2.0,
                                  duration_s=duration_s, cap=cap,
                                  seed=seed, n=n)
    diurnal = loadgen.diurnal_trace(base_rate=DIURNAL_BASE_SHARE
                                    * on_rate / 2,
                                    peak_rate=on_rate / 2,
                                    period_s=duration_s / 2,
                                    duration_s=duration_s, cap=cap,
                                    seed=seed, n=n)
    squeezed = loadgen.squeeze(bursty, 4.0)
    depth = max(2, window // 2)
    plain_kw = dict(max_in_flight=2, buckets=router.buckets,
                    warmup=True, label=label)
    shed_kw = dict(plain_kw, slo_s=slo_s, max_queue_depth=depth,
                   shed=True)
    plain_fkw = dict(replicas={label: 1}, bucket_sizes=sizes,
                     max_in_flight=2, window=window)
    shed_fkw = dict(plain_fkw, slo_s=slo_s, max_queue_depth=depth,
                    shed=True)
    specs = [
        ("bursty", bursty, plain_kw, plain_fkw, "p99"),
        ("diurnal", diurnal, plain_kw, plain_fkw, "p99"),
        ("bursty_4x_shed", squeezed, shed_kw, shed_fkw, "shed"),
    ]
    legs, violations, done_all = [], 0, []
    for name, trace, eng_kw, fleet_kw, gated in specs:
        real = _real_leg(lambda: ServingEngine(srv, **eng_kw), trace,
                         pools, label, window=window, reps=reps)
        done_all.append(real.pop("_done"))
        blocking = real.pop("_blocking")
        fleet = FleetConfig(dispatch_blocking=blocking, **fleet_kw)
        twin = _twin_view(simulate(trace, cost, fleet, seed=seed,
                                   record_events=False).summary())
        leg = {"name": name, "arrivals": len(trace),
               "queries": loadgen.total_queries(trace),
               "gated": gated, "real": real, "twin": twin}
        if gated == "p99":
            leg["p99_within"] = _p99_within(real["p99_ms"],
                                            twin["p99_ms"], TOLERANCE)
            ok = leg["p99_within"]
        else:
            leg["shed_within"] = (abs(twin["shed_rate"]
                                      - real["shed_rate"])
                                  <= TOLERANCE["shed_abs"])
            ok = leg["shed_within"]
        if not ok:
            violations += 1
        legs.append(leg)
    fidelity = {
        "dispatch_model": "blocking" if blocking else "async",
        "window": window,
        "tolerance": TOLERANCE,
        "legs": legs,
        "violations": violations,
        "checked": violations == 0,
    }
    p99_errs = [abs(leg["twin"]["p99_ms"] - leg["real"]["p99_ms"])
                / leg["real"]["p99_ms"]
                for leg in legs if leg["gated"] == "p99"
                and leg["real"]["p99_ms"]]
    worst_rel = round(max(p99_errs), 4) if p99_errs else None

    # ---- planner: headroom sweep, monotone by construction -----------
    planner = plan_fleet(bursty, cost, label=label, slo_s=slo_s,
                         load_scales=(0.5, 1.0, 1.5, 2.0), seed=seed,
                         fleet_kw=dict(bucket_sizes=sizes,
                                       window=window),
                         max_replicas=max_replicas)

    # ---- autoscaler: twin (gated) + real-engine smoke ----------------
    auto_twin = _autoscale_twin(cost, label, cap, sizes, window=window,
                                seed=seed, max_replicas=max_replicas)
    auto_real = _autoscale_real(router, label, pools, cap,
                                window=window, seed=seed, slo_s=slo_s)

    # ---- oracle equality over every real served batch ----------------
    rejections = sum(_gate(done, pools, lambda f: label)
                     for done in done_all)
    rejections += auto_real["gate_rejections"]

    record = {
        "metric": "digital-twin capacity planning: twin fidelity vs "
                  "the real open-loop harness + planner + autoscaler "
                  "(entries=%d, entry_size=%d, prf=%d, construction="
                  "%s, cap=%d, slo=%dms, 1 device)"
                  % (n, entry_size, prf, label, cap, int(slo_ms)),
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "value": worst_rel,
        "unit": "worst twin-vs-measured p99 relative error",
        "construction": label,
        "resolved_from": resolved_from,
        "slo_ms": slo_ms,
        "trace": {"kind": "bursty+diurnal", "seed": seed,
                  "duration_s": duration_s, "on_rate": on_rate,
                  "calibration": calibration,
                  "cap": cap, "window": window, "reps": reps},
        # the twin's exact inputs, embedded so every number above is
        # reproducible from the record alone (simulate() is a pure
        # function of these)
        "cost_table": cost_snapshot,
        "cost_table_cached": cached,
        "fleet": FleetConfig(dispatch_blocking=blocking,
                             **plain_fkw).as_dict(),
        "fidelity": fidelity,
        "planner": planner,
        "autoscale_twin": auto_twin,
        "autoscale_real": auto_real,
        "plan_stats": {
            "twin_runs": PLAN_STATS.twin_runs,
            "sim_arrivals": PLAN_STATS.sim_arrivals,
            "sweeps": PLAN_STATS.sweeps,
            "scale_ups": PLAN_STATS.scale_ups,
            "scale_downs": PLAN_STATS.scale_downs,
        },
        "gate_rejections": rejections,
        "checked": (violations == 0 and bool(planner["monotone"])
                    and auto_twin["ok"] and auto_real["ok"]
                    and rejections == 0),
    }
    if sorted(k for k, v in auto_twin["gates"].items() if not v) == [
            "availability"]:
        record["known_deviation"] = (
            "the twin's autoscale leg fails availability alone: it "
            "compresses its trace by the cap bucket's cost, so where "
            "bucket costs grow with the bucket (the card's) the peak stays "
            "under one replica and the engine death leaves none until the "
            "rebuild; checked stays False until that policy is repaired")
    record["obs"] = record_sections()
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
                    help="PRF id (default 0=DUMMY; 2=ChaCha20, "
                         "3=AES128)")
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--duration", type=float, default=6.0,
                    help="fidelity trace duration in seconds")
    ap.add_argument("--on-rate", type=float, default=None,
                    help="burst arrival rate of the fidelity trace "
                         "(default: calibrated by --on-load; the dry "
                         "run's is 30)")
    ap.add_argument("--on-load", type=float, default=1.5,
                    help="busy share the ON windows give the sticky "
                         "engine by its probed costs")
    ap.add_argument("--device", default=None,
                    help="cpu to run the plain versions (default: the "
                         "card)")
    ap.add_argument("--slo-ms", type=float, default=250.0)
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--dryrun", action="store_true",
                    help="tiny trace/table smoke (CI): every leg and "
                         "gate in seconds, no perf claims")
    ap.add_argument("--out", help="also write the JSON record to a file")
    args = ap.parse_args(argv)
    if args.dryrun:
        record = plan_bench(n=512, entry_size=8, cap=16, prf=args.prf,
                            seed=args.seed, duration_s=1.5,
                            on_rate=args.on_rate or 30.0,
                            slo_ms=args.slo_ms, reps=1, distinct=8,
                            max_replicas=6, device=args.device)
    else:
        record = plan_bench(n=args.n, entry_size=args.entry_size,
                            cap=args.cap, prf=args.prf, seed=args.seed,
                            duration_s=args.duration,
                            on_rate=args.on_rate, on_load=args.on_load,
                            slo_ms=args.slo_ms, reps=args.reps,
                            max_replicas=16, device=args.device)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
            f.write("\n")
    return record


if __name__ == "__main__":
    main()
