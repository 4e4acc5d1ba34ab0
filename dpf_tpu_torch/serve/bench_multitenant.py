"""Multi-tenant noisy-neighbour bench: isolation inside one process.

Port of ``dpf_tpu/serve/bench_multitenant.py``.  Serves tenants with
distinct (N, E) tables plus one tenant SHARING another's table and
bucket ladder through one ``TenantRouter`` (``serve/tenant.py``) over one
``TableRegistry``, and measures each tenant's SLO attainment in three
legs over the same seeded open-loop traces:

1. **solo**: each tenant's trace replayed alone (the baseline the
   isolation tolerance is measured against);
2. **combined**: every tenant's trace merged by time and replayed
   together under the deficit-round-robin scheduler, then once more
   with the largest table demoted first (``cold_table``: its first
   dispatch promotes it, host permutes and uploads, while the others
   serve; the port's addition, not part of ``checked``);
3. **noisy-neighbour chaos**: the victim's trace is squeezed 4x AND its
   router runs a seeded ``FaultPlan`` (dispatch errors, an engine
   death).  The victim degrades (counted sheds, absorbed faults) while
   every OTHER tenant should hold availability 1.0 and a p99 within
   ``TOLERANCE`` (1.5x) of its solo baseline, or within the slack.

The slack is one overlap quantum: ``SLACK_BATCHES`` batches stacked
ahead of a bystander's, each costing the probed device time of the
largest tenant's top bucket on the construction its router would pick
(``dpf_tpu``'s CPU figure was 12 ms; the port derives it on whatever
device it runs).  Every served batch in every leg is checked bit for
bit against the CPU oracle (``DPF.eval_cpu`` of each pool key);
``checked`` requires >= 3 distinct (N, E) shapes, 0 gate escapes, every
bystander isolated in the chaos leg, a degraded victim, the shared
ladder, and per-tenant series in the record's metrics and flight
sections.  A table-sharing tenant draws its keys from its table
owner's pool (the same servers and table, so the same oracle rows).

    python -m dpf_tpu_torch.serve.bench_multitenant [--prf ID]
        [--duration S] [--distinct K] [--device cpu] [--dryrun]
        [--full-width] [--out FILE]

runs on the card unless ``--device cpu`` is given; the record names the
device.  ``--full-width`` serves the card's tenants: 2^20 x 16 (cap
512), 2^18 x 8 (cap 256), a 2^16 x 4 victim (cap 128), and a tenant
sharing the first table.
"""

from __future__ import annotations

import json
import queue
import threading
import time

import numpy as np
import torch

from ..obs import FLIGHT, record_sections
from . import loadgen
from .bench_load import _batch_for, _key_pool, _slo_stats
from .engine import LoadShed
from .faults import FaultPlan, FaultSpec, RetryPolicy
from .registry import TableRegistry
from .tenant import TenantRouter, TenantSpec

#: bystander p99 tolerance against its solo baseline in the chaos leg
TOLERANCE = 1.5
#: the additive slack of the p99 check, in batches of the largest
#: tenant's top bucket: the solo baseline has no cross-tenant overlap,
#: but in any concurrent leg a bystander's batch can queue behind
#: batches other tenants dispatched first (no scheduler preempts a
#: dispatched kernel), so its p99, the top sample of ~100, sits one
#: overlap quantum (up to ~3 stacked batches) above solo even with no
#: victim at all.  The ratio binds only once the delta exceeds it.
SLACK_BATCHES = 3

#: tenant tables of the three sizes (dryrun: seconds on the CPU; the
#: default: the CPU rehearsal; full width: the card)
CONFIGS = {
    "dryrun": {
        "alpha": dict(n=512, e=8, cap=16, on_rate=16.0, weight=1.0),
        "bravo": dict(n=256, e=4, cap=16, on_rate=16.0, weight=1.0),
        "victim": dict(n=128, e=4, cap=8, on_rate=24.0, weight=1.0),
        "delta": dict(n=512, e=8, cap=16, on_rate=12.0, weight=1.0,
                      table_name="alpha"),
    },
    "default": {
        "alpha": dict(n=4096, e=16, cap=64, on_rate=24.0, weight=1.0),
        "bravo": dict(n=2048, e=8, cap=64, on_rate=24.0, weight=1.0),
        "victim": dict(n=1024, e=4, cap=32, on_rate=40.0, weight=1.0),
        "delta": dict(n=4096, e=16, cap=64, on_rate=16.0, weight=1.0,
                      table_name="alpha"),
    },
    "full_width": {
        "alpha": dict(n=1 << 20, e=16, cap=512, on_rate=24.0,
                      weight=1.0),
        "bravo": dict(n=1 << 18, e=8, cap=256, on_rate=24.0, weight=1.0),
        "victim": dict(n=1 << 16, e=4, cap=128, on_rate=40.0,
                       weight=1.0),
        "delta": dict(n=1 << 20, e=16, cap=512, on_rate=16.0,
                      weight=1.0, table_name="alpha"),
    },
}


def _mk_trace(cfg: dict, seed: int, duration_s: float) -> list:
    return loadgen.bursty_trace(
        on_rate=cfg["on_rate"], off_rate=cfg["on_rate"] / 8.0,
        on_s=0.6, off_s=0.6, duration_s=duration_s, cap=cfg["cap"],
        seed=seed, n=cfg["n"])


def _merge(traces: dict) -> list:
    """Merge per-tenant traces into one (tenant, arrival, tenant-local
    j) stream ordered by scheduled time."""
    tagged = []
    for name, trace in traces.items():
        tagged.extend((a.t, name, a, j) for j, a in enumerate(trace))
    tagged.sort(key=lambda r: r[0])
    return [(name, a, j) for _, name, a, j in tagged]


def _replay_mt(tr: TenantRouter, tagged, pools, *,
               inject: bool = False):
    """Open-loop replay of a merged multi-tenant stream.

    Submission follows the trace schedule (open loop, one thread;
    latency = completion - scheduled arrival).  Each tenant has its OWN
    resolver thread: one tenant's slow batches must never delay the
    point where another tenant's completions are measured.  A tenant's
    sheds (at submit or at dispatch) and fault-exhausted errors are that
    tenant's unavailability, never an exception out of the loop.
    Arrival indices reach the fault injector only when ``inject`` is
    True (the chaos leg).  Returns ``(lats, done, fails, sheds,
    makespan_s)``: ``lats`` per tenant for ok batches, ``done`` the
    gate's (tenant, arrival, j, future) list, ``fails`` / ``sheds``
    per-tenant counts.
    """
    names = {name for name, _, _ in tagged}
    lats = {n: [] for n in names}
    fails = {n: 0 for n in names}
    sheds = {n: 0 for n in names}     # resolver threads only
    admit_sheds = {n: 0 for n in names}   # submit thread only
    done = {n: [] for n in names}
    queues = {n: queue.Queue() for n in names}
    t0 = time.perf_counter()

    def resolver(name):
        while True:
            item = queues[name].get()
            if item is None:
                return
            a, j, fut = item
            try:
                fut.result()
            except LoadShed:
                sheds[name] += 1
                continue
            except Exception:
                fails[name] += 1
                continue
            lats[name].append((time.perf_counter() - t0) - a.t)
            done[name].append((name, a, j, fut))

    threads = [threading.Thread(target=resolver, args=(n,), daemon=True)
               for n in names]
    for th in threads:
        th.start()
    for name, a, j in tagged:
        while True:
            now = time.perf_counter() - t0
            if now >= a.t:
                break
            time.sleep(min(a.t - now, 0.005))

        def keys_for(lb, _name=name, _j=j, _b=a.batch):
            return _batch_for(pools[_name][lb], _j, _b)[0]
        try:
            fut = tr.submit(name, a.batch, keys_for,
                            arrival=j if inject else None)
        except LoadShed:
            admit_sheds[name] += 1
            continue
        queues[name].put((a, j, fut))
    for n in names:
        queues[n].put(None)
    for th in threads:
        th.join()
    for n in names:
        sheds[n] += admit_sheds[n]
    all_done = [x for n in sorted(names) for x in done[n]]
    return lats, all_done, fails, sheds, time.perf_counter() - t0


def _leg_stats(traces, lats, fails, sheds, escapes_by, slo_s) -> dict:
    out = {}
    for name, trace in traces.items():
        arrivals = len(trace)
        esc = escapes_by.get(name, 0)
        ok = len(lats[name]) - esc
        out[name] = {
            "arrivals": arrivals,
            "ok_batches": ok,
            "shed_batches": sheds[name],
            "failed_batches": fails[name],
            "gate_escapes": esc,
            "availability": (round(ok / arrivals, 4) if arrivals
                             else None),
            **_slo_stats(lats[name], slo_s),
        }
    return out


def _escapes_by_tenant(done, pools) -> dict:
    by = {}
    for name, a, j, fut in done:
        label = fut.decision.construction
        _, refs = pools[name][label]
        _, idxs = _batch_for(pools[name][label], j, a.batch)
        if not np.array_equal(fut.result(), refs[idxs]):
            by[name] = by.get(name, 0) + 1
    return by


def slack_ms(tr: TenantRouter, cfgs: dict) -> tuple:
    """``SLACK_BATCHES`` x the probed cost (ms) of the largest tenant's
    top bucket on the construction its cost model picks there; returns
    (slack ms, that tenant, its construction, one batch's ms)."""
    name = max((n for n in cfgs if not cfgs[n].get("table_name")),
               key=lambda n: cfgs[n]["n"] * cfgs[n]["e"])
    r = tr.router(name)
    top = r.buckets.max
    costs = {lb: r.cost(lb, top) for lb in r.constructions
             if r.cost(lb, top) is not None}
    lb = min(costs, key=costs.get)
    one = 1e3 * costs[lb]
    return SLACK_BATCHES * one, name, lb, one


def multitenant_bench(*, seed: int = 16, duration_s: float = 5.0,
                      slo_ms: float = 400.0, burst: float = 4.0,
                      prf: int = 0, distinct: int = 8,
                      dryrun: bool = False, full_width: bool = False,
                      device=None, quiet: bool = False) -> dict:
    """Serve >= 3 distinct-(N, E) tenants (plus one table-sharing
    tenant) in one process and measure the noisy-neighbour isolation;
    returns the record."""
    from ..api import resolve_device

    dev = resolve_device(device)
    FLIGHT.clear()      # scope the embedded flight tail to this bench
    cfgs = CONFIGS["dryrun" if dryrun else
                   "full_width" if full_width else "default"]
    victim = "victim"
    slo_s = slo_ms / 1e3

    # ---- the victim's seeded fault plan (chaos leg only: specs match
    # arrival indices, and arrivals are only passed in that leg).  The
    # dispatch-error window is p=1.0 across ALL constructions so retry
    # and failover cannot absorb it: the victim MUST degrade. ----
    plan = FaultPlan([
        FaultSpec("dispatch_error", p=1.0, start=2, stop=6),
        FaultSpec("engine_death", construction="logn", start=6),
    ], seed=seed)

    # ---- one registry + tenant router over all tables ----------------
    rng = np.random.default_rng(seed ^ 0x7e4a47)
    registry = TableRegistry(prf_method=prf, device=dev)
    tr = TenantRouter(registry)
    tables = {}
    for name, cfg in cfgs.items():
        shared = cfg.get("table_name")
        if shared is None:
            tables[name] = rng.integers(0, 2 ** 31, (cfg["n"], cfg["e"]),
                                        dtype=np.int32, endpoint=False)
        spec = TenantSpec(
            name,
            table=None if shared else tables[name],
            table_name=shared,
            weight=cfg["weight"], cap=cfg["cap"], slo_s=slo_s,
            max_in_flight=2 if name == victim else 4,
            max_queue_depth=4 if name == victim else None,
            shed=(name == victim),
            plan=plan if name == victim else None,
            retry=RetryPolicy(max_attempts=3, backoff_s=0.002,
                              seed=seed),
            breaker_failures=3, breaker_reset_s=0.5)
        tr.add_tenant(spec)

    # the table-sharing tenant must reuse the collided shape's ladder
    shared_pairs = [(a, b) for a in cfgs for b in cfgs
                    if cfgs[b].get("table_name") == a]
    ladder_shared = all(
        tr.router(a).buckets is tr.router(b).buckets
        for a, b in shared_pairs)

    # ---- CPU-oracle key pools (per table, per construction) ----------
    pools = {}
    for name, cfg in cfgs.items():
        if cfg.get("table_name"):
            continue
        r = tr.router(name)
        pools[name] = {
            lb: _key_pool(r.server(lb), cfg["n"], distinct,
                          b"mt-%s-%s" % (name.encode(), lb.encode()))
            for lb in r.constructions}
    for name, cfg in cfgs.items():
        if cfg.get("table_name"):
            pools[name] = pools[cfg["table_name"]]

    traces = {name: _mk_trace(cfg, seed + i, duration_s)
              for i, (name, cfg) in enumerate(cfgs.items())}
    slack, slack_tenant, slack_label, slack_one = slack_ms(tr, cfgs)

    gate_escapes = 0

    # ---- leg 1: solo baselines ---------------------------------------
    solo = {}
    for name in cfgs:
        tagged = _merge({name: traces[name]})
        lats, done, fails, sheds, mk = _replay_mt(tr, tagged, pools)
        esc = _escapes_by_tenant(done, pools)
        gate_escapes += sum(esc.values())
        solo[name] = _leg_stats({name: traces[name]}, lats, fails,
                                sheds, esc, slo_s)[name]
        solo[name]["makespan_s"] = round(mk, 4)

    # ---- leg 2: combined (all tenants at once) -----------------------
    tagged = _merge(traces)
    lats, done, fails, sheds, mk = _replay_mt(tr, tagged, pools)
    esc = _escapes_by_tenant(done, pools)
    gate_escapes += sum(esc.values())
    combined = _leg_stats(traces, lats, fails, sheds, esc, slo_s)
    # queries of ok batches over the makespan
    ok_queries = sum(a.batch for name, a, j, fut in done)
    combined_qps = int(ok_queries / mk) if mk else 0
    combined_leg = {"per_tenant": combined,
                    "qps_ok": combined_qps,
                    "makespan_s": round(mk, 4)}

    # ---- leg 2b: combined again, the largest table demoted first ----
    # its first dispatch promotes it (host permutes + uploads) while
    # every other tenant serves: what a cold table costs its neighbours
    promotions0 = registry.counters["promotions"]
    registry.demote(slack_tenant)
    tagged = _merge(traces)
    lats, done, fails, sheds, mk = _replay_mt(tr, tagged, pools)
    esc = _escapes_by_tenant(done, pools)
    gate_escapes += sum(esc.values())
    promote_s = [e["seconds"] for e in FLIGHT.dump()
                 if e.get("kind") == "registry"
                 and e.get("action") == "promote"
                 and e.get("table") == slack_tenant]
    cold_leg = {"demoted": slack_tenant,
                "promotions": registry.counters["promotions"] - promotions0,
                "promotion_s": promote_s[-1] if promote_s else None,
                "per_tenant": _leg_stats(traces, lats, fails, sheds, esc,
                                         slo_s),
                "makespan_s": round(mk, 4)}

    # ---- leg 3: noisy-neighbour chaos --------------------------------
    chaos_traces = dict(traces)
    chaos_traces[victim] = loadgen.squeeze(traces[victim], burst)
    tagged = _merge(chaos_traces)
    lats, done, fails, sheds, mk = _replay_mt(tr, tagged, pools,
                                              inject=True)
    esc = _escapes_by_tenant(done, pools)
    gate_escapes += sum(esc.values())
    chaos = _leg_stats(chaos_traces, lats, fails, sheds, esc, slo_s)
    injector = tr.router(victim).injector
    chaos_leg = {
        "victim": victim, "burst_factor": burst,
        "per_tenant": chaos,
        "makespan_s": round(mk, 4),
        "injected": injector.stats() if injector is not None else None,
    }

    # ---- isolation ---------------------------------------------------
    isolation = {}
    for name in cfgs:
        if name == victim:
            continue
        solo_p99 = solo[name]["p99_ms"]
        chaos_p99 = chaos[name]["p99_ms"]
        ratio = (round(chaos_p99 / solo_p99, 4)
                 if solo_p99 and chaos_p99 is not None else None)
        p99_ok = (ratio is None or ratio <= TOLERANCE
                  or chaos_p99 - solo_p99 <= slack)
        isolation[name] = {
            "availability": chaos[name]["availability"],
            "p99_solo_ms": solo_p99, "p99_chaos_ms": chaos_p99,
            "p99_vs_solo": ratio, "p99_slack_ms": round(slack, 4),
            "isolated": (chaos[name]["availability"] == 1.0
                         and chaos[name]["gate_escapes"] == 0
                         and p99_ok),
        }
    victim_degraded = (
        chaos[victim]["availability"] is not None
        and chaos[victim]["availability"] < 1.0)

    # ---- per-tenant series in the record -----------------------------
    # metrics snapshot series keys render labels as {a="x",tenant="y"};
    # a tenant is visible when some series carries its label
    obs = record_sections()
    metric_tenants = set()
    for fam in obs["metrics"].values():
        for labels in fam.get("series", {}):
            for name in cfgs:
                if 'tenant="%s"' % name in labels:
                    metric_tenants.add(name)
    flight_tenants = {e["tenant"] for e in FLIGHT.dump()
                      if "tenant" in e}
    per_tenant_series = {
        "metrics_tenants": sorted(metric_tenants),
        "flight_tenants": sorted(flight_tenants),
        "visible": all(n in metric_tenants for n in cfgs)
        and len(flight_tenants) > 0,
    }

    shapes = {(c["n"], c["e"]) for c in cfgs.values()
              if not c.get("table_name")}
    checked = (
        len(shapes) >= 3
        and gate_escapes == 0
        and all(i["isolated"] for i in isolation.values())
        and victim_degraded
        and ladder_shared
        and per_tenant_series["visible"]
    )

    tr.close()          # park the per-tenant dispatch workers
    record = {
        "metric": "multi-tenant serving isolation: %d tenants "
                  "(%d distinct (N,E) shapes + 1 table-sharing) under "
                  "one TenantRouter; noisy-neighbor chaos leg = %gx "
                  "victim burst + seeded fault plan (slo=%dms, 1 "
                  "device)"
                  % (len(cfgs), len(shapes), burst, int(slo_ms)),
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "value": combined_qps,
        "unit": "queries/sec",
        "slo_ms": slo_ms,
        "tolerance": TOLERANCE,
        "slack": {"ms": round(slack, 4), "batches": SLACK_BATCHES,
                  "tenant": slack_tenant, "construction": slack_label,
                  "batch_ms": round(slack_one, 4)},
        "tenants": {name: {"n": cfg["n"], "entry_size": cfg["e"],
                           "cap": cfg["cap"], "on_rate": cfg["on_rate"],
                           "weight": cfg["weight"],
                           "table": cfg.get("table_name", name),
                           "victim": name == victim}
                    for name, cfg in cfgs.items()},
        "trace": {"kind": "bursty", "seed": seed,
                  "duration_s": duration_s, "distinct": distinct},
        "solo": solo,
        "combined": combined_leg,
        "cold_table": cold_leg,
        "chaos": chaos_leg,
        "isolation": isolation,
        "victim_degraded": victim_degraded,
        "ladder_shared": ladder_shared,
        "per_tenant_series": per_tenant_series,
        "faults": {"plan": plan.as_dict()},
        "scheduler": tr.stats(),
        "gate_escapes": gate_escapes,
        "checked": bool(checked),
        "obs": obs,
    }
    if not checked:
        # a failed check must be diagnosable: dump the full flight ring
        record["flight_on_gate_failure"] = FLIGHT.dump()
    if not quiet:
        print(json.dumps(record), flush=True)
    return record


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=16)
    ap.add_argument("--duration", type=float, default=5.0,
                    help="per-tenant trace duration in seconds")
    ap.add_argument("--slo-ms", type=float, default=400.0)
    ap.add_argument("--burst", type=float, default=4.0,
                    help="victim burst factor in the chaos leg")
    ap.add_argument("--prf", type=int, default=0,
                    help="PRF id (default 0=DUMMY; 2=ChaCha20, "
                         "3=AES128)")
    ap.add_argument("--distinct", type=int, default=None,
                    help="distinct keys a table and construction "
                         "(default 6 dryrun, 8 otherwise)")
    ap.add_argument("--device", default=None,
                    help="server device (default: the CUDA card)")
    ap.add_argument("--full-width", action="store_true",
                    help="the card's tenants (2^20, 2^18, 2^16 rows)")
    ap.add_argument("--dryrun", action="store_true",
                    help="tiny tables and traces smoke: exercises every "
                         "leg in seconds, makes no performance claim")
    ap.add_argument("--out", help="also write the JSON record to a file")
    args = ap.parse_args(argv)
    distinct = args.distinct or (6 if args.dryrun else 8)
    record = multitenant_bench(
        seed=args.seed,
        duration_s=1.2 if args.dryrun else args.duration,
        slo_ms=args.slo_ms, burst=args.burst, prf=args.prf,
        distinct=distinct, dryrun=args.dryrun,
        full_width=args.full_width, device=args.device)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
            f.write("\n")
    return record


if __name__ == "__main__":
    main()
