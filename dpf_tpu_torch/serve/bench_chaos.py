"""Chaos benchmark: availability under seeded fault injection.

Port of ``dpf_tpu/serve/bench_chaos.py``.  Replays one seeded bursty
trace (``serve/loadgen.py``) through a fault-tolerant router stack
(``SchemeRouter`` + ``RetryPolicy`` + per-construction circuit breakers
+ ``EngineSupervisor``) under escalating fault plans
(``serve/faults.py``):

* **baseline**: no faults, the availability reference for this card and
  trace;
* **faults**: >= 10% injected dispatch failures across every
  construction, latency spikes and silently corrupted result shares;
* **chaos**: the faults leg PLUS the death of the cost model's favourite
  construction mid-trace: its traffic fails over to the healthy engines
  over the same table while the supervisor rebuilds it and its breaker
  walks open -> half-open -> closed.

**Availability** is the correct-within-SLO fraction: an arrival counts
only if its batch was served, checked bit for bit against the CPU oracle
(``DPF.eval_cpu`` of each pool key, inline, before the client accepts
the answer), and completed within the SLO from its *scheduled* arrival.
The inline check is also the corruption detector: every injected
corruption must be caught and the batch served again
(``corruptions_detected == injected``, ``gate_escapes == 0``).  Every
injection decision is a function of the plan's seed, so a run replays
the same fault sequence on the same trace.

    python -m dpf_tpu_torch.serve.bench_chaos [--n N] [--prf ID]
        [--cap C] [--duration S] [--on-rate R] [--distinct K]
        [--device cpu] [--dryrun] [--out FILE]

runs on the card unless ``--device cpu`` is given; the record names the
device.
"""

from __future__ import annotations

import json
import time

import numpy as np
import torch

from ..core.expand import DeadlineExceeded
from ..obs import FLIGHT, flight_dump, record_sections
from ..utils.profiling import swallowed_snapshot
from .bench_load import _batch_for, _key_pool, _slo_stats, replay
from .engine import LoadShed
from .faults import FaultPlan, FaultSpec, RetryPolicy
from . import loadgen


class _FailedBatch:
    """Future-shaped stand-in for an arrival whose serve attempts were
    exhausted: the replay resolves it like any future, the availability
    count takes it as unavailable."""
    ok = False

    def done(self) -> bool:
        return True

    def result(self):
        return None


class _VerifiedFuture:
    """A routed future whose ``result()`` is the whole client protocol:
    resolve, check bit for bit against the oracle's rows, and on a
    failed check (an injected corruption) or a fault at resolution,
    serve the batch AGAIN through ``SchemeRouter.submit_resilient``, up
    to ``client.max_reserves`` times.  The extra serves land in the
    measured latency (against the scheduled arrival)."""

    __slots__ = ("client", "a", "j", "fut", "ok", "_value")

    def __init__(self, client, a, j, fut):
        self.client = client
        self.a = a
        self.j = j
        self.fut = fut
        self.ok = None
        self._value = None

    def done(self) -> bool:
        return self.ok is not None or self.fut.done()

    def result(self):
        if self.ok is not None:
            return self._value
        c = self.client
        out = None
        for attempt in range(c.max_reserves + 1):
            try:
                out = np.asarray(self.fut.result())
            except (LoadShed, DeadlineExceeded):
                raise
            except Exception:
                out = None
            if out is not None:
                lb = self.fut.decision.construction
                _, idxs = _batch_for(c.pools[lb], self.j, self.a.batch)
                if np.array_equal(out, c.pools[lb][1][idxs]):
                    self.ok = True
                    self._value = out
                    return out
                c.detected_corruptions += 1
            if attempt >= c.max_reserves:
                break
            c.reserves += 1
            try:
                self.fut = c.router.submit_resilient(
                    self.a.batch, c.keys_for(self.j, self.a.batch))
            except Exception:
                break
        self.ok = False
        self._value = out
        c.failed_batches += 1
        return out


class _ChaosClient:
    """The submit side of one chaos leg: every arrival through
    ``submit_resilient`` (retry + failover), its future wrapped in the
    check-and-serve-again protocol above."""

    def __init__(self, router, pools, injector, *, max_reserves=3):
        self.router = router
        self.pools = pools
        self.injector = injector
        self.max_reserves = max_reserves
        self.detected_corruptions = 0
        self.failed_batches = 0
        self.reserves = 0

    def keys_for(self, j, b):
        return lambda lb: _batch_for(self.pools[lb], j, b)[0]

    def submit(self, a, j):
        if self.injector is not None:
            self.injector.begin_arrival(j)
        try:
            fut = self.router.submit_resilient(a.batch,
                                               self.keys_for(j, a.batch))
        except (LoadShed, DeadlineExceeded):
            raise
        except Exception:
            self.failed_batches += 1
            return _FailedBatch()
        return _VerifiedFuture(self, a, j, fut)


def _fault_specs(*, dispatch_p: float, latency_p: float,
                 latency_s: float, corrupt_p: float) -> list:
    return [
        FaultSpec(kind="dispatch_error", p=dispatch_p),
        FaultSpec(kind="latency", p=latency_p, latency_s=latency_s),
        FaultSpec(kind="corrupt_shares", p=corrupt_p),
    ]


def _favorite(router, cap: int) -> str:
    """The cost model's favourite at the cap bucket after the probes:
    the construction whose death hurts most."""
    costs = {lb: router.cost(lb, cap) for lb in router.constructions}
    known = {lb: c for lb, c in costs.items() if c is not None}
    return (min(known, key=known.get) if known
            else router.constructions[0])


def _run_leg(servers, cap, trace, pools, slo_s, window, plan, *,
             retry, breaker_failures, breaker_reset_s,
             reclose_wait_s=10.0) -> tuple:
    """One replay of ``trace`` under ``plan`` through a fresh
    fault-tolerant router over the SHARED prepared servers; returns the
    leg's record (availability and recovery accounting) and the
    router."""
    from .router import SchemeRouter
    inj = plan.injector() if plan is not None else None
    router = SchemeRouter(None, servers=servers, cap=cap, probe=True,
                          injector=inj, retry=retry,
                          breaker_failures=breaker_failures,
                          breaker_reset_s=breaker_reset_s,
                          supervise=True)
    client = _ChaosClient(router, pools, inj)
    lats, done, makespan, _, _ = replay(trace, client.submit,
                                        window=window)
    router.drain()
    if router.supervisor is not None:
        router.supervisor.join(timeout=reclose_wait_s)
    # every breaker still open gets its half-open re-probe: the routing
    # path is the recovery check, so route until settled
    deadline = time.monotonic() + reclose_wait_s
    while (any(br.state != "closed" for br in router.breakers.values())
           and time.monotonic() < deadline):
        router.route(1)
        time.sleep(min(0.05, breaker_reset_s / 4))

    # ---- availability: correct within the SLO over ALL arrivals ----
    # done[i] and lats[i] are appended together by the replay loop
    ok_in_slo = sum(1 for (_, _, fut), lat in zip(done, lats)
                    if getattr(fut, "ok", False) and lat <= slo_s)
    escapes = 0
    for a, j, fut in done:      # check the final values again
        if not getattr(fut, "ok", False):
            continue
        lb = fut.fut.decision.construction
        _, idxs = _batch_for(pools[lb], j, a.batch)
        if not np.array_equal(fut.result(), pools[lb][1][idxs]):
            escapes += 1
    counters = router.counters()
    total = len(trace)
    rec = {
        "availability": round(ok_in_slo / total, 4) if total else None,
        "served_ok": ok_in_slo,
        "arrivals": total,
        "failed_batches": client.failed_batches,
        "reserves_after_gate": client.reserves,
        "makespan_s": round(makespan, 4),
        "qps": int(loadgen.total_queries(trace) / makespan)
        if makespan else None,
        **_slo_stats(lats, slo_s),
        "recovery": {
            "retries": counters.retries,
            "failovers": counters.failovers,
            "breaker_opens": counters.breaker_opens,
            "engine_restarts": counters.engine_restarts,
            "swallowed_errors": counters.swallowed_errors,
        },
        "breakers": {lb: br.as_dict()
                     for lb, br in router.breakers.items()},
        "route_counts": dict(router.route_counts),
    }
    if inj is not None:
        rec["faults"] = {
            "plan": plan.as_dict(),
            "injected": dict(inj.injected),
            "corruptions_injected": len(inj.corruptions),
            "corruptions_detected": client.detected_corruptions,
        }
    rec["gate_escapes"] = escapes
    return rec, router


def chaos_bench(n=4096, entry_size=16, cap=128, prf=0, *,
                seed=11, duration_s=6.0, on_rate=60.0, slo_ms=1000.0,
                dispatch_p=0.12, latency_p=0.05, latency_s=0.02,
                corrupt_p=0.03, window=8, distinct=16,
                breaker_failures=2, breaker_reset_s=0.4, device=None,
                quiet=False) -> dict:
    """Escalating fault plans over one seeded bursty trace; returns the
    record.  The three legs share one table upload per construction,
    one key pool and the oracle's rows (``distinct`` keys a
    construction: at N = 2^20 the CPU oracle costs ~2 s a radix-4 or
    sqrt-N key, so the card's run keeps the pool small)."""
    from ..api import resolve_device
    from .router import LABELS, build_servers

    dev = resolve_device(device)
    FLIGHT.clear()      # scope the embedded flight tail to this bench
    table = np.random.default_rng(seed ^ 0xc4a05).integers(
        0, 2 ** 31, (n, entry_size), dtype=np.int32, endpoint=False)
    trace = loadgen.bursty_trace(
        on_rate=on_rate, off_rate=2.0, on_s=1.0, off_s=2.0,
        duration_s=duration_s, cap=cap, seed=seed, n=n)
    slo_s = slo_ms / 1e3
    retry = RetryPolicy(max_attempts=4, backoff_s=0.002, seed=seed)

    servers = build_servers(table, LABELS, prf_method=prf, device=dev)
    pools = {lb: _key_pool(servers[lb], n, distinct,
                           b"chaos-%s" % lb.encode())
             for lb in LABELS}
    leg_kw = dict(retry=retry, breaker_failures=breaker_failures,
                  breaker_reset_s=breaker_reset_s)

    # ---- leg 1: baseline (no faults) ---------------------------------
    baseline, _ = _run_leg(servers, cap, trace, pools, slo_s, window,
                           FaultPlan((), seed=seed), **leg_kw)

    # ---- leg 2: dispatch errors + stragglers + corrupted shares ------
    fault_plan = FaultPlan(_fault_specs(
        dispatch_p=dispatch_p, latency_p=latency_p,
        latency_s=latency_s, corrupt_p=corrupt_p), seed=seed)
    faults_leg, fr = _run_leg(servers, cap, trace, pools, slo_s,
                              window, fault_plan, **leg_kw)

    # ---- leg 3: + the death of the cost model's favourite ------------
    victim = _favorite(fr, fr.buckets.max)
    kill_at = max(1, len(trace) // 3)
    chaos_plan = FaultPlan(_fault_specs(
        dispatch_p=dispatch_p, latency_p=latency_p,
        latency_s=latency_s, corrupt_p=corrupt_p)
        + [FaultSpec(kind="engine_death", construction=victim,
                     start=kill_at)], seed=seed)
    chaos_leg, cr = _run_leg(servers, cap, trace, pools, slo_s, window,
                             chaos_plan, **leg_kw)
    chaos_leg["victim"] = victim
    chaos_leg["killed_at_arrival"] = kill_at
    victim_states = [s for _, s in cr.breakers[victim].transitions]
    chaos_leg["victim_breaker_transitions"] = victim_states

    total_escapes = (baseline["gate_escapes"] + faults_leg["gate_escapes"]
                     + chaos_leg["gate_escapes"])
    record = {
        "metric": "fault-tolerant serving: availability (correct-"
                  "within-SLO fraction) under escalating seeded fault "
                  "plans — %.0f%% dispatch failures + stragglers + "
                  "corrupted shares + one engine death (entries=%d, "
                  "entry_size=%d, prf=%d, bursty trace: %d arrivals / "
                  "%d queries, cap=%d, slo=%dms, 1 device)"
                  % (dispatch_p * 100, n, entry_size, prf, len(trace),
                     loadgen.total_queries(trace), cap, int(slo_ms)),
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "value": chaos_leg["availability"],
        "unit": "availability",
        "vs_baseline": (round(chaos_leg["availability"]
                              / baseline["availability"], 4)
                        if baseline["availability"] else None),
        "baseline": "the identical router stack replaying the identical"
                    " seeded trace with no fault plan",
        "slo_ms": slo_ms,
        "trace": {"kind": "bursty", "seed": seed,
                  "duration_s": duration_s, "on_rate": on_rate,
                  "arrivals": len(trace),
                  "queries": loadgen.total_queries(trace),
                  "cap": cap, "window": window, "distinct": distinct},
        "retry_policy": {"max_attempts": retry.max_attempts,
                         "backoff_s": retry.backoff_s,
                         "backoff_mult": retry.backoff_mult,
                         "jitter": retry.jitter, "seed": retry.seed},
        "breaker": {"failures": breaker_failures,
                    "reset_s": breaker_reset_s},
        "baseline_leg": baseline,
        "faults_leg": faults_leg,
        "chaos_leg": chaos_leg,
        "swallowed_errors": swallowed_snapshot(),
        "gate_escapes": total_escapes,
        "checked": bool(
            total_escapes == 0
            and chaos_leg["availability"] is not None
            and chaos_leg["availability"] >= 0.99
            and chaos_leg["recovery"]["engine_restarts"] >= 1
            and victim_states[-1] == "closed"),
    }
    record["obs"] = record_sections()
    if not record["checked"]:
        # a failed check is what the flight recorder is for: embed the
        # FULL ring (routes, breaker walk, every injected fault)
        record["obs"]["flight_on_gate_failure"] = flight_dump()
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
                    help="trace duration in seconds")
    ap.add_argument("--on-rate", type=float, default=60.0,
                    help="burst arrival rate (arrivals/sec in ON "
                         "windows)")
    ap.add_argument("--slo-ms", type=float, default=1000.0)
    ap.add_argument("--dispatch-p", type=float, default=0.12,
                    help="per-dispatch injected failure probability")
    ap.add_argument("--corrupt-p", type=float, default=0.03,
                    help="per-batch injected share-corruption "
                         "probability")
    ap.add_argument("--distinct", type=int, default=16,
                    help="distinct keys a construction in the key pool")
    ap.add_argument("--device", default=None,
                    help="server device (default: the CUDA card)")
    ap.add_argument("--dryrun", action="store_true",
                    help="tiny trace and table smoke: exercises every "
                         "leg in seconds, makes no performance claim")
    ap.add_argument("--out", help="also write the JSON record to a file")
    args = ap.parse_args(argv)
    common = dict(prf=args.prf, seed=args.seed, slo_ms=args.slo_ms,
                  dispatch_p=args.dispatch_p, corrupt_p=args.corrupt_p,
                  device=args.device)
    if args.dryrun:
        record = chaos_bench(n=512, entry_size=8, cap=16, duration_s=1.5,
                             on_rate=20.0, distinct=8,
                             breaker_reset_s=0.2, **common)
    else:
        record = chaos_bench(n=args.n, entry_size=args.entry_size,
                             cap=args.cap, duration_s=args.duration,
                             on_rate=args.on_rate, distinct=args.distinct,
                             **common)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
            f.write("\n")
    return record


if __name__ == "__main__":
    main()
