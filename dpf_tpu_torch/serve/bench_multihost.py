"""Multi-host chaos benchmark: availability across a host's death
(port of ``dpf_tpu/serve/bench_multihost.py``).

Builds a serving cluster over one table (``parallel/cluster.py``:
row-sharded granules, scatter/gather front end, reshard-or-degrade
recovery) and replays one seeded bursty trace three times:

* **baseline** -- the full cluster, no failure;
* **chaos_degrade** -- one host dies a third of the way in; a front-end
  spare takes its granules;
* **chaos_reshard** -- the same death; its granules go to the
  survivors.

A fourth section, ``pir_group_routing``, gates batch-PIR routing by size
group (``parallel.cluster.ClusterPIRRouter``): routed dispatch must
equal the broadcast replay and the one-server oracle while sending
fewer size groups to the hosts.

Two modes run the same router and recovery code:

* ``multiprocess`` (default) -- one process per host
  (``parallel/cluster_worker.py`` over the socket transport); the chaos
  legs kill the victim worker at a fixed arrival, so the loss is a real
  process death seen through the transport (``HostUnreachable``).  A
  worker that cannot start fails the bench: it does not fall back to
  the simulated mode.
* ``simulated`` -- every host in-process; the death is an injected
  ``host_drop`` fault (deterministic under the plan's seed).

Every host stands on ``device`` (None = the card; the workers of one
machine share it).  Availability is the share of arrivals answered
correctly within the SLO: every merged answer is gated bit for bit
against the scalar oracle (``DPF.eval_cpu``) before the client takes
it, a failed gate re-serves through ``ClusterRouter.submit_resilient``,
and the flight recorder must hold each chaos leg's ``host_drop`` and the
``cluster_recovery`` that answered it.

    python -m dpf_tpu_torch.serve.bench_multihost [--dryrun] [--simulate]
        [--hosts H] [--device cpu] [--out FILE]
"""

from __future__ import annotations

import json
import sys

import numpy as np

from ..core import expand
from ..core.expand import DeadlineExceeded
from ..obs import FLIGHT, flight_dump, record_sections
from ..utils.profiling import note_swallowed, swallowed_snapshot
from .bench_load import _batch_for, _key_pool, _slo_stats, replay
from .engine import LoadShed
from .faults import FaultPlan, FaultSpec
from . import loadgen


class _FailedBatch:
    """Future-shaped sentinel for an arrival whose serve attempts were
    exhausted (counts unavailable in the availability fraction)."""
    ok = False

    def done(self) -> bool:
        return True

    def result(self):
        return None


class _VerifiedFuture:
    """The full client protocol for one scattered batch: resolve the
    merged share, bit-gate it against the scalar-oracle references,
    and on a failed gate or a resolve-time fault RE-SERVE through
    ``submit_resilient`` (the re-serve cost lands in the measured
    latency, so recovery is paid for inside the availability number)."""

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
                if np.array_equal(out, c.refs_for(self.j, self.a.batch)):
                    self.ok = True
                    self._value = out
                    return out
                c.detected_corruptions += 1
            if attempt >= c.max_reserves:
                break
            c.reserves += 1
            try:
                self.fut = c.cluster.submit_resilient(
                    c.keys_for(self.j, self.a.batch))
            except Exception:
                break
        self.ok = False
        self._value = out
        c.failed_batches += 1
        return out


class _ClusterClient:
    """The submit side of one leg: heartbeat sweep every
    ``hb_every`` arrivals (host loss is detectable BETWEEN dispatches),
    the multiprocess kill switch at the scripted arrival, then
    ``submit_resilient`` wrapped in the verify-and-reserve protocol."""

    def __init__(self, cluster, pool, injector, *, max_reserves=3,
                 hb_every=8, kill_at=None, victim_node=None):
        self.cluster = cluster
        self.pool = pool
        self.injector = injector
        self.max_reserves = max_reserves
        self.hb_every = hb_every
        self.kill_at = kill_at
        self.victim_node = victim_node      # RemoteHost to SIGKILL
        self.killed = False
        self.detected_corruptions = 0
        self.failed_batches = 0
        self.reserves = 0

    def keys_for(self, j, b):
        return _batch_for(self.pool, j, b)[0]

    def refs_for(self, j, b):
        _, idxs = _batch_for(self.pool, j, b)
        return self.pool[1][idxs]

    def submit(self, a, j):
        if self.injector is not None:
            self.injector.begin_arrival(j)
        if (self.victim_node is not None and not self.killed
                and self.kill_at is not None and j >= self.kill_at):
            self.victim_node.kill()         # a REAL process death
            self.killed = True
        if self.hb_every and j and j % self.hb_every == 0:
            self.cluster.check_hosts()
        try:
            fut = self.cluster.submit_resilient(
                self.keys_for(j, a.batch))
        except (LoadShed, DeadlineExceeded):
            raise
        except Exception:
            self.failed_batches += 1
            return _FailedBatch()
        return _VerifiedFuture(self, a, j, fut)


def _pir_routing_leg(*, prf, hosts, seed, dryrun=False, device=None) -> dict:
    """Batch-PIR routing by size group: a bin-sharded
    ``ClusterPIRRouter`` answers one round ``routed`` (each size group
    to its owner hosts only) and ``broadcast`` (every group to every
    host); both must equal the one-server oracle, and routing must send
    fewer size groups."""
    from ..apps.batch_pir import PrivateLookupClient, PrivateLookupServer
    from ..parallel.cluster import ClusterPIRRouter

    rng = np.random.default_rng(seed ^ 0x91A)
    if dryrun:
        n_pir, e = 1024, 4
        sizes = (150, 130, 60, 50, 20, 10)
    else:
        n_pir, e = 4096, 8
        sizes = (700, 650, 300, 260, 130, 120, 60, 50)
    table = rng.integers(0, 2**31, size=(n_pir, e), dtype=np.int32)
    universe = rng.permutation(n_pir)
    bins, off = [], 0
    for sz in sizes:
        bins.append(universe[off:off + sz].tolist())
        off += sz
    pir_hosts = max(2, min(hosts, 4))

    oracle_a = PrivateLookupServer(table, bins, prf=prf, scheme="logn",
                                   device=device)
    oracle_b = PrivateLookupServer(table, bins, prf=prf, scheme="logn",
                                   device=device)
    client = PrivateLookupClient(bins, oracle_a.bin_sizes, prf=prf,
                                 scheme="logn")
    wanted = [b[len(b) // 2] for b in bins]
    ka, kb, plan = client.make_queries(wanted)

    routed = ClusterPIRRouter(table, bins, hosts=pir_hosts, prf=prf,
                              scheme="logn", routed=True, device=device)
    bcast = ClusterPIRRouter(table, bins, hosts=pir_hosts, prf=prf,
                             scheme="logn", routed=False, device=device)
    ans_oracle = np.asarray(oracle_a.answer(ka))
    ans_routed = routed.answer(ka)
    ans_bcast = bcast.answer(ka)
    parity = bool(np.array_equal(ans_routed, ans_oracle)
                  and np.array_equal(ans_bcast, ans_oracle))
    rec = client.recover(ans_routed, np.asarray(oracle_b.answer(kb)),
                         plan)
    recover_ok = all(np.array_equal(rec[t], table[t]) for t in wanted)
    r_total = sum(routed.dispatch_counts.values())
    b_total = sum(bcast.dispatch_counts.values())
    return {
        "hosts": pir_hosts,
        "bins": len(bins),
        "bin_sizes": list(sizes),
        "group_sizes": list(routed.group_sizes),
        "owners": {int(n): lbs for n, lbs in routed.owners.items()},
        "bins_per_host": routed.stats()["bins_per_host"],
        "routed_dispatches": r_total,
        "broadcast_dispatches": b_total,
        "dispatch_counts_routed": dict(routed.dispatch_counts),
        "dispatch_counts_broadcast": dict(bcast.dispatch_counts),
        "dispatch_reduction": (round(1 - r_total / b_total, 4)
                               if b_total else None),
        "parity_vs_oracle": parity,
        "recover_ok": recover_ok,
        "checked": bool(parity and recover_ok and r_total < b_total),
    }


def _build_cluster(mode, table, hosts, *, oracle, buckets, policy,
                   injector, breaker_reset_s, table_seed, device):
    """A fresh cluster for one leg.  Returns (cluster, victim_node) —
    victim_node is the RemoteHost the chaos legs kill (None in
    simulated mode, where the injector supplies the death)."""
    from ..parallel.cluster import ClusterRouter

    if mode == "multiprocess":
        from ..parallel import cluster_net
        n, e = table.shape
        nodes = cluster_net.spawn_cluster(
            n, e, hosts, table_seed=table_seed,
            prf_method=oracle.prf_method, buckets=buckets, device=device,
            timeout_s=120.0)
        cluster = ClusterRouter(
            nodes, granule=n // hosts,
            table_perm=expand.permute_table(table), policy=policy,
            prf_method=oracle.prf_method,
            breaker_reset_s=breaker_reset_s,
            spare_engine_kw={"buckets": buckets},
            # warm the degrade spare before the chaos window, so a
            # failover is a copy to the device
            standby=True, device=device)
        return cluster, dict(zip([nd.label for nd in nodes], nodes))
    cluster = ClusterRouter.local(
        table, hosts=hosts, oracle=oracle, buckets=buckets,
        injector=injector, policy=policy,
        breaker_reset_s=breaker_reset_s, device=device)
    return cluster, None


def _run_leg(mode, table, hosts, trace, pool, oracle, *, buckets,
             policy, slo_s, window, seed, victim=None, kill_at=None,
             breaker_reset_s=0.4, table_seed=0, device=None) -> dict:
    """One replay of ``trace`` through a fresh cluster; chaos legs
    (victim set) lose that host at ``kill_at`` — by SIGKILL in
    multiprocess mode, by injected ``host_drop`` in simulated mode."""
    injector = None
    if mode == "simulated":
        specs = []
        if victim is not None:
            specs.append(FaultSpec(kind="host_drop", construction=victim,
                                   start=kill_at))
        injector = FaultPlan(specs, seed=seed).injector()
    seq0 = FLIGHT.recorded
    cluster, nodes = _build_cluster(
        mode, table, hosts, oracle=oracle, buckets=buckets,
        policy=policy, injector=injector,
        breaker_reset_s=breaker_reset_s, table_seed=table_seed,
        device=device)
    victim_node = nodes.get(victim) if (nodes and victim) else None
    try:
        cluster.warmup()
        client = _ClusterClient(cluster, pool, injector,
                                kill_at=kill_at if victim else None,
                                victim_node=victim_node)
        lats, done, makespan, _, _ = replay(trace, client.submit,
                                            window=window)
        cluster.drain()

        ok_in_slo = sum(1 for (_, _, fut), lat in zip(done, lats)
                        if getattr(fut, "ok", False) and lat <= slo_s)
        escapes = 0
        for a, j, fut in done:  # re-gate final values: escapes must be 0
            if not getattr(fut, "ok", False):
                continue
            if not np.array_equal(fut.result(),
                                  client.refs_for(j, a.batch)):
                escapes += 1
        counters = cluster.counters()
        # the attribution chain: THIS leg's flight events must contain
        # the host_drop and the recovery decision that answered it
        leg_events = [ev for ev in flight_dump()
                      if ev["seq"] > seq0
                      and ev["kind"] in ("host_drop", "cluster_recovery")]
        drops = [ev for ev in leg_events if ev["kind"] == "host_drop"]
        recoveries = [ev for ev in leg_events
                      if ev["kind"] == "cluster_recovery"
                      and ev.get("ok")]
        attributed = bool(
            victim is None
            or (any(ev.get("host") == victim for ev in drops)
                and any(ev.get("host") == victim
                        and ev.get("decision") == policy
                        for ev in recoveries)))
        total = len(trace)
        rec = {
            "mode": mode,
            "policy": policy,
            "availability": (round(ok_in_slo / total, 4)
                             if total else None),
            "served_ok": ok_in_slo,
            "arrivals": total,
            "failed_batches": client.failed_batches,
            "reserves_after_gate": client.reserves,
            "makespan_s": round(makespan, 4),
            "qps": (int(loadgen.total_queries(trace) / makespan)
                    if makespan else None),
            **_slo_stats(lats, slo_s),
            "recovery": {
                "retries": counters.retries,
                "failovers": counters.failovers,
                "breaker_opens": counters.breaker_opens,
                "engine_restarts": counters.engine_restarts,
                "swallowed_errors": counters.swallowed_errors,
            },
            "decision_counts": dict(cluster.decision_counts),
            "host_states": {lb: cluster.host_state(lb)
                            for lb in cluster.hosts},
            "assignment": {lb: list(g)
                           for lb, g in cluster.assignment.items()},
            "gate_escapes": escapes,
            "drop_attributed": attributed,
            "flight_events": leg_events,
        }
        if victim is not None:
            rec["victim"] = victim
            rec["killed_at_arrival"] = kill_at
        if injector is not None:
            rec["faults"] = {
                "plan": FaultPlan(injector.plan.specs,
                                  seed=injector.plan.seed).as_dict(),
                "injected": dict(injector.injected),
            }
        return rec
    finally:
        cluster.close()
        if nodes:
            for node in nodes.values():
                try:
                    node.kill()
                except Exception as e:
                    note_swallowed("cluster.peer_unreachable", e)


def multihost_bench(n=4096, entry_size=16, cap=128, prf=0, *,
                    hosts=4, mode="multiprocess", seed=14,
                    duration_s=6.0, on_rate=60.0, slo_ms=1000.0,
                    window=8, distinct=16, breaker_reset_s=0.4,
                    quiet=False, device=None) -> dict:
    """Baseline and host-death chaos legs over one seeded bursty trace on
    ``device`` (None = the card); returns the record."""
    import torch

    from ..api import DPF, resolve_device
    from ..parallel import cluster_net
    from ..utils.compat import has_cpu_multiprocess
    from .buckets import Buckets

    device = resolve_device(device)
    FLIGHT.clear()      # scope the embedded flight events to this bench
    table_seed = seed ^ 0x5107
    table = cluster_net.make_table(n, entry_size, table_seed)
    oracle = DPF(prf=prf, device="cpu")
    oracle.eval_init(table)
    trace = loadgen.bursty_trace(
        on_rate=on_rate, off_rate=2.0, on_s=1.0, off_s=2.0,
        duration_s=duration_s, cap=cap, seed=seed, n=n)
    slo_s = slo_ms / 1e3
    buckets = Buckets.default_sizes(cap)
    pool = _key_pool(oracle, n, distinct, b"multihost")
    victim = "host%d" % (hosts - 1)
    kill_at = max(1, len(trace) // 3)

    if mode not in ("multiprocess", "simulated"):
        raise ValueError("mode must be multiprocess or simulated (got %r)"
                         % (mode,))
    leg_kw = dict(buckets=buckets, slo_s=slo_s, window=window,
                  seed=seed, breaker_reset_s=breaker_reset_s,
                  table_seed=table_seed, device=device)
    baseline = _run_leg(mode, table, hosts, trace, pool, oracle,
                        policy="reshard", **leg_kw)
    degrade_leg = _run_leg(mode, table, hosts, trace, pool, oracle,
                           policy="degrade", victim=victim,
                           kill_at=kill_at, **leg_kw)
    reshard_leg = _run_leg(mode, table, hosts, trace, pool, oracle,
                           policy="reshard", victim=victim,
                           kill_at=kill_at, **leg_kw)
    pir_leg = _pir_routing_leg(prf=prf, hosts=hosts, seed=seed,
                               dryrun=n <= 1024, device=device)

    chaos_avail = [leg["availability"]
                   for leg in (degrade_leg, reshard_leg)]
    total_escapes = (baseline["gate_escapes"]
                     + degrade_leg["gate_escapes"]
                     + reshard_leg["gate_escapes"])
    record = {
        "metric": "multi-host serving cluster: availability (correct-"
                  "within-SLO fraction) across a host death — %d hosts "
                  "over one [%d x %d] table (prf=%d), one host lost at "
                  "arrival %d/%d, recovery by degrade (front-end spare) "
                  "and by re-shard over survivors (mode=%s; every "
                  "merged answer bit-gated against the scalar oracle)"
                  % (hosts, n, entry_size, prf, kill_at, len(trace),
                     mode),
        "value": min(chaos_avail) if all(
            a is not None for a in chaos_avail) else None,
        "unit": "availability",
        "vs_baseline": (round(min(chaos_avail)
                              / baseline["availability"], 4)
                        if baseline["availability"]
                        and all(a is not None for a in chaos_avail)
                        else None),
        "baseline": "the identical cluster replaying the identical "
                    "seeded trace with no host loss",
        "mode": mode,
        "hosts": hosts,
        "device": str(device),
        "device_name": (torch.cuda.get_device_name(device)
                        if device.type == "cuda" else "cpu"),
        "has_cpu_multiprocess": has_cpu_multiprocess(),
        "slo_ms": slo_ms,
        "trace": {"kind": "bursty", "seed": seed,
                  "duration_s": duration_s, "on_rate": on_rate,
                  "arrivals": len(trace),
                  "queries": loadgen.total_queries(trace),
                  "cap": cap, "window": window},
        "victim": victim,
        "killed_at_arrival": kill_at,
        "baseline_leg": baseline,
        "chaos_degrade_leg": degrade_leg,
        "chaos_reshard_leg": reshard_leg,
        "pir_group_routing": pir_leg,
        "swallowed_errors": swallowed_snapshot(),
        "gate_escapes": total_escapes,
        "checked": bool(
            total_escapes == 0
            and all(a is not None and a >= 0.95 for a in chaos_avail)
            and degrade_leg["drop_attributed"]
            and reshard_leg["drop_attributed"]
            and degrade_leg["decision_counts"]["degrade"] >= 1
            and reshard_leg["decision_counts"]["reshard"] >= 1
            and pir_leg["checked"]),
    }
    record["obs"] = record_sections()
    if not record["checked"]:
        # a failed gate is exactly what the flight recorder exists to
        # diagnose: embed the FULL ring (scatter plans, the host_drop,
        # the recovery decision, every fault with its arrival join key)
        record["obs"]["flight_on_gate_failure"] = flight_dump()
        print("multihost gate FAILED — full flight dump embedded in "
              "record (obs.flight_on_gate_failure, %d events)"
              % len(record["obs"]["flight_on_gate_failure"]),
              file=sys.stderr, flush=True)
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
    ap.add_argument("--hosts", type=int, default=4,
                    help="serving hosts (power of two dividing n)")
    ap.add_argument("--seed", type=int, default=14)
    ap.add_argument("--duration", type=float, default=6.0,
                    help="trace duration in seconds")
    ap.add_argument("--on-rate", type=float, default=60.0,
                    help="burst arrival rate (arrivals/sec in ON "
                         "windows)")
    ap.add_argument("--slo-ms", type=float, default=1000.0)
    ap.add_argument("--simulate", action="store_true",
                    help="every host in this process")
    ap.add_argument("--multiprocess", action="store_true",
                    help="one process per host (the default)")
    ap.add_argument("--device", default=None,
                    help="the hosts' device (default: the card)")
    ap.add_argument("--dryrun", action="store_true",
                    help="tiny trace/table smoke (CI): exercises every "
                         "leg in seconds, makes no perf claims")
    ap.add_argument("--out", help="also write the JSON record to a file")
    args = ap.parse_args(argv)
    if args.simulate and args.multiprocess:
        ap.error("--simulate and --multiprocess are mutually exclusive")
    mode = "simulated" if args.simulate else "multiprocess"
    if args.dryrun:
        record = multihost_bench(n=512, entry_size=8, cap=16,
                                 prf=args.prf, hosts=min(args.hosts, 4),
                                 mode=mode, seed=args.seed,
                                 duration_s=1.5, on_rate=20.0,
                                 slo_ms=args.slo_ms, distinct=8,
                                 breaker_reset_s=0.2, device=args.device)
    else:
        record = multihost_bench(n=args.n, entry_size=args.entry_size,
                                 cap=args.cap, prf=args.prf,
                                 hosts=args.hosts, mode=mode,
                                 seed=args.seed,
                                 duration_s=args.duration,
                                 on_rate=args.on_rate,
                                 slo_ms=args.slo_ms, device=args.device)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
            f.write("\n")
    return record


if __name__ == "__main__":
    main()
