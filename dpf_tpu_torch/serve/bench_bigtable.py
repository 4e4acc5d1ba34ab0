"""Billion-row table tier benchmark: 2D sharding + granule HBM paging.

Port of ``dpf_tpu/serve/bench_bigtable.py`` (``python -m
dpf_tpu_torch.benchmark --bigtable``).  Four legs, one story: a table
LARGER than any single device budget served end-to-end, bit-identical
to the single-host oracle, with the paging cost pushed off the critical
path.  Every host, granule store and mesh entry stands on ``device``
(None = the card); the meshes repeat it, as one card rehearses every
mesh.

* **paged_cluster** — a serving cluster whose hosts are each ASSIGNED
  more table bytes than their device budget holds
  (``ClusterShardServer(budget_bytes=...)`` over a
  ``serve.registry.GranuleStore``): granules demand-page on dispatch,
  evict LRU-first under budget pressure, and every merged answer is
  bit-gated against the scalar oracle (``DPF.eval_cpu``) — the
  end-to-end proof that paged residency never changes a bit.  On the
  card the leg also reads ``torch.cuda.memory_allocated`` around it:
  building the paged hosts allocates nothing, and demoting every store
  frees exactly the granules the stores held (``memory``).
* **prefetch_race** — the same paged host serving the same seeded
  trace twice under periodic residency pressure (``demote_all``
  between arrivals — registry-level pressure from other tenants,
  identical in both legs): ``prefetch_off`` demand-pages inside the
  measured dispatch window; ``prefetch_on`` re-promotes in
  ``GranulePrefetcher.tick()`` BETWEEN arrivals, sized by the trace's
  per-bucket arrival rates (``loadgen.bucket_rates`` — the offline
  twin of ``SchemeRouter.arrival_rates``).  Gate: prefetch-on p99 must
  not lose.
* **mesh_2d** — the 2D row x entry-byte mesh programs
  (``sharded.eval_sharded_2d``) on an 8-entry mesh of ``device``:
  every (batch, table, byte) split x psum_group variant must bit-match
  BOTH the 1D row-sharded path and the single-chip oracle (per-chip
  bytes shrink by n_table x n_byte — the sharding that spreads one
  big table over the whole grid).
* **plan** — HBM as a first-class planning resource:
  ``plan.capacity.plan_fleet(table_bytes=...)`` answers "how many
  hosts for a 10^9-row table at this qps" with a jointly-monotone
  (load x table bytes) curve whose memory floor binds, and the twin's
  ``FleetConfig`` paging fields make under-budgeted replicas pay
  their stall in the fidelity legs.

    python -m dpf_tpu_torch.benchmark --bigtable [--dryrun]
        [--device cpu] [--out FILE]
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

from ..core import expand
from ..obs import FLIGHT, flight_dump, record_sections
from ..utils.profiling import quantile, swallowed_snapshot
from .bench_load import _batch_for, _key_pool, _slo_stats, replay
from . import loadgen


# ------------------------------------------------- paged cluster leg


def _allocated(device) -> int | None:
    """``torch.cuda.memory_allocated`` of ``device`` after a synchronise
    (None on the CPU)."""
    if device.type != "cuda":
        return None
    torch.cuda.synchronize(device)
    return torch.cuda.memory_allocated(device)


def _paged_cluster_leg(table, *, hosts, granules_per_host,
                       budget_granules, oracle, buckets, trace, pool,
                       slo_s, window, device) -> dict:
    """End-to-end paged serving: every host assigned
    ``granules_per_host`` granules with device budget for only
    ``budget_granules`` of them — dispatches walk the assignment
    leasing/evicting through the ``GranuleStore`` while the client
    bit-gates every merged answer against the scalar oracle.  On the
    card, ``memory`` holds what ``memory_allocated`` moved by: 0 while
    the hosts are built, and, when every store demotes after the run,
    exactly the bytes of the granules they held."""
    import gc
    from ..parallel.cluster import (ClusterRouter, ClusterShardServer,
                                    LocalHost)
    from .bench_multihost import _ClusterClient

    n, e = table.shape
    g = n // (hosts * granules_per_host)
    perm = expand.permute_table(table)
    granule_bytes = g * e * 4
    budget = budget_granules * granule_bytes
    gc.collect()
    m0 = _allocated(device)
    nodes = []
    for i in range(hosts):
        row0s = tuple(range(i * granules_per_host * g,
                            (i + 1) * granules_per_host * g, g))
        srv = ClusterShardServer(perm, row0s, g,
                                 prf_method=oracle.prf_method,
                                 budget_bytes=budget, device=device)
        nodes.append(LocalHost("host%d" % i, srv, process_index=i,
                               buckets=buckets))
    m_built = _allocated(device)
    cluster = ClusterRouter(nodes, granule=g, table_perm=perm,
                            policy="reshard", device=device)
    try:
        cluster.warmup()
        client = _ClusterClient(cluster, pool, injector=None)
        lats, done, makespan, _, _ = replay(trace, client.submit,
                                            window=window)
        cluster.drain()
        served_ok = sum(1 for (_, _, fut), lat in zip(done, lats)
                        if getattr(fut, "ok", False) and lat <= slo_s)
        escapes = 0
        for a, j, fut in done:  # re-gate final values: escapes must be 0
            if not getattr(fut, "ok", False):
                continue
            if not np.array_equal(fut.result(),
                                  client.refs_for(j, a.batch)):
                escapes += 1
        stores = {nd.label: nd.server.store.stats() for nd in nodes}
        memory = None
        if m0 is not None:
            gc.collect()
            held = sum(nd.server.store.resident_bytes for nd in nodes)
            m_run = _allocated(device)
            for nd in nodes:
                nd.server.store.demote_all()
            freed = m_run - _allocated(device)
            memory = {"granule_bytes": granule_bytes,
                      "built_moved_bytes": m_built - m0,
                      "held_bytes_after_run": held,
                      "demote_freed_bytes": freed,
                      "whole_granules": bool(
                          m_built == m0 and freed == held
                          and held % granule_bytes == 0)}
        assigned_bytes = granules_per_host * granule_bytes
        over_budget = all(assigned_bytes > st["budget_bytes"]
                          for st in stores.values())
        paged = all(st["counters"]["misses"] > 0
                    and st["counters"]["evictions"] > 0
                    for st in stores.values())
        total = len(trace)
        return {
            "hosts": hosts,
            "granule_rows": g,
            "granules_per_host": granules_per_host,
            "budget_granules": budget_granules,
            "assigned_bytes_per_host": assigned_bytes,
            "budget_bytes_per_host": budget,
            "assignment_exceeds_budget": over_budget,
            "availability": round(served_ok / total, 4) if total else None,
            "served_ok": served_ok,
            "arrivals": total,
            "failed_batches": client.failed_batches,
            "reserves_after_gate": client.reserves,
            "makespan_s": round(makespan, 4),
            **_slo_stats(lats, slo_s),
            "stores": stores,
            "memory": memory,
            "gate_escapes": escapes,
            "checked": bool(over_budget and paged and escapes == 0
                            and client.failed_batches == 0
                            and served_ok == total
                            and (memory is None
                                 or memory["whole_granules"])),
        }
    finally:
        cluster.close()


# ------------------------------------------------- prefetch race leg


def _race_side(srv, trace, pool, *, prefetcher, pressure_every) -> dict:
    """One side of the prefetch race: serve ``trace`` sequentially
    through a paged shard server, timing each dispatch; residency
    pressure (``demote_all``) lands between arrivals, identically in
    both sides.  With ``prefetcher`` the untimed between-arrivals tick
    re-promotes what pressure evicted; without it the next TIMED
    dispatch demand-pages the cold granules."""
    keys0, refs = pool
    store = srv.store
    # warm untimed — one dispatch per batch shape the trace will offer,
    # so the measured windows hold paging, not first calls (kernel
    # loads, allocator growth) — then reset to the cold-start both
    # sides race from.  A dispatch is timed to its download
    for b in sorted({a.batch for a in trace}):
        pk = srv._decode_batch(_batch_for(pool, 0, b)[0])
        srv._dispatch_packed(pk).cpu()
    store.demote_all()
    lats, rejections = [], 0
    for j, a in enumerate(trace):
        kb, idxs = _batch_for(pool, j, a.batch)
        pk = srv._decode_batch(kb)
        t0 = time.perf_counter()
        out = srv._dispatch_packed(pk).cpu().numpy()
        lats.append(time.perf_counter() - t0)
        if not np.array_equal(out, refs[idxs]):
            rejections += 1
        if (j + 1) % pressure_every == 0:
            store.demote_all()          # registry pressure, both sides
        if prefetcher is not None:
            prefetcher.tick()           # untimed: between arrivals
    ms = sorted(x * 1e3 for x in lats)
    out = {
        "arrivals": len(trace),
        "pressure_every": pressure_every,
        "p50_ms": round(quantile(ms, 0.50, presorted=True), 3),
        "p99_ms": round(quantile(ms, 0.99, presorted=True), 3),
        "max_ms": round(ms[-1], 3),
        "gate_rejections": rejections,
        "store": store.stats(),
    }
    if prefetcher is not None:
        out["prefetcher"] = prefetcher.stats()
    return out


def _prefetch_race_leg(table, *, oracle, pool, trace, ladder,
                       granules, device) -> dict:
    """prefetch-on vs prefetch-off p99 under identical periodic
    residency pressure.  The ON side's tick budget is driven by the
    trace's own per-bucket arrival rates (``loadgen.bucket_rates``,
    the offline stand-in for ``SchemeRouter.arrival_rates``)."""
    from ..parallel.cluster import ClusterShardServer
    from .registry import GranulePrefetcher

    n, e = table.shape
    g = n // granules
    perm = expand.permute_table(table)
    budget = granules * g * e * 4        # full table fits: pressure,
    pressure_every = max(2, len(trace) // 6)  # not capacity, evicts
    rates = loadgen.bucket_rates(trace, ladder)

    def build():
        return ClusterShardServer(perm, tuple(range(0, n, g)), g,
                                  prf_method=oracle.prf_method,
                                  budget_bytes=budget, device=device)

    srv_off = build()
    off = _race_side(srv_off, trace, pool, prefetcher=None,
                     pressure_every=pressure_every)
    srv_on = build()
    on = _race_side(srv_on, trace, pool,
                    prefetcher=GranulePrefetcher(
                        srv_on.store, rates_fn=lambda: rates,
                        max_per_tick=granules),
                    pressure_every=pressure_every)
    return {
        "granules": granules,
        "granule_rows": g,
        "trace_bucket_rates_hz": {"%d" % bk: round(hz, 3)
                                  for bk, hz in rates.items()},
        "prefetch_off": off,
        "prefetch_on": on,
        "p99_speedup": (round(off["p99_ms"] / on["p99_ms"], 3)
                        if on["p99_ms"] else None),
        "checked": bool(
            on["p99_ms"] <= off["p99_ms"]
            and on["gate_rejections"] == 0
            and off["gate_rejections"] == 0
            and on["store"]["counters"]["prefetch_hits"] > 0),
    }


# ------------------------------------------------------- 2D mesh leg


def _mesh2d_refs(*, prf, seed, dryrun, device) -> dict:
    """The 2D mesh leg's seeded table and key batch and its two
    references on ``device``: the one-device ``eval_gpu`` shares and the
    1D row-sharded path's on an 8-entry mesh."""
    from ..api import DPF
    from ..parallel import sharded

    n = 512 if dryrun else 2048
    e, batch = 8, 8
    rng = np.random.default_rng(seed ^ 0xB16)
    table = rng.integers(-2 ** 31, 2 ** 31, size=(n, e),
                         dtype=np.int64).astype(np.int32)
    dpf = DPF(prf=prf, device=device)
    idxs = [(i * 997) % n for i in range(batch)]
    k0s, k1s = dpf.gen_batch(idxs, n)
    dpf.eval_init(table)
    mesh1 = sharded.make_mesh(n_table=8, n_batch=1, devices=[device] * 8)
    return {"table": table, "idxs": idxs, "k0s": k0s, "k1s": k1s,
            "single": dpf.eval_gpu(k0s).cpu().numpy(),
            "one_d": sharded.ShardedDPFServer(
                table, mesh1, prf_method=prf,
                batch_size=batch).eval(k0s).cpu().numpy()}


def _mesh2d_leg(refs, *, prf, device) -> dict:
    """Every (batch, table, byte) split x psum_group variant of the 2D
    mesh program on 8 entries of ``device``, bit-gated against BOTH
    references of ``refs`` (``_mesh2d_refs``: the 1D row-sharded path
    and the one-device ``eval_gpu``), plus share-pair recovery of the
    exact table rows."""
    from ..parallel import sharded
    from ..tune.fingerprint import mesh_tag

    table, idxs, single, one_d = (refs[k] for k in ("table", "idxs",
                                                    "single", "one_d"))
    (n, e), batch = table.shape, len(idxs)
    variants = []
    for nb, nt, nby in ((1, 4, 2), (1, 2, 4), (2, 2, 2)):
        for pg in (0, 2):
            mesh = sharded.make_mesh_2d(n_table=nt, n_byte=nby,
                                        n_batch=nb, devices=[device] * 8)
            srv = sharded.ShardedDPFServer(table, mesh, prf_method=prf,
                                           batch_size=batch,
                                           psum_group=pg)
            a = srv.eval(refs["k0s"]).cpu().numpy()
            b = srv.eval(refs["k1s"]).cpu().numpy()
            rec = (a.astype(np.int64) - b).astype(np.int32)
            variants.append({
                "mesh": mesh_tag(mesh),
                "psum_group": pg,
                "block_shape": [n // nt, e // nby],
                "parity_vs_single": bool(np.array_equal(a, single)),
                "parity_vs_1d": bool(np.array_equal(a, one_d)),
                "recover_ok": bool((rec == table[idxs]).all()),
            })
    return {
        "n": n, "entry_size": e, "batch": batch, "prf": prf,
        "parity_1d_vs_single": bool(np.array_equal(one_d, single)),
        "variants": variants,
        "checked": bool(
            np.array_equal(one_d, single)
            and all(v["parity_vs_single"] and v["parity_vs_1d"]
                    and v["recover_ok"] for v in variants)),
    }


# ----------------------------------------------------- planning leg


def _plan_leg() -> dict:
    """Memory-aware capacity planning at billion-row scale (pure
    stdlib — the cost table is a stated model, the gates are on the
    RELATIVE properties: the memory floor binds, the (load x table
    bytes) curve is jointly monotone, and the twin charges
    under-budgeted replicas their paging stall)."""
    from ..plan.capacity import min_hosts_for_memory, plan_fleet
    from ..plan.twin import CostTable, FleetConfig, simulate

    ct = CostTable({("logn", 64): 0.002, ("logn", 128): 0.0035,
                    ("logn", 256): 0.006, ("logn", 512): 0.011},
                   overhead_s=0.0005)
    trace = [(i * 0.01, 64) for i in range(200)]
    rows, e = 10 ** 9, 64                   # 1e9 rows x 64 int32 words
    table_bytes = rows * e * 4              # 256 GB: memory-bound
    hbm = 16 << 30
    plan = plan_fleet(trace, ct, label="logn", slo_s=0.05,
                      table_bytes=table_bytes, hbm_bytes_per_host=hbm)
    plan2 = plan_fleet(trace, ct, label="logn", slo_s=0.05,
                       table_bytes=2 * table_bytes,
                       hbm_bytes_per_host=hbm)
    floor = min_hosts_for_memory(table_bytes, hbm)
    memory_bound = all(c["hosts"] >= floor > c["hosts_throughput"]
                       for c in plan["headroom_curve"])
    jointly_monotone = bool(plan["monotone"] and plan2["monotone"]
                            and plan2["hosts"] >= plan["hosts"])

    base = dict(replicas={"logn": 2}, dispatch_blocking=False)
    f_none = FleetConfig(**base)
    f_page = FleetConfig(**base, table_bytes=8 << 30,
                         hbm_bytes_per_replica=4 << 30,
                         page_gbps=1024.0)
    f_over = FleetConfig(**base, table_bytes=8 << 30,
                         hbm_bytes_per_replica=4 << 30,
                         page_gbps=1024.0, prefetch_overlap=0.9)
    p99 = {}
    for lbl, f in (("no_paging", f_none), ("paged", f_page),
                   ("paged_prefetched", f_over)):
        p99[lbl] = simulate(trace, ct, f, seed=0,
                            record_events=False).summary()["p99_ms"]
    twin_ok = bool(p99["paged"] > p99["no_paging"]
                   and p99["paged_prefetched"] < p99["paged"])
    return {
        "rows": rows, "entry_words": e, "table_bytes": table_bytes,
        "plan": plan,
        "hosts_at_2x_table_bytes": plan2["hosts"],
        "hosts_memory_floor": floor,
        "memory_floor_binds": memory_bound,
        "jointly_monotone": jointly_monotone,
        "twin_fidelity": {
            "paging_stall_s_per_dispatch": round(
                f_page.paging_stall_s(), 6),
            "p99_ms": p99,
        },
        "checked": bool(memory_bound and jointly_monotone and twin_ok),
    }


# ------------------------------------------------------------ record


def bigtable_bench(n=8192, entry_size=8, cap=64, prf=0, *, hosts=2,
                   granules_per_host=4, budget_granules=2, seed=19,
                   duration_s=3.0, rate=24.0, slo_ms=2000.0, window=4,
                   distinct=16, device=None, quiet=False,
                   before_legs=None) -> dict:
    """All four legs over one seeded trace on ``device`` (None = the
    card); returns the ``--bigtable`` record.  Every reference (the key
    pool's oracle shares, the mesh-2D leg's one-device and row-sharded
    answers) is computed first; then ``before_legs()`` is called, if
    given, and the legs run: a caller that counts kernel launches from
    there counts the legs' alone."""
    from ..api import DPF, resolve_device
    from .buckets import Buckets

    dev = resolve_device(device)
    FLIGHT.clear()      # scope the embedded flight events to this bench
    rng = np.random.default_rng(seed)
    table = rng.integers(-2 ** 31, 2 ** 31, size=(n, entry_size),
                         dtype=np.int64).astype(np.int32)
    oracle = DPF(prf=prf, device=dev)
    oracle.eval_init(table)
    trace = loadgen.poisson_trace(rate=rate, duration_s=duration_s,
                                  cap=cap, seed=seed, n=n)
    buckets = Buckets.default_sizes(cap)
    pool = _key_pool(oracle, n, distinct, b"bigtable")
    slo_s = slo_ms / 1e3
    mesh_refs = _mesh2d_refs(prf=prf, seed=seed, dryrun=n <= 1024,
                             device=dev)
    if before_legs is not None:
        before_legs()

    paged = _paged_cluster_leg(
        table, hosts=hosts, granules_per_host=granules_per_host,
        budget_granules=budget_granules, oracle=oracle, buckets=buckets,
        trace=trace, pool=pool, slo_s=slo_s, window=window, device=dev)
    race = _prefetch_race_leg(
        table, oracle=oracle, pool=pool, trace=trace,
        ladder=buckets, granules=hosts * granules_per_host, device=dev)
    mesh2d = _mesh2d_leg(mesh_refs, prf=prf, device=dev)
    plan = _plan_leg()

    total_escapes = (paged["gate_escapes"]
                     + race["prefetch_on"]["gate_rejections"]
                     + race["prefetch_off"]["gate_rejections"])
    record = {
        "metric": "billion-row table tier — paged granule residency "
                  "(device budget %d/%d granules per host, every "
                  "answer bit-gated vs the scalar oracle), prefetch-on "
                  "vs prefetch-off p99 under periodic residency "
                  "pressure, 2D row x entry-byte mesh parity, and "
                  "memory-aware fleet planning at 10^9 rows"
                  % (budget_granules, granules_per_host),
        "value": race["p99_speedup"],
        "unit": "x p99 (prefetch off / on)",
        "baseline": "the identical paged host replaying the identical "
                    "seeded trace under identical pressure with the "
                    "prefetcher disabled",
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "table": {"n": n, "entry_size": entry_size,
                  "bytes": n * entry_size * 4, "prf": prf},
        "trace": {"kind": "poisson", "seed": seed, "rate": rate,
                  "duration_s": duration_s, "cap": cap,
                  "arrivals": len(trace),
                  "queries": loadgen.total_queries(trace),
                  "window": window},
        "slo_ms": slo_ms,
        "paged_cluster": paged,
        "prefetch_race": race,
        "mesh_2d": mesh2d,
        "plan": plan,
        "swallowed_errors": swallowed_snapshot(),
        "gate_escapes": total_escapes,
        "checked": bool(total_escapes == 0 and paged["checked"]
                        and race["checked"] and mesh2d["checked"]
                        and plan["checked"]),
    }
    record["obs"] = record_sections()
    if not record["checked"]:
        # a failed gate is what the flight recorder exists to diagnose:
        # embed the FULL ring (every granule promote/evict/overcommit
        # with its store and row0, the scatter plans, the gate events)
        record["obs"]["flight_on_gate_failure"] = flight_dump()
        print("bigtable gate FAILED — full flight dump embedded in "
              "record (obs.flight_on_gate_failure, %d events)"
              % len(record["obs"]["flight_on_gate_failure"]),
              file=sys.stderr, flush=True)
    if not quiet:
        print(json.dumps(record), flush=True)
    return record


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=8192)
    ap.add_argument("--entry-size", type=int, default=8)
    ap.add_argument("--cap", type=int, default=64)
    ap.add_argument("--prf", type=int, default=0,
                    help="PRF id (default 0=DUMMY; 2=ChaCha20, "
                         "3=AES128)")
    ap.add_argument("--hosts", type=int, default=2)
    ap.add_argument("--seed", type=int, default=19)
    ap.add_argument("--duration", type=float, default=3.0)
    ap.add_argument("--rate", type=float, default=24.0,
                    help="poisson arrival rate (arrivals/sec)")
    ap.add_argument("--slo-ms", type=float, default=2000.0)
    ap.add_argument("--device", default=None,
                    help="cpu to run the plain versions on CPU devices "
                         "(default: the card, repeated in the meshes)")
    ap.add_argument("--dryrun", action="store_true",
                    help="tiny trace/table smoke (CI): exercises every "
                         "leg in seconds, makes no perf claims")
    ap.add_argument("--out", help="also write the JSON record to a file")
    args = ap.parse_args(argv)
    if args.dryrun:
        record = bigtable_bench(n=1024, entry_size=8, cap=16,
                                prf=args.prf, hosts=min(args.hosts, 2),
                                seed=args.seed, duration_s=1.0,
                                rate=16.0, slo_ms=args.slo_ms,
                                distinct=8, device=args.device)
    else:
        record = bigtable_bench(n=args.n, entry_size=args.entry_size,
                                cap=args.cap, prf=args.prf,
                                hosts=args.hosts, seed=args.seed,
                                duration_s=args.duration,
                                rate=args.rate, slo_ms=args.slo_ms,
                                device=args.device)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
            f.write("\n")
    return record


if __name__ == "__main__":
    main()
