"""Mesh-aware autotuner: the scale-out knobs, measured per mesh split
(port of ``dpf_tpu/tune/mesh_tune.py``).

The single-device tuner (``search.tune_eval``) picks one device's
program; this module answers what only a mesh has:

* **per-shard chunking** -- ``chunk_leaves`` (log-N) / ``row_chunk``
  (sqrt-N) resolve against the SHARD's rows;
* **sum granularity** -- ``psum_group`` chunk groups a reduction;
* **mesh split** -- how many devices go to the "batch" axis and how
  many to the "table" axis for one (N, B);
* **the engine ladder on the batch axis** -- serving knobs of a
  ``ServingEngine`` over a ``ShardedDPFServer``.

The single-device tuner's contract holds: staged coordinate descent
from the heuristic, every candidate's ``[B, E]`` shares gated bit for
bit against the scalar oracle (``DPF.eval_cpu``) before its time
counts, winners in the port's tuning cache keyed by device fingerprint
x shape x mesh split (``fingerprint.mesh_tag``) and read back by
``ShardedDPFServer.resolved_eval_knobs`` (kind ``mesh``) and
``ServingEngine.warmup(tune=True)`` (kind ``serve`` with the mesh
field).  Times are the host clock around a dispatch that ends in a
device synchronise, best of ``reps``.  ``serve/bench_multichip.py``
drives the matrix; on one card every mesh is that card repeated.
"""

from __future__ import annotations

import time

import numpy as np

import torch

from ..core import expand
from ..core.prf_ref import PRF_NAMES
from ..ops import matmul128
from .cache import TuningCache, default_cache
from .fingerprint import cache_key, device_fingerprint, mesh_tag

#: stage order of the mesh coordinate descent: memory shape first (it
#: moves the most data per shard), then the collective granularity
MESH_STAGES = ("chunk_leaves", "psum_group")
MESH_SQRT_STAGES = ("row_chunk", "psum_group")


def heuristic_mesh_knobs(n: int, batch: int, *, prf_method: int,
                         scheme: str = "logn", radix: int = 2,
                         n_table: int = 1) -> dict:
    """The static-heuristic mesh knob set (what an untuned
    ``ShardedDPFServer`` runs): per-shard chunk choice, terminal psum."""
    shard_rows = n // n_table
    if scheme == "sqrtn":
        from ..core import sqrtn
        k, r = sqrtn.default_split(n)
        return {"row_chunk": sqrtn.choose_row_chunk(r // n_table, k,
                                                    batch),
                "psum_group": 0,
                "dot_impl": matmul128.default_impl()}
    return {"chunk_leaves": expand.clamp_chunk(None, shard_rows, batch),
            "psum_group": 0,
            "dot_impl": matmul128.default_impl()}


def mesh_stage_candidates(stage: str, current: dict, *, n: int,
                          batch: int, scheme: str = "logn",
                          n_table: int = 1) -> list:
    """Candidate values for one mesh knob, given the current best of
    the others.  Chunk candidates span the heuristic's neighborhood
    over the PER-SHARD row range; psum-group candidates are the
    divisors of the current chunk count (0 = terminal psum is always a
    member, so tuning can never regress the pre-mesh-tuner program)."""
    shard_rows = n // n_table
    if stage == "row_chunk":
        from ..core import sqrtn
        k, r = sqrtn.default_split(n)
        return sqrtn.sqrt_chunk_candidates(r // n_table, k, batch)
    if stage == "chunk_leaves":
        return expand.chunk_candidates(shard_rows, batch)
    if stage == "psum_group":
        if scheme == "sqrtn":
            from ..core import sqrtn
            k, r = sqrtn.default_split(n)
            steps = (r // n_table) // max(1, current.get("row_chunk")
                                          or r // n_table)
        else:
            steps = shard_rows // max(1, current.get("chunk_leaves")
                                      or shard_rows)
        return [0] + [g for g in (1, 2, 4, 8)
                      if 0 < g < steps and steps % g == 0]
    raise KeyError(stage)


def _padded_batch(batch: int, mesh) -> int:
    """The batch the mesh program actually runs (and the batch the
    cache entry must key on): ``ShardedDPFServer._dispatch_packed``
    pads every dispatch to a multiple of the mesh "batch" axis."""
    nb = max(1, mesh.shape["batch"])
    return batch + (-batch) % nb


def tune_mesh_eval(n: int, batch: int, *, mesh, entry_size: int = 16,
                   prf_method: int = 0, scheme: str = "logn",
                   radix: int = 2, reps: int = 2, distinct: int = 16,
                   cache: TuningCache | None = None, force: bool = False,
                   log=None) -> dict:
    """Tune the mesh-path knobs for one (N, E, B, prf, construction) on
    one mesh split.  Returns the cache record (knobs + measurements)
    with a transient ``searched`` field; ``force=True`` re-measures.

    Every timed candidate's full [B, E] share output must be
    bit-identical to the scalar host oracle (``DPF.eval_cpu``) first —
    a candidate that fails the gate or crashes is rejected and
    recorded, never timed.  The winner is gated once more after the
    search (``gate_escapes``; one raises, as ``search.tune_eval``).
    """
    from ..parallel.sharded import ShardedDPFServer
    cache = cache if cache is not None else default_cache()
    stages = MESH_SQRT_STAGES if scheme == "sqrtn" else MESH_STAGES
    n_table = mesh.shape["table"]
    pb = _padded_batch(batch, mesh)
    dev = mesh.output_device
    key = cache_key("mesh", n=n, entry_size=entry_size, batch=pb,
                    prf_method=prf_method, scheme=scheme, radix=radix,
                    mesh=mesh_tag(mesh), device=dev)
    if not force:
        rec = cache.lookup(key)
        if rec is not None:
            return {**rec, "searched": False}

    from .search import _sync, _workload
    dpf, keys, oracle = _workload(n, batch, entry_size, prf_method, scheme,
                                  radix, distinct, device="cpu")
    table = dpf.table
    tried = rejected = 0
    last_exc = None

    def server(knobs: dict):
        return ShardedDPFServer(
            table, mesh, prf_method=prf_method, batch_size=batch,
            radix=radix, scheme=scheme,
            chunk_leaves=knobs.get("chunk_leaves"),
            row_chunk=knobs.get("row_chunk"),
            psum_group=knobs.get("psum_group", 0),
            dot_impl=knobs.get("dot_impl", matmul128.default_impl()))

    def matches(srv) -> bool:
        out = srv.eval(keys).cpu()
        return out.shape == oracle.shape and torch.equal(out, oracle)

    def measure(knobs: dict) -> float | None:
        """Equality-gate then time one candidate; None = rejected."""
        nonlocal tried, rejected, last_exc
        tried += 1
        try:
            srv = server(knobs)
            if not matches(srv):        # builds and warms too
                rejected += 1
                if log:
                    log("  reject (oracle mismatch): %r" % (knobs,))
                return None
            best = float("inf")
            for _ in range(reps):
                t0 = time.perf_counter()
                srv.eval(keys)
                _sync(dev)
                best = min(best, time.perf_counter() - t0)
            return best
        except Exception as exc:  # invalid combo for this split
            rejected += 1
            last_exc = exc
            if log:
                log("  reject (%s): %r" % (type(exc).__name__, knobs))
            return None

    current = heuristic_mesh_knobs(n, pb, prf_method=prf_method,
                                   scheme=scheme, radix=radix,
                                   n_table=n_table)
    heuristic_s = measure(dict(current))
    if heuristic_s is None:
        if last_exc is not None:
            # the opener crashed rather than mismatching: this split is
            # INVALID for the construction (e.g. a sqrt-N grid whose R
            # rows don't divide over the shards) — surface the real
            # error so a split race can record it as a clean rejection
            raise last_exc
        raise AssertionError(
            "mesh-heuristic config failed the oracle gate for n=%d "
            "batch=%d prf=%s mesh=%s — tuner refuses to search from a "
            "broken baseline" % (n, batch, PRF_NAMES[prf_method],
                                 mesh_tag(mesh)))
    best_s = heuristic_s
    timings = {_mesh_knob_tag(current): round(heuristic_s, 6)}
    for stage in stages:
        for cand in mesh_stage_candidates(stage, current, n=n, batch=pb,
                                          scheme=scheme,
                                          n_table=n_table):
            if cand == current.get(stage):
                continue  # already measured as part of `current`
            knobs = {**current, stage: cand}
            t = measure(knobs)
            if t is None:
                continue
            timings[_mesh_knob_tag(knobs)] = round(t, 6)
            if t < best_s:
                best_s, current = t, knobs
                if log:
                    log("  %s=%r -> %.4fs (new best)" % (stage, cand, t))

    escapes = 0 if matches(server(current)) else 1
    if escapes:
        raise AssertionError("gate escape: the mesh winner %r no longer "
                             "matches the oracle" % (current,))
    record = {
        "knobs": current,
        "heuristic": heuristic_mesh_knobs(n, pb, prf_method=prf_method,
                                          scheme=scheme, radix=radix,
                                          n_table=n_table),
        "measured": {
            "best_s": round(best_s, 6),
            "heuristic_s": round(heuristic_s, 6),
            "speedup_vs_heuristic": round(heuristic_s / best_s, 4),
            "reps": reps, "batch": batch, "entries": n,
            "entry_size": entry_size, "prf": PRF_NAMES[prf_method],
            "scheme": scheme, "radix": radix, "mesh": mesh_tag(mesh),
            "candidates_tried": tried, "rejected": rejected,
            "gate_escapes": escapes, "timings": timings,
            "devices": sorted({str(d) for d in mesh.devices.flat}),
        },
        "fingerprint": device_fingerprint(dev),
        "gated": True,  # every timed candidate matched the scalar oracle
    }
    cache.store(key, record)
    return {**record, "searched": True}


def _mesh_knob_tag(knobs: dict) -> str:
    if "row_chunk" in knobs:
        return "rc%s.g%s" % (knobs.get("row_chunk"),
                             knobs.get("psum_group"))
    return "c%s.g%s" % (knobs.get("chunk_leaves"),
                        knobs.get("psum_group"))


# ------------------------------------------------------ mesh-shape split

def mesh_split_candidates(n_devices: int) -> list:
    """Every (n_batch, n_table) factorization of the device count —
    the workload's two parallel axes (data-parallel keys vs
    tensor-parallel table rows) split the mesh between them."""
    return [(nb, n_devices // nb)
            for nb in range(1, n_devices + 1) if n_devices % nb == 0]


def tune_mesh_shape(n: int, batch: int, *, devices=None,
                    entry_size: int = 16, prf_method: int = 0,
                    scheme: str = "logn", radix: int = 2, reps: int = 2,
                    cache: TuningCache | None = None,
                    force: bool = False, log=None) -> dict:
    """Race every (n_batch, n_table) split of the device count for one
    (N, B, construction): each split is knob-tuned by
    ``tune_mesh_eval`` first (so each candidate's time is its best, not
    its heuristic), the fastest split wins and persists under the
    ``meshsplit`` kind (``lookup_mesh_split`` answers later processes).
    Splits invalid for the construction (e.g. a sqrt-N grid whose R
    rows don't divide over the shards) reject cleanly and are recorded.

    ``force`` re-derives THIS record; the per-split cells always run
    with ``force=False`` — entries a forcing caller (``benchmark.py
    --multichip --force``) just re-measured are warm and current, and
    re-measuring them here would double every cell's cost.
    """
    from ..parallel.sharded import _device_list, make_mesh
    cache = cache if cache is not None else default_cache()
    devices = _device_list(devices)
    n_dev = len(devices)
    key = cache_key("meshsplit", n=n, entry_size=entry_size, batch=batch,
                    prf_method=prf_method, scheme=scheme, radix=radix,
                    mesh="d%d" % n_dev, device=devices[0])
    if not force:
        rec = cache.lookup(key)
        if rec is not None:
            return {**rec, "searched": False}
    rows = []
    for nb, nt in mesh_split_candidates(n_dev):
        mesh = make_mesh(n_table=nt, n_batch=nb, devices=devices)
        if log:
            log("tuning mesh split %s (n=%d batch=%d %s) ..."
                % (mesh_tag(mesh), n, batch, scheme))
        try:
            rec = tune_mesh_eval(n, batch, mesh=mesh,
                                 entry_size=entry_size,
                                 prf_method=prf_method, scheme=scheme,
                                 radix=radix, reps=reps, cache=cache,
                                 force=False, log=log)
        except AssertionError:
            raise  # oracle mismatch: a correctness bug, never a mere reject
        except Exception as exc:  # split invalid for this construction
            rows.append({"mesh": "%dx%d" % (nb, nt), "n_batch": nb,
                         "n_table": nt, "rejected": str(exc)})
            continue
        m = rec["measured"]
        rows.append({"mesh": m["mesh"], "n_batch": nb, "n_table": nt,
                     "tuned_knobs": rec["knobs"],
                     "tuned_s": m["best_s"],
                     "heuristic_s": m["heuristic_s"],
                     "speedup_vs_heuristic": m["speedup_vs_heuristic"],
                     "candidates_tried": m["candidates_tried"],
                     "rejected": m["rejected"],
                     "from_cache": not rec["searched"]})
    timed = [r for r in rows if "tuned_s" in r]
    if not timed:
        raise AssertionError("no mesh split passed the gate for n=%d "
                             "batch=%d %s" % (n, batch, scheme))
    win = min(timed, key=lambda r: r["tuned_s"])
    record = {
        "knobs": {"n_batch": win["n_batch"], "n_table": win["n_table"],
                  "mesh": win["mesh"]},
        "measured": {"splits": rows, "entries": n, "batch": batch,
                     "entry_size": entry_size,
                     "prf": PRF_NAMES[prf_method], "scheme": scheme,
                     "radix": radix, "n_devices": n_dev, "reps": reps,
                     "devices": sorted({str(d) for d in devices})},
        "fingerprint": device_fingerprint(devices[0]),
        "gated": True,
    }
    cache.store(key, record)
    return {**record, "searched": True}


def lookup_mesh_split(*, n: int, entry_size: int, batch: int,
                      prf_method: int, n_devices: int,
                      scheme: str = "logn", radix: int = 2,
                      device=None) -> dict | None:
    """The measured winning (n_batch, n_table) split for this shape on
    ``device``'s hardware and device count, or None.  Never raises."""
    try:
        rec = default_cache().lookup(cache_key(
            "meshsplit", n=n, entry_size=entry_size, batch=batch,
            prf_method=prf_method, scheme=scheme, radix=radix,
            mesh="d%d" % n_devices, device=device))
        return rec.get("knobs") if rec else None
    except Exception as e:  # the cache must never break serving
        from ..utils.profiling import note_swallowed
        note_swallowed("tune.mesh_tune.lookup_mesh_split", e)
        return None


# ------------------------------------------- serving knobs on the mesh

def tune_mesh_serving(srv, dpf, *, cap: int | None = None, trace=None,
                      in_flight=(1, 2), ladders=None, reps: int = 2,
                      distinct: int = 8,
                      cache: TuningCache | None = None,
                      force: bool = False, log=None) -> dict:
    """Serving-knob grid search (bucket ladder x in-flight window) for a
    ``ServingEngine`` over a ``ShardedDPFServer``: the mesh "batch" axis
    makes ladder sizes below the axis multiple pure pad waste, which no
    single-device tuning can see.  ``dpf`` is a key-minting companion
    (an ``api.DPF`` with the server's construction/PRF — the mesh
    server cannot gen).  Candidates are equality-gated against the
    blocking ``srv.eval`` loop on the identical stream; the winner
    persists under the ``serve`` kind WITH the mesh field, which
    ``ServingEngine.warmup(tune=True)`` over this server reads back
    (``serve_tune.serve_shape_of`` carries the mesh tag).
    """
    from ..serve.buckets import Buckets
    from ..serve.engine import ServingEngine
    from .serve_tune import serve_shape_of, synthetic_trace
    cache = cache if cache is not None else default_cache()
    cap = int(cap or srv.batch_size)
    shape = serve_shape_of(srv)
    key = cache_key("serve", batch=cap, **shape)
    if not force:
        rec = cache.lookup(key)
        if rec is not None:
            return {**rec, "searched": False}

    n = srv.n
    trace = list(trace) if trace is not None else synthetic_trace(cap)
    ks = dpf.gen_batch([(i * 0x9E3779B1) % n for i in range(distinct)], n,
                       seeds=[b"mesh-serve-%d" % i
                              for i in range(distinct)])[0]
    stream = [ks[[(j + i) % distinct for i in range(b)]]
              for j, b in enumerate(trace)]
    total = sum(trace)
    reference = [srv.eval(b).cpu().numpy() for b in stream]

    best = None
    tried = rejected = 0
    for ladder in (ladders if ladders is not None
                   else Buckets.ladder_candidates(cap)):
        for mif in in_flight:
            tried += 1
            try:
                engine = ServingEngine(srv, max_in_flight=mif,
                                       buckets=ladder, warmup=True)
                futs = [engine.submit(b) for b in stream]
                engine.drain()
                if not all(np.array_equal(r, f.result())
                           for r, f in zip(reference, futs)):
                    rejected += 1
                    if log:
                        log("  reject (diverged): %s mif=%d"
                            % (list(ladder), mif))
                    continue
                elapsed = float("inf")
                for _ in range(reps):
                    engine = ServingEngine(srv, max_in_flight=mif,
                                           buckets=ladder)
                    t0 = time.perf_counter()
                    futs = [engine.submit(b) for b in stream]
                    engine.drain()
                    elapsed = min(elapsed, time.perf_counter() - t0)
            except Exception as exc:
                rejected += 1
                if log:
                    log("  reject (%s): %s mif=%d"
                        % (type(exc).__name__, list(ladder), mif))
                continue
            if log:
                log("  ladder=%s mif=%d -> %d qps"
                    % (list(ladder), mif, int(total / elapsed)))
            if best is None or elapsed < best[0]:
                best = (elapsed, tuple(ladder), mif,
                        engine.stats.as_dict())
    if best is None:
        raise AssertionError("no mesh serving candidate passed the gate")
    elapsed, ladder, mif, stats = best
    record = {
        "knobs": {"buckets": list(ladder), "max_in_flight": mif},
        "measured": {
            "elapsed_s": round(elapsed, 6),
            "qps": int(total / elapsed),
            "trace": trace, "cap": cap, "reps": reps,
            "mesh": mesh_tag(srv.mesh),
            "candidates_tried": tried, "rejected": rejected,
            "engine_stats": stats,
        },
        "fingerprint": device_fingerprint(srv.device),
        "gated": True,  # winner matched the blocking mesh loop
    }
    cache.store(key, record)
    return {**record, "searched": True}
