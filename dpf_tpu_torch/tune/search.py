"""Staged coordinate-descent autotuner over the CUDA kernels' launch knobs.

Port of ``dpf_tpu/tune/search.py``.  The knobs that set one server's
throughput are searched one at a time from the heuristic the resolver
runs on a cold cache (``api.DPF.resolved_eval_knobs``), the best of each
stage kept, and the winner persisted per (device, shape) in the tuning
cache.  On the card the knobs are launch geometry, never what a kernel
computes:

* ``chunk_leaves``: K2's block subtree for the stream ciphers (at most
  4096 leaves; ``ops/subtree.block_leaves_candidates``), the live-seed
  chunk of the per-level routes for AES and DUMMY
  (``expand.chunk_candidates``);
* ``dot_impl``: the per-level routes' contraction, ``"i32"`` (K3) or
  ``"mxu"`` (``matmul128.dot_i32_mxu``); K2 and K4 contract inside;
* ``kernel_impl``: ``"fused"`` or ``"dispatch"`` (one launch a level:
  K1 for AES, K5 for binary ChaCha20, the plain step for the others);
* ``dispatch_group``: the dispatch mode's frontier subtrees a pass;
* ``aes_impl``: ``["gather"]`` (K1 is the only AES on the card);
* sqrt-N: ``row_chunk``, K4's grid step (``ops/sqrt_grid.
  row_chunk_candidates``, where ``utils/compat.has_pallas_sqrt_kernel``
  says K4 runs; the plain scan's ``sqrtn.sqrt_chunk_candidates`` on the
  CPU), run as given.

**Every timed candidate is equality-gated**: its full ``[B, E]`` shares
must equal the scalar oracle's (``DPF.eval_cpu`` on the host) before its
time counts; a candidate that differs or raises is rejected and never
timed, and the winner is gated once more after the search (a mismatch
there is a gate escape and raises).  A candidate's time is the host
clock around ``eval_gpu`` to ``torch.cuda.synchronize()``, best of
``reps`` after one warm run (``dpf_tpu`` times the wall around
``np.asarray(eval_tpu)``).  Measurements run inside
``EvalConfig.applied()``, so a crashed search cannot leave
``matmul128``'s default mis-set.

    python -m dpf_tpu_torch.tune.search [--shapes N:B,...] [--prf ID]
        [--scheme-sweep] [--force] [--device cpu] [--out FILE]

mirrors ``benchmark.py --autotune`` (``autotune_sweep``) and, with
``--scheme-sweep``, ``--autotune-scheme`` (``scheme_sweep``).
"""

from __future__ import annotations

import json

import numpy as np
import torch

from ..api import resolve_device
from ..core import expand, radix4, sqrtn, u128
from ..core.prf_ref import PRF_AES128, PRF_NAMES
from ..ops import matmul128
from ..utils.config import EvalConfig
from ..utils.profiling import CACHE_COUNTERS, Timer
from . import compcache
from .cache import TuningCache, default_cache
from .fingerprint import cache_key, device_fingerprint

#: stage order of the coordinate descent (memory shape first, then the
#: contraction, then the program structure)
STAGES = ("chunk_leaves", "dot_impl", "kernel_impl", "dispatch_group",
          "aes_impl")

#: the sqrt-N stage order: K4's grid step; ``dot_impl`` and
#: ``kernel_impl`` keep ``dpf_tpu``'s stages and offer nothing on the
#: card (K4 contracts inside and is the one route)
SQRT_STAGES = ("row_chunk", "dot_impl", "kernel_impl")


def _k2_route(prf_method: int, knobs: dict) -> bool:
    return (prf_method in expand.SUBTREE_PRFS
            and knobs.get("kernel_impl", "fused") != "dispatch")


def heuristic_knobs(n: int, batch: int, *, prf_method: int,
                    radix: int = 2, scheme: str = "logn") -> dict:
    """The knob set the port's resolver runs on a cold cache: the K2
    block for the stream ciphers, ``expand.clamp_chunk`` for AES and
    DUMMY (rounded to trailing arities for radix 4), K4's heuristic grid
    step for sqrt-N."""
    if scheme == "sqrtn":
        from ..ops.sqrt_grid import heuristic_grid_rows
        k, r = sqrtn.default_split(n)
        return {"row_chunk": heuristic_grid_rows(r, k, batch),
                "kernel_impl": "fused"}
    if prf_method in expand.SUBTREE_PRFS:
        from ..ops.subtree import subtree_chunk_leaves
        chunk = subtree_chunk_leaves(n)
    else:
        chunk = expand.clamp_chunk(None, n, batch)
    if radix == 4:
        chunk = radix4._suffix_chunk(radix4.arities(n), chunk)[1]
    return {"chunk_leaves": chunk, "dot_impl": matmul128.default_impl(),
            "kernel_impl": "fused", "dispatch_group": None,
            "aes_impl": "gather"}


def heuristic_scheme(n: int) -> dict:
    """Cold-cache construction default for ``DPF(scheme="auto")``, the
    router's sticky fallback and batch-PIR's groups: the
    reference-wire-compatible binary tree.  The measured winner per
    shape comes from ``scheme_sweep`` through the tuning cache."""
    return {"scheme": "logn", "radix": 2}


def stage_candidates(stage: str, current: dict, *, n: int, batch: int,
                     prf_method: int, radix: int = 2,
                     device=None) -> list:
    """Candidate values for one knob, given the current best of the
    others: only values that the route they reach takes as asked."""
    if stage == "row_chunk":
        # K4's grid steps where K4 runs, else the plain scan's steps
        from ..ops.sqrt_grid import heuristic_grid_rows, row_chunk_candidates
        from ..utils.compat import has_pallas_sqrt_kernel
        k, r = sqrtn.default_split(n)
        if has_pallas_sqrt_kernel(device, prf_method, r):
            return row_chunk_candidates(r, k, batch)
        return sorted({heuristic_grid_rows(r, k, batch),
                       *sqrtn.sqrt_chunk_candidates(r, k, batch)})
    sqrt = "row_chunk" in current
    if stage == "chunk_leaves":
        if _k2_route(prf_method, current):
            from ..ops.subtree import block_leaves_candidates
            return block_leaves_candidates(
                n, radix4.arities(n) if radix == 4 else None)
        cands = expand.chunk_candidates(n, batch)
        if radix == 4:
            ars = radix4.arities(n)
            cands = sorted({radix4._suffix_chunk(ars, c)[1] for c in cands})
        return cands
    if stage == "dot_impl":
        if sqrt or _k2_route(prf_method, current):
            return []
        return list(matmul128.available_impls())
    if stage == "kernel_impl":
        return ["fused"] if sqrt else ["fused", "dispatch"]
    if stage == "dispatch_group":
        if current.get("kernel_impl") != "dispatch":
            return []
        f = n // max(1, current.get("chunk_leaves")
                     or expand.choose_chunk(n, batch))
        return [None] + [g for g in (1, 2, 4, 8) if g <= f and f % g == 0]
    if stage == "aes_impl":
        return ["gather"] if prf_method == PRF_AES128 else []
    raise KeyError(stage)


def _workload(n, batch, entry_size, prf_method, scheme, radix, distinct,
              device=None):
    """Deterministic (server, keys, oracle) for one shape: a DPF on
    ``device`` over a seeded table, ``batch`` keys cycling ``distinct``
    keys from one ``gen_batch`` (key i from seed ``tune-i``, as
    ``dpf_tpu``'s), and the scalar host oracle (``eval_cpu``) of the
    distinct keys tiled to the batch."""
    from ..api import DPF
    dpf = DPF(config=EvalConfig(prf_method=prf_method, radix=radix,
                                scheme=scheme, batch_size=max(512, batch)),
              device=device)
    table = np.random.default_rng(n ^ (batch << 1)).integers(
        0, 2 ** 31, (n, entry_size), dtype=np.int32, endpoint=False)
    dpf.eval_init(table)
    distinct = min(distinct, batch)
    ks = dpf.gen_batch([(i * 0x9E3779B1) % n for i in range(distinct)], n,
                       seeds=[b"tune-%d" % i for i in range(distinct)])[0]
    rows = torch.arange(batch) % distinct
    oracle = dpf.eval_cpu(ks)[rows]
    return dpf, ks[rows].contiguous(), oracle


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _Gate:
    """Gate-then-time one candidate on a prepared server: pin its knobs
    (a config with every field it names explicit, and the same knobs in
    the resolver's memo so the tuning cache cannot backfill the rest),
    run once, compare every share with the oracle, then time best of
    ``reps``.  Counts tried and rejected candidates."""

    def __init__(self, dpf, keys, oracle, *, prf_method, radix, scheme,
                 batch, reps, log):
        self.dpf, self.keys, self.oracle = dpf, keys, oracle
        self.prf_method, self.radix, self.scheme = prf_method, radix, scheme
        self.batch, self.reps, self.log = batch, reps, log
        self.device = dpf.device
        self.tried = self.rejected = 0

    def pin(self, knobs: dict, searched: dict | None = None) -> EvalConfig:
        """Point the server at exactly these knobs; returns the config
        the measurement runs under."""
        names = ("chunk_leaves", "dot_impl", "kernel_impl",
                 "dispatch_group")
        if searched is not None:   # every knob the variant owns at auto
            fields = dict.fromkeys(names)
        else:
            fields = {k: knobs[k] for k in names if k in knobs}
        cfg = EvalConfig(prf_method=self.prf_method,
                         batch_size=self.dpf.BATCH_SIZE, radix=self.radix,
                         scheme=self.scheme, **fields)
        self.dpf._config = cfg
        pb = u128.next_pow2(self.batch)
        self.dpf._tuned_cache = {pb: ({"_searched": searched}
                                      if searched is not None
                                      else dict(knobs))}
        return cfg

    def run(self):
        out = self.dpf.eval_gpu(self.keys)
        _sync(self.device)
        return out

    def matches(self) -> bool:
        out = self.run().cpu()
        return out.shape == self.oracle.shape and torch.equal(out,
                                                              self.oracle)

    def measure(self, knobs: dict, tag: str,
                searched: dict | None = None) -> float | None:
        """Seconds (best of reps) or None = rejected (never timed)."""
        self.tried += 1
        try:
            with self.pin(knobs, searched).applied():
                if searched is not None:
                    got = self.dpf.resolved_eval_knobs(
                        u128.next_pow2(self.batch))
                    if got["kernel_resolved_from"] != "searched":
                        raise AssertionError(
                            "variant pin did not resolve as searched (got "
                            "%r): the measurement would time the wrong "
                            "launches" % (got,))
                if not self.matches():
                    self.rejected += 1
                    if self.log:
                        self.log("  reject (oracle mismatch): %s" % tag)
                    return None
                best = float("inf")
                for _ in range(self.reps):
                    with Timer() as t:      # to the card's synchronize
                        self.dpf.eval_gpu(self.keys)
                    best = min(best, t.elapsed)
            return best
        except AssertionError:
            raise  # a broken search harness, not a bad candidate
        except Exception as exc:
            self.rejected += 1
            if self.log:
                self.log("  reject (%s: %s): %s"
                         % (type(exc).__name__, exc, tag))
            return None

    def escapes(self, knobs: dict, searched: dict | None = None) -> int:
        """Gate the winner once more: 1 if its shares now differ."""
        with self.pin(knobs, searched).applied():
            return 0 if self.matches() else 1


def tune_eval(n: int, batch: int, *, entry_size: int = 16,
              prf_method: int = 0, scheme: str = "logn", radix: int = 2,
              reps: int = 3, distinct: int = 32,
              cache: TuningCache | None = None, force: bool = False,
              stages=None, log=None, device=None) -> dict:
    """Tune the eval knobs for one (N, E, B, prf, scheme, radix) on
    ``device`` (None = the card when present).

    ``stages=None`` picks the scheme's order (``STAGES`` or
    ``SQRT_STAGES``).  Returns the cache record with a transient
    ``searched`` field: False when a warm cache answered and nothing
    ran.  ``force=True`` measures again and overwrites.  ``distinct``
    keys (cycled over the batch) bound the host oracle's cost."""
    if stages is None:
        stages = SQRT_STAGES if scheme == "sqrtn" else STAGES
    cache = cache if cache is not None else default_cache()
    dev = resolve_device(device)
    pb = u128.next_pow2(batch)
    key = cache_key("eval", n=n, entry_size=entry_size, batch=pb,
                    prf_method=prf_method, scheme=scheme, radix=radix,
                    device=dev)
    if not force:
        rec = cache.lookup(key)
        if rec is not None:
            return {**rec, "searched": False}
    dpf, keys, oracle = _workload(n, batch, entry_size, prf_method, scheme,
                                  radix, distinct, dev)
    gate = _Gate(dpf, keys, oracle, prf_method=prf_method, radix=radix,
                 scheme=scheme, batch=batch, reps=reps, log=log)
    current = heuristic_knobs(n, pb, prf_method=prf_method, radix=radix,
                              scheme=scheme)
    heuristic_s = gate.measure(dict(current), _knob_tag(current))
    if heuristic_s is None:
        raise AssertionError(
            "the heuristic knobs failed the oracle gate for n=%d batch=%d "
            "prf=%s: the tuner refuses to search from a broken baseline"
            % (n, batch, PRF_NAMES[prf_method]))
    best_s = heuristic_s
    timings = {_knob_tag(current): round(heuristic_s, 6)}
    for stage in stages:
        for cand in stage_candidates(stage, current, n=n, batch=pb,
                                     prf_method=prf_method, radix=radix,
                                     device=dev):
            if cand == current.get(stage):
                continue  # already measured as part of `current`
            knobs = {**current, stage: cand}
            t = gate.measure(knobs, _knob_tag(knobs))
            if t is None:
                continue
            timings[_knob_tag(knobs)] = round(t, 6)
            if t < best_s:
                best_s, current = t, knobs
                if log:
                    log("  %s=%r -> %.6fs (new best)" % (stage, cand, t))
    escapes = gate.escapes(current)
    if escapes:
        raise AssertionError("gate escape: the winner %r no longer matches "
                             "the oracle" % (current,))
    record = {
        "knobs": current,
        "heuristic": heuristic_knobs(n, pb, prf_method=prf_method,
                                     radix=radix, scheme=scheme),
        "measured": {
            "best_s": round(best_s, 6),
            "heuristic_s": round(heuristic_s, 6),
            "speedup_vs_heuristic": round(heuristic_s / best_s, 4),
            "reps": reps, "batch": batch, "entries": n,
            "entry_size": entry_size, "prf": PRF_NAMES[prf_method],
            "scheme": scheme, "radix": radix, "distinct": min(distinct,
                                                              batch),
            "candidates_tried": gate.tried, "rejected": gate.rejected,
            "gate_escapes": escapes, "timings": timings,
            "device": str(dev),
        },
        "fingerprint": device_fingerprint(dev),
        "gated": True,  # every timed candidate matched the scalar oracle
    }
    cache.store(key, record)
    return {**record, "searched": True}


def _knob_tag(knobs: dict) -> str:
    if "row_chunk" in knobs:  # the sqrt-N space
        tag = "rc%s.%s" % (knobs.get("row_chunk"), knobs.get("dot_impl"))
        kern = knobs.get("kernel_impl")
        if kern not in (None, "xla"):
            tag += ".%s" % kern
        return tag
    return "c%s.%s.%s.g%s.%s" % (
        knobs.get("chunk_leaves"), knobs.get("dot_impl"),
        knobs.get("kernel_impl"), knobs.get("dispatch_group"),
        knobs.get("aes_impl"))


# --------------------------------------------------------------------- sweep

DEFAULT_SWEEP = ((4096, 128), (16384, 512))


def _emit(record: dict, out: str | None, quiet: bool) -> dict:
    if not quiet:
        print(json.dumps(record), flush=True)
    if out:
        with open(out, "w") as f:
            json.dump(record, f, indent=1)
            f.write("\n")
    return record


def autotune_sweep(shapes=DEFAULT_SWEEP, *, prf_method: int = 0,
                   entry_size: int = 16, reps: int = 3,
                   serve: bool = True, force: bool = False,
                   cache: TuningCache | None = None, out: str | None = None,
                   quiet: bool = False, device=None,
                   distinct: int = 32) -> dict:
    """Tune every (N, B) point, then the serving knobs at the largest
    point, and emit one self-describing JSON record (``benchmark.py
    --autotune``'s).  The build cache is enabled first."""
    compcache.enable()
    cache = cache if cache is not None else default_cache()
    dev = resolve_device(device)
    log = None if quiet else (lambda m: print(m, flush=True))
    points = []
    for n, batch in shapes:
        if log:
            log("tuning eval n=%d batch=%d prf=%s on %s ..."
                % (n, batch, PRF_NAMES[prf_method], dev))
        rec = tune_eval(n, batch, entry_size=entry_size,
                        prf_method=prf_method, reps=reps, cache=cache,
                        force=force, log=log, device=dev, distinct=distinct)
        m = rec["measured"]
        points.append({
            "entries": n, "batch": batch,
            "tuned_knobs": rec["knobs"],
            "heuristic_knobs": rec["heuristic"],
            "tuned_s": m["best_s"], "heuristic_s": m["heuristic_s"],
            "speedup_vs_heuristic": m["speedup_vs_heuristic"],
            "tuned_qps": int(batch / m["best_s"]),
            "heuristic_qps": int(batch / m["heuristic_s"]),
            "candidates_tried": m["candidates_tried"],
            "rejected": m["rejected"],
            "from_cache": not rec["searched"],
        })
    serve_rec = None
    if serve:
        n, batch = max(shapes, key=lambda s: s[0] * s[1])
        if log:
            log("tuning serving knobs at n=%d cap=%d ..." % (n, batch))
        from .serve_tune import tune_serving_shape
        serve_rec = tune_serving_shape(
            n=n, cap=batch, entry_size=entry_size, prf_method=prf_method,
            cache=cache, force=force, reps=max(2, reps - 1), device=dev)
    record = {
        "metric": "autotuned eval + serving knobs vs the heuristics "
                  "(equality-gated, best-of-%d reps)" % reps,
        "fingerprint": device_fingerprint(dev),
        "device": str(dev),
        "prf": PRF_NAMES[prf_method],
        "eval_points": points,
        "serve": serve_rec,
        "tuning_cache": cache.path,
        "build_cache": compcache.enabled_dir(),
        "cache_counters": CACHE_COUNTERS.as_dict(),
        "checked": True,  # every timed candidate passed the oracle gate
    }
    return _emit(record, out, quiet)


# -------------------------------------------------------- scheme sweep

#: the constructions the scheme-level sweep races per (N, E, B, prf):
#: (scheme, radix, label)
CONSTRUCTIONS = (("logn", 2, "logn"), ("logn", 4, "radix4"),
                 ("sqrtn", 2, "sqrtn"))


def scheme_cache_key(*, n: int, entry_size: int, batch: int,
                     prf_method: int, device=None) -> str:
    """Tuning-cache key of the scheme-level winner: scheme and radix are
    its ANSWER, so the key pins them to the ``any`` / 0 sentinels."""
    return cache_key("scheme", n=n, entry_size=entry_size, batch=batch,
                     prf_method=prf_method, scheme="any", radix=0,
                     device=device)


def scheme_sweep(shapes=DEFAULT_SWEEP, *, prf_method: int = 0,
                 entry_size: int = 16, reps: int = 3,
                 force: bool = False, cache: TuningCache | None = None,
                 out: str | None = None, quiet: bool = False,
                 device=None, distinct: int = 32) -> dict:
    """Race the three constructions per (N, B) point (``benchmark.py
    --autotune-scheme``): each knob-tuned by ``tune_eval``, the best
    tuned time wins and is stored under the ``scheme|...`` key that
    ``DPF(scheme="auto")``, the router and batch-PIR read.  Also times
    the sqrt-N batched ingest against the scalar decode."""
    compcache.enable()
    cache = cache if cache is not None else default_cache()
    dev = resolve_device(device)
    log = None if quiet else (lambda m: print(m, flush=True))
    points = []
    for n, batch in shapes:
        rows = []
        for scheme, radix, label in CONSTRUCTIONS:
            if log:
                log("tuning %s at n=%d batch=%d prf=%s ..."
                    % (label, n, batch, PRF_NAMES[prf_method]))
            rec = tune_eval(n, batch, entry_size=entry_size,
                            prf_method=prf_method, scheme=scheme,
                            radix=radix, reps=reps, cache=cache,
                            force=force, log=log, device=dev,
                            distinct=distinct)
            m = rec["measured"]
            rows.append({
                "construction": label, "scheme": scheme, "radix": radix,
                "tuned_knobs": rec["knobs"],
                "tuned_s": m["best_s"], "heuristic_s": m["heuristic_s"],
                "speedup_vs_heuristic": m["speedup_vs_heuristic"],
                "tuned_qps": int(batch / m["best_s"]),
                "candidates_tried": m["candidates_tried"],
                "rejected": m["rejected"],
                "from_cache": not rec["searched"],
            })
        win = min(rows, key=lambda r: r["tuned_s"])
        if log:
            log("winner at n=%d batch=%d: %s (%d qps)"
                % (n, batch, win["construction"], win["tuned_qps"]))
        cache.store(
            scheme_cache_key(n=n, entry_size=entry_size,
                             batch=u128.next_pow2(batch),
                             prf_method=prf_method, device=dev),
            {"knobs": {"scheme": win["scheme"], "radix": win["radix"],
                       "construction": win["construction"]},
             "measured": {"per_construction": rows, "entries": n,
                          "batch": batch, "entry_size": entry_size,
                          "prf": PRF_NAMES[prf_method], "reps": reps},
             "fingerprint": device_fingerprint(dev),
             "gated": True})
        points.append({"entries": n, "batch": batch,
                       "winner": win["construction"],
                       "winner_qps": win["tuned_qps"],
                       "constructions": rows})
    from ..serve.bench_serve import sqrt_ingest_microbench
    n_mb, b_mb = max(shapes, key=lambda s: s[0] * s[1])
    record = {
        "metric": "scheme-level autotune: logn vs radix-4 vs sqrtn per "
                  "(N, B), equality-gated, best-of-%d reps" % reps,
        "fingerprint": device_fingerprint(dev),
        "device": str(dev),
        "prf": PRF_NAMES[prf_method],
        "points": points,
        "sqrt_ingest_microbench": sqrt_ingest_microbench(B=b_mb, n=n_mb),
        "tuning_cache": cache.path,
        "build_cache": compcache.enabled_dir(),
        "cache_counters": CACHE_COUNTERS.as_dict(),
        "checked": True,
    }
    return _emit(record, out, quiet)


def parse_shapes(text: str) -> tuple:
    """``"4096:128,16384:512"`` -> ((4096, 128), (16384, 512))."""
    return tuple(tuple(int(x) for x in p.split(":"))
                 for p in text.split(",") if p.strip())


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shapes", default=None,
                    help="N:B points, comma separated (default %s)"
                         % ",".join("%d:%d" % p for p in DEFAULT_SWEEP))
    ap.add_argument("--prf", type=int, default=0)
    ap.add_argument("--entry-size", type=int, default=16)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--distinct", type=int, default=32,
                    help="distinct keys a batch (the host oracle's cost)")
    ap.add_argument("--scheme-sweep", action="store_true",
                    help="race the three constructions (--autotune-scheme)")
    ap.add_argument("--no-serve", action="store_true",
                    help="skip the serving-knob tune of the sweep")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cpu to run the plain versions (default: the card)")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    shapes = parse_shapes(args.shapes) if args.shapes else DEFAULT_SWEEP
    kw = dict(prf_method=args.prf, entry_size=args.entry_size,
              reps=args.reps, force=args.force, out=args.out,
              device=args.device or "cuda", distinct=args.distinct)
    if args.scheme_sweep:
        return scheme_sweep(shapes, **kw)
    return autotune_sweep(shapes, serve=not args.no_serve, **kw)


if __name__ == "__main__":
    main()
