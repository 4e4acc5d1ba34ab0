"""End-to-end batch-PIR benchmark: plan -> keygen -> answer -> recover.

Port of ``dpf_tpu/serve/bench_pir.py``.  Measures the production
batch-PIR path against the per-key oracles on one planned workload,
equality-gated before any timing:

* **keygen** -- ``PrivateLookupClient.make_queries`` (one batched
  generator call per (n, G) size group) against ``make_queries_scalar``
  (the per-bin ``DPF.gen`` loop), byte-identical keys under pinned
  seeds;
* **answer** -- ``PrivateLookupServer.answer`` (packed wire codec,
  pinned staging, every size group enqueued before one gather) against
  ``answer_scalar`` (per-key deserialize, a host wait per group),
  bit-identical shares;
* **end-to-end** -- keygen -> answer(A) + answer(B) -> recover over
  ``rounds`` query rounds, both paths;
* **streaming** -- the same rounds through ``LookupStream`` (one
  ServingEngine per size group) on both servers.

Times are the host clock around work that ends in a copy of the shares
to the host.  The servers run on the card unless ``--device cpu`` is
given; the record names the device.

    python -m dpf_tpu_torch.serve.bench_pir [--entries 1048576]
        [--bin-fraction F] [--prf ID] [--scheme logn|sqrtn] [--radix 2|4]
        [--rounds R] [--reps R] [--device cpu] [--out FILE]
"""

from __future__ import annotations

import json
import time

import numpy as np
import torch


def _workload(entries, entry_size, bin_fraction, seed=0):
    """Deterministic planned workload: a table, access patterns that bin
    every entry (chunked coverage patterns: the planner bins only the
    indices it has seen), and the optimizer's plan over them."""
    from ..apps.batch_pir import (BatchPIROptimize, CollocateConfig,
                                  HotColdConfig, PIRConfig)
    rng = np.random.default_rng(seed)
    table = rng.integers(0, 2 ** 31, (entries, entry_size),
                         dtype=np.int64).astype(np.int32)
    cover = [list(range(i, min(i + 512, entries)))
             for i in range(0, entries, 512)]
    opt = BatchPIROptimize(
        cover, cover, HotColdConfig(1.0), CollocateConfig(0),
        PIRConfig(bin_fraction=bin_fraction, queries_to_hot=1))
    return table, opt


def _wanted_rounds(opt, entries, rounds, seed=1):
    """One needed-index batch per round (zipf-ish popularity)."""
    rng = np.random.default_rng(seed)
    pop = 1.0 / np.arange(1, entries + 1)
    pop /= pop.sum()
    want = max(1, len(opt.hot_table_bins) // 2)
    return [[int(x) for x in rng.choice(entries, size=want, p=pop)]
            for _ in range(rounds)]


def pir_point(entries=32768, entry_size=16, bin_fraction=1 / 256.,
              prf=None, scheme="logn", radix=2, rounds=6, reps=3,
              quiet=False, device=None):
    """Benchmark one batch-PIR deployment point; returns the point dict.

    Every timed candidate is equality-gated against the scalar oracles
    first: batched keys against the per-bin gen loop (pinned seeds),
    ``answer`` against ``answer_scalar``, streaming results against
    ``answer``, and the recovered rows against the table itself."""
    from ..api import resolve_device
    from ..apps.batch_pir import PrivateLookupClient, PrivateLookupServer
    from ..core.prf_ref import PRF_CHACHA20, PRF_NAMES

    if prf is None:
        prf = PRF_CHACHA20          # a real cipher: the scalar per-bin
        #       gen loop pays Python-int PRF calls
    dev = resolve_device(device)
    t0 = time.perf_counter()
    table, opt = _workload(entries, entry_size, bin_fraction)
    plan_s = time.perf_counter() - t0

    server_a = PrivateLookupServer(table, opt.hot_table_bins, prf=prf,
                                   radix=radix, scheme=scheme, device=dev)
    server_b = PrivateLookupServer(table, opt.hot_table_bins, prf=prf,
                                   radix=radix, scheme=scheme, device=dev)
    client = PrivateLookupClient(opt.hot_table_bins, server_a.bin_sizes,
                                 prf=prf, radix=radix, scheme=scheme,
                                 entry_size=entry_size)
    n_bins = len(server_a.bins)
    rounds_w = _wanted_rounds(opt, entries, rounds)

    # ---- equality gates (never timed) --------------------------------
    seeds = [b"bench-pir-%d" % i for i in range(n_bins)]
    ka, kb, plan = client.make_queries(rounds_w[0], seeds=seeds)
    ka_s, kb_s, plan_s2 = client.make_queries_scalar(rounds_w[0],
                                                     seeds=seeds)
    if plan != plan_s2:
        raise AssertionError("batched plan diverged from the scalar loop")
    for a, b in zip(ka + kb, ka_s + kb_s):
        if not np.array_equal(np.asarray(a), np.asarray(b)):
            raise AssertionError("batched keygen diverged from the "
                                 "per-bin gen loop")
    ans_a = server_a.answer(ka)
    if not np.array_equal(ans_a, server_a.answer_scalar(ka)):
        raise AssertionError("packed answer diverged from answer_scalar")
    got = client.recover(ans_a, server_b.answer(kb), plan)
    for w, row in got.items():
        if not np.array_equal(row, table[w]):
            raise AssertionError("recovered row %d mismatches the table"
                                 % w)

    # ---- keygen: batched against the per-bin loop --------------------
    best_b = best_s = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        client.make_queries(rounds_w[0])
        best_b = min(best_b, time.perf_counter() - t0)
        t0 = time.perf_counter()
        client.make_queries_scalar(rounds_w[0])
        best_s = min(best_s, time.perf_counter() - t0)
    keygen = {"bins": n_bins, "scalar_s": best_s, "batched_s": best_b,
              "speedup": best_s / best_b}

    # ---- answer: packed and pinned against the per-key oracle --------
    best_n = best_s = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        server_a.answer(ka)
        best_n = min(best_n, time.perf_counter() - t0)
        t0 = time.perf_counter()
        server_a.answer_scalar(ka)
        best_s = min(best_s, time.perf_counter() - t0)
    answer = {"scalar_s": best_s, "batched_s": best_n,
              "speedup": best_s / best_n,
              "size_groups": {str(n): len(g.idxs)
                              for n, g in server_a._groups.items()}}

    # ---- end-to-end: keygen -> answer x2 -> recover over all rounds --
    def e2e(batched: bool) -> float:
        t0 = time.perf_counter()
        for wanted in rounds_w:
            if batched:
                a, b, p = client.make_queries(wanted)
                client.recover(server_a.answer(a), server_b.answer(b), p)
            else:
                a, b, p = client.make_queries_scalar(wanted)
                client.recover(server_a.answer_scalar(a),
                               server_b.answer_scalar(b), p)
        return time.perf_counter() - t0

    e2e_new = min(e2e(True) for _ in range(max(1, reps - 1)))
    e2e_old = min(e2e(False) for _ in range(max(1, reps - 1)))
    total_q = n_bins * rounds

    # ---- streaming: LookupStream rounds against sequential answer() --
    st_a = server_a.stream(max_in_flight=2, warmup=True)
    st_b = server_b.stream(max_in_flight=2, warmup=True)
    key_rounds = [client.make_queries(w) for w in rounds_w]
    futs = [(st_a.submit(a), st_b.submit(b), p)
            for a, b, p in key_rounds]  # warm and gate pass
    st_a.drain(), st_b.drain()
    for (fa, fb, p), (a, b, _) in zip(futs, key_rounds):
        if not (np.array_equal(fa.result(), server_a.answer(a))
                and np.array_equal(fb.result(), server_b.answer(b))):
            raise AssertionError("streaming answers diverged from "
                                 "answer()")
    t0 = time.perf_counter()
    futs = [(st_a.submit(a), st_b.submit(b), p) for a, b, p in key_rounds]
    for fa, fb, p in futs:
        client.recover(fa.result(), fb.result(), p)
    stream_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for a, b, p in key_rounds:
        client.recover(server_a.answer(a), server_b.answer(b), p)
    seq_s = time.perf_counter() - t0

    point = {
        "entries": entries, "entry_size": entry_size,
        "bin_fraction": bin_fraction, "bins": n_bins,
        "rounds": rounds, "prf": PRF_NAMES[prf],
        "scheme": scheme, "radix": radix,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "plan_s": plan_s,
        "keygen": keygen,
        "answer": answer,
        "e2e": {"scalar_s": e2e_old, "batched_s": e2e_new,
                "speedup": e2e_old / e2e_new,
                "batched_qps": total_q / e2e_new,
                "scalar_qps": total_q / e2e_old},
        "streaming": {"stream_s": stream_s, "sequential_s": seq_s,
                      "speedup": seq_s / stream_s,
                      "qps": total_q / stream_s,
                      "stats": st_a.stats()},
        "group_constructions": {
            str(n): list(c)
            for n, c in server_a.group_constructions().items()},
    }
    if not quiet:
        print(json.dumps(point), flush=True)
    return point


DEFAULT_POINTS = (
    # 256 bins x 128 entries on the radix-4 construction: the >= 256-bin
    # keygen regime where the batched generator replaces a per-bin loop
    {"entries": 32768, "bin_fraction": 1 / 256., "radix": 4},
    # the binary wire-compatible point with an uneven split: two size
    # groups (512-entry bins and a remainder bin), so two dispatches
    {"entries": 4096, "bin_fraction": 0.1, "radix": 2},
)


def pir_bench(points=None, *, prf=None, scheme=None, radix=None,
              rounds=6, reps=3, out=None, quiet=False, device=None) -> dict:
    """Run every point and emit one JSON record, headline = the largest
    point's end-to-end throughput against the per-key path.  Per-point
    dicts may pin ``scheme``/``radix``; an explicit caller scheme/radix
    overrides the per-point pins wholesale."""
    override = {}
    if scheme is not None:
        override["scheme"] = scheme
        override["radix"] = 2 if scheme == "sqrtn" else (radix or 2)
    elif radix is not None:
        override["radix"] = radix
    pts = [pir_point(prf=prf, rounds=rounds, reps=reps, quiet=True,
                     device=device,
                     **{"scheme": "logn", "radix": 2, **p, **override})
           for p in (points or DEFAULT_POINTS)]
    head = max(pts, key=lambda p: p["entries"])
    record = {
        "metric": "end-to-end batch-PIR (plan->keygen->answer->recover, "
                  "%d bins x %d rounds, entries=%d, %s, 1 device)"
                  % (head["bins"], head["rounds"], head["entries"],
                     head["prf"]),
        "device": head["device"],
        "value": head["e2e"]["batched_qps"],
        "unit": "bin-queries/sec",
        "vs_baseline": head["e2e"]["scalar_s"] / head["e2e"]["batched_s"],
        "baseline": "per-bin DPF.gen loop + per-key deserialize + a host "
                    "wait per size group, identical plan and seeds",
        "points": pts,
        "checked": True,  # every timed candidate passed the gates first
    }
    from ..obs import record_sections
    record["obs"] = record_sections()
    if not quiet:
        print(json.dumps(record), flush=True)
    if out:
        with open(out, "w") as f:
            json.dump(record, f, indent=1)
            f.write("\n")
    return record


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--entries", type=int, default=None,
                    help="single point: table entries (default: the "
                         "two-point default sweep)")
    ap.add_argument("--bin-fraction", type=float, default=1 / 256.)
    ap.add_argument("--prf", type=int, default=None,
                    help="PRF id (default 2 = ChaCha20)")
    ap.add_argument("--scheme", default=None, choices=("logn", "sqrtn"),
                    help="override every point's construction (default: "
                         "the per-point pins)")
    ap.add_argument("--radix", type=int, default=None, choices=(2, 4))
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", default=None,
                    help="server device (default: the CUDA card)")
    ap.add_argument("--out", help="also write the JSON record to a file")
    args = ap.parse_args(argv)
    points = None
    if args.entries:
        points = [{"entries": args.entries,
                   "bin_fraction": args.bin_fraction}]
    return pir_bench(points, prf=args.prf, scheme=args.scheme,
                     radix=args.radix, rounds=args.rounds, reps=args.reps,
                     out=args.out, device=args.device)


if __name__ == "__main__":
    main()
