"""Multi-device rehearsal benchmark: the mesh matrix, tuned against the
mesh heuristic, every candidate gated (port of
``dpf_tpu/serve/bench_multichip.py``).

Every (construction x mesh split x shape) cell runs through the mesh
autotuner (``tune.mesh_tune``): the heuristic opener and each searched
candidate are gated bit for bit against the scalar oracle before they
are timed, the split winner is raced (``tune_mesh_shape``, warm from
the matrix), and the serving-engine ladder is tuned on the winning
split's batch axis (``tune_mesh_serving``).  One JSON record comes out.
The record names the devices the meshes stood on: on a machine with one
card every mesh is that card repeated (``"repeated_device": true``), a
rehearsal of the mesh program, not a multi-card measurement.

    python -m dpf_tpu_torch.serve.bench_multichip [--devices 4]
        [--device cuda|cpu] [--shapes N:B,...] [--prf ID] [--out FILE]
"""

from __future__ import annotations

import json
import time

import numpy as np

DEFAULT_SHAPES = ((2048, 8), (8192, 32))

#: (scheme, radix, label): the three constructions
CONSTRUCTIONS = (("logn", 2, "logn"), ("logn", 4, "radix4"),
                 ("sqrtn", 2, "sqrtn"))


def mesh_devices(n_devices: int, device=None) -> list:
    """``n_devices`` mesh entries: CPU devices for ``device="cpu"``,
    else the visible cards in turn (one card repeated when there is
    one); raises when a card is asked for and none is visible."""
    import torch

    from ..utils.hermetic import force_cpu_mesh
    if device is not None and torch.device(device).type == "cpu":
        return force_cpu_mesh(n_devices)
    if not torch.cuda.is_available():
        raise RuntimeError("bench_multichip: no CUDA device (pass "
                           "device='cpu' for a CPU rehearsal)")
    cards = torch.cuda.device_count()
    return [torch.device("cuda", i % cards) for i in range(n_devices)]


def multichip_bench(shapes=DEFAULT_SHAPES, *, n_devices: int = 4,
                    device=None, prf: int = 1, entry_size: int = 16,
                    reps: int = 2, force: bool = False,
                    out: str | None = None, quiet: bool = False,
                    constructions=CONSTRUCTIONS) -> dict:
    """Run the matrix over ``n_devices`` mesh entries on ``device``
    (None = the card) and return (and optionally write) the record."""
    from ..api import DPF
    from ..core.prf_ref import PRF_NAMES
    from ..parallel.sharded import ShardedDPFServer, make_mesh
    from ..tune.cache import default_cache
    from ..tune.fingerprint import device_fingerprint
    from ..tune.mesh_tune import (mesh_split_candidates, tune_mesh_eval,
                                  tune_mesh_serving, tune_mesh_shape)
    from ..utils.config import EvalConfig
    from ..utils.profiling import CACHE_COUNTERS

    cache = default_cache()
    devices = mesh_devices(n_devices, device)
    log = None if quiet else (lambda m: print(m, flush=True))
    splits = mesh_split_candidates(n_devices)

    t_start = time.perf_counter()
    points = []
    total_rejected = 0
    for n, batch in shapes:
        rows_by_c = []
        for scheme, radix, label in constructions:
            rows = []
            for nb, nt in splits:
                mesh = make_mesh(n_table=nt, n_batch=nb, devices=devices)
                if log:
                    log("tuning %s n=%d batch=%d mesh=%dx%d ..."
                        % (label, n, batch, nb, nt))
                try:
                    rec = tune_mesh_eval(
                        n, batch, mesh=mesh, entry_size=entry_size,
                        prf_method=prf, scheme=scheme, radix=radix,
                        reps=reps, cache=cache, force=force, log=log)
                except AssertionError:
                    raise  # an oracle mismatch is a bug: abort
                except Exception as exc:
                    # a split invalid for the construction: record it
                    if log:
                        log("  invalid split: %s" % exc)
                    rows.append({"mesh": "%dx%d" % (nb, nt),
                                 "invalid": str(exc)})
                    continue
                m = rec["measured"]
                total_rejected += m["rejected"]
                rows.append({
                    "mesh": m["mesh"],
                    "tuned_knobs": rec["knobs"],
                    "heuristic_knobs": rec["heuristic"],
                    "tuned_s": m["best_s"],
                    "heuristic_s": m["heuristic_s"],
                    "speedup_vs_heuristic": m["speedup_vs_heuristic"],
                    "tuned_qps": int(batch / m["best_s"]),
                    "heuristic_qps": int(batch / m["heuristic_s"]),
                    "candidates_tried": m["candidates_tried"],
                    "rejected": m["rejected"],
                    "from_cache": not rec["searched"],
                })
            row = {"construction": label, "scheme": scheme,
                   "radix": radix, "splits": rows}
            if any("tuned_s" in r for r in rows):
                split_rec = tune_mesh_shape(
                    n, batch, devices=devices, entry_size=entry_size,
                    prf_method=prf, scheme=scheme, radix=radix, reps=reps,
                    cache=cache, force=force)
                row["winning_split"] = split_rec["knobs"]
            rows_by_c.append(row)
        timed = [c for c in rows_by_c
                 if any("tuned_s" in r for r in c["splits"])]
        if not timed:
            raise AssertionError(
                "no (construction, split) cell was valid at n=%d "
                "batch=%d on %d devices" % (n, batch, n_devices))
        best = min(timed, key=lambda c: min(
            r["tuned_s"] for r in c["splits"] if "tuned_s" in r))
        points.append({"entries": n, "batch": batch,
                       "constructions": rows_by_c,
                       "winner": best["construction"]})

    # the serving ladder on the batch axis: largest point, its winner
    head = max(points, key=lambda p: p["entries"] * p["batch"])
    n, batch = head["entries"], head["batch"]
    win_c = next(c for c in head["constructions"]
                 if c["construction"] == head["winner"])
    nb, nt = (win_c["winning_split"]["n_batch"],
              win_c["winning_split"]["n_table"])
    if log:
        log("tuning mesh serving ladder: %s n=%d cap=%d mesh=%dx%d ..."
            % (head["winner"], n, batch, nb, nt))
    dpf = DPF(config=EvalConfig(prf_method=prf, scheme=win_c["scheme"],
                                radix=win_c["radix"]), device="cpu")
    table = np.random.default_rng(n ^ 0x3a7).integers(
        0, 2 ** 31, (n, entry_size), dtype=np.int32, endpoint=False)
    srv = ShardedDPFServer(
        table, make_mesh(n_table=nt, n_batch=nb, devices=devices),
        prf_method=prf, batch_size=batch, radix=win_c["radix"],
        scheme=win_c["scheme"])
    serve_rec = tune_mesh_serving(srv, dpf, cap=batch, reps=reps,
                                  cache=cache, force=force, log=log)
    sm = serve_rec["measured"]
    total_rejected += sm["rejected"]
    names = sorted({str(d) for d in devices})
    record = {
        "metric": "mesh-path autotune matrix: %d constructions x %d "
                  "mesh splits x %d shapes, tuned vs mesh heuristic, "
                  "every timed candidate gated against the scalar oracle"
                  % (len(constructions), len(splits), len(shapes)),
        "n_devices": n_devices,
        "mesh_devices": names,
        "repeated_device": len(names) < n_devices,
        "fingerprint": device_fingerprint(devices[0]),
        "prf": PRF_NAMES[prf],
        "points": points,
        "serve": {
            "construction": head["winner"],
            "mesh": sm["mesh"], "cap": sm["cap"],
            "tuned_knobs": serve_rec["knobs"],
            "qps": sm["qps"], "elapsed_s": sm["elapsed_s"],
            "candidates_tried": sm["candidates_tried"],
            "rejected": sm["rejected"],
            "from_cache": not serve_rec["searched"],
        },
        "total_rejected": total_rejected,
        "elapsed_s": round(time.perf_counter() - t_start, 1),
        "tuning_cache": cache.path,
        "cache_counters": CACHE_COUNTERS.as_dict(),
        "checked": True,  # gate first: no candidate timed unverified
    }
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
    ap.add_argument("--devices", type=int, default=4,
                    help="mesh entries (default 4)")
    ap.add_argument("--device", default=None,
                    help="cpu for a CPU rehearsal (default: the cards)")
    ap.add_argument("--shapes", default=None,
                    help="comma list of N:B points (default %s)"
                         % ",".join("%d:%d" % s for s in DEFAULT_SHAPES))
    ap.add_argument("--prf", type=int, default=1,
                    help="PRF id (default 1=Salsa20; 0=DUMMY, 3=AES128)")
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--force", action="store_true",
                    help="measure again even with a warm tuning cache")
    ap.add_argument("--out", help="also write the JSON record to a file")
    args = ap.parse_args(argv)
    shapes = DEFAULT_SHAPES
    if args.shapes:
        shapes = tuple(tuple(int(x) for x in p.split(":"))
                       for p in args.shapes.split(","))
    return multichip_bench(shapes, n_devices=args.devices,
                           device=args.device, prf=args.prf,
                           reps=args.reps, force=args.force, out=args.out)


if __name__ == "__main__":
    main()
