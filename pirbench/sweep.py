#!/usr/bin/env python3
"""Find the highest arrival rate an open-loop cell's program sustains.

    python3 pirbench/sweep.py --workload <open-loop cell> --seed <n>
        --seconds <s> --rates 60,70,80,...

Sets the cell up once (as a run does), then offers its traffic at each
rate in turn for ``--seconds`` and prints one JSON line a rate: the
arrivals, p50 / p95 latency, the client's p95 lag, the mean latency of the first and last thirds of the arrivals, the drain
(last arrival to last answer) and ``growing``: whether the backlog grew
through the window (the last third's mean latency above twice the first
third's and 20 ms more, or a drain over a second).
The knee is the highest rate before the first growing one; a serve
cell's traffic file offers about 0.8 of it.  Needs the card.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from pirbench.harness import client, runner, spec  # noqa: E402
from pirbench.harness.stats import quantile  # noqa: E402


def summary(rate: float, reqs, window_s: float) -> dict:
    lat = [(r.done - r.due) * 1e3 for r in reqs if r.shares is not None]
    third = max(1, len(lat) // 3)
    first = sum(lat[:third]) / third
    last = sum(lat[-third:]) / third
    return {"rate_per_s": rate, "arrivals": len(reqs),
            "failed": sum(1 for r in reqs if r.shares is None),
            "window_s": window_s,
            "p50_ms": quantile(lat, 0.5), "p95_ms": quantile(lat, 0.95),
            "client_lag_p95_ms": quantile(
                [(r.sent - r.due) * 1e3 for r in reqs], 0.95),
            "first_third_mean_ms": first, "last_third_mean_ms": last,
            "drain_s": window_s - reqs[-1].due,
            "growing": last > 2 * first + 20.0
            or window_s - reqs[-1].due > 1.0}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=15.0)
    p.add_argument("--rates", required=True,
                   help="comma-separated arrivals per second")
    args = p.parse_args(argv)
    import os
    os.environ["DPF_TPU_TORCH_TUNE_CACHE"] = "off"
    import torch
    if not torch.cuda.is_available():
        print("sweep: needs a CUDA device", file=sys.stderr)
        return 3
    cell = spec.load_cell(spec.load_benchmark(), args.workload)
    traffic = dict(cell["traffic"])
    if traffic["loop"] != "open":
        print("sweep: %s is not an open-loop cell" % args.workload,
              file=sys.stderr)
        return 2
    rates = [float(r) for r in args.rates.split(",")]
    # warm every bucket the traffic can use, at the highest rate's plan
    traffic["rate_per_s"] = max(rates)
    st = runner.prepare(dict(cell, traffic=traffic), args.seed,
                        args.seconds, "cuda",
                        lambda s: print(s, file=sys.stderr, flush=True))
    for rate in rates:
        traffic["rate_per_s"] = rate
        st["times"], st["rows"], _ = runner.plan(
            traffic, len(st["pool"]["alphas"]), args.seconds, args.seed)
        reqs, window_s = runner.offer(st, traffic, args.seconds,
                                      client.Recorder(False))
        print(json.dumps(summary(rate, reqs, window_s)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
