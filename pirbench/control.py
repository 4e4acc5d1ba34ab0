#!/usr/bin/env python3
"""The control of a cell's comparison: the plain reference with its
contraction in float32, put in the program's place.

    python3 pirbench/control.py --workload <cell> --seeds 11,12,13
        [--seconds S]

For each seed it makes the cell's table and key pool, plans the
requests a run of ``--seconds`` would offer (a closed loop's distinct
batches, which a run cycles through), draws the sample a run would
check, answers it with the float32 contraction (the shortcut a
float tensor-core path would take) and prints the compared numbers
beside their limits.  Every number above its limit means the comparison
catches the control.  The program is not run.  Needs the card.
"""

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from pirbench.harness import check, client, runner, spec  # noqa: E402


def control_numbers(cell: dict, seed: int, seconds: float,
                    device: str) -> dict:
    import torch
    cfg, traffic = cell["config"], cell["traffic"]
    n, e = int(cfg["entries"]), int(cfg["entry_words"])
    table = runner.make_table(n, e, seed, torch.device(device))
    pool = runner.make_pool(cfg, traffic, seed)
    _, rows, sizes = runner.plan(traffic, len(pool["alphas"]), seconds,
                                 seed)
    from dpf_tpu_torch.serve.buckets import Buckets
    ladder = Buckets(Buckets.default_sizes(int(cfg["batch_keys"])))
    reqs = [client.Request(r, 0.0) for r in rows]
    for r in reqs:
        r.shares = r.rows                   # answered (by the control)
    buckets = sorted({ladder.bucket_for(min(int(k), ladder.max))
                      for k in sizes})
    sample = check.draw_sample(reqs, buckets, seed)
    return check.compare(reqs, sample, {}, pool, table,
                         spec.construction(cfg["construction"]),
                         spec.cipher(cfg["prf"]), control=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=20.0)
    args = p.parse_args(argv)
    cell = spec.load_cell(spec.load_benchmark(), args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        nums = control_numbers(cell, seed, args.seconds, "cuda")
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": check.listing(nums),
                          "caught": not check.verdict(nums)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
