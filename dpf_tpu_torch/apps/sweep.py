"""Grid sweep over batch-PIR configurations.

Port of ``dpf_tpu/apps/sweep.py`` (the reference's ``sweep/sweep.py``).
Sweeps (hot/cold cache fraction x co-location x bin fraction x query
budgets), evaluates recovery percentiles (and optionally downstream model
accuracy), and writes one JSON result per config — the reference's
one-file-per-config protocol (``sweep/sweep.py:80-84``).
"""

from __future__ import annotations

import itertools
import json
import os

from .batch_pir import (BatchPIROptimize, CollocateConfig, HotColdConfig,
                        PIRConfig)

DEFAULT_GRID = {
    "cache_size_fraction": [0.25, 0.5, 1.0],
    "num_collocate": [0, 2],
    "bin_fraction": [0.05, 0.1, 0.3],
    "queries_to_hot": [1, 2, 4],
    "queries_to_cold": [0, 1],
}


def config_name(cfg: dict) -> str:
    return "_".join("%s=%s" % (k, cfg[k]) for k in sorted(cfg))


def run_sweep(train_patterns, val_patterns, out_dir=None, grid=None,
              eval_limit=None, model_eval=None, skip_existing=True):
    """Run the grid; returns list of summary dicts.

    model_eval: optional callable(optimizer) -> accuracy stats dict, hooked
    in as the downstream-model metric (reference `evaluate_real`).
    """
    grid = dict(DEFAULT_GRID, **(grid or {}))
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    results = []
    keys = sorted(grid)
    for values in itertools.product(*(grid[k] for k in keys)):
        cfg = dict(zip(keys, values))
        if cfg["cache_size_fraction"] >= 1.0 and cfg["queries_to_cold"] > 0:
            continue  # no cold table to query
        path = (os.path.join(out_dir, config_name(cfg) + ".json")
                if out_dir else None)
        if path and skip_existing and os.path.exists(path):
            with open(path) as f:
                results.append(json.load(f))
            continue
        opt = BatchPIROptimize(
            train_patterns, val_patterns,
            HotColdConfig(cfg["cache_size_fraction"]),
            CollocateConfig(cfg["num_collocate"]),
            PIRConfig(bin_fraction=cfg["bin_fraction"],
                      queries_to_hot=cfg["queries_to_hot"],
                      queries_to_cold=cfg["queries_to_cold"]))
        opt.evaluate(limit=eval_limit)
        if model_eval is not None:
            opt.accuracy_stats = model_eval(opt)
        summary = opt.summarize_evaluation()
        summary["config"] = cfg
        results.append(summary)
        if path:
            with open(path, "w") as f:
                json.dump(summary, f, indent=1)
    return results
