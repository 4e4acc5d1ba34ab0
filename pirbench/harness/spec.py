"""Cells by name: ``BENCHMARK.json`` at the checkout's root names each
cell's configuration and traffic, and every piece is a file found by
that name.  The runner holds no table of cells."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

PKG = Path(__file__).resolve().parents[1]          # pirbench/
ROOT = PKG.parent                                  # the checkout
BENCHMARK = ROOT / "BENCHMARK.json"


def load_benchmark(path: Path = BENCHMARK) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """Import one file of ``pirbench/`` by its path."""
    name = "pirbench_" + "_".join(path.relative_to(PKG).with_suffix(
        "").parts).replace("-", "_").replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(bench: dict, name: str, *,
              traffic_dir: Path = PKG / "traffic") -> dict:
    """The cell ``name``: its entry, configuration (the file's contents),
    traffic (``traffic_dir/<traffic>.json``) and the metrics it reports."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError("no workload %r in BENCHMARK.json (have %s)"
                       % (name, ", ".join(sorted(cells))))
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    with open(ROOT / configs[cell["config"]]["file"]) as f:
        config = json.load(f)
    with open(traffic_dir / (cell["traffic"] + ".json")) as f:
        traffic = json.load(f)
    return {"name": name, "entry": cell, "config": config,
            "traffic": traffic,
            "end_to_end": [m for m in bench["end_to_end"]
                           if _applies(m, name)],
            "per_layer": [m for m in bench["per_layer"]
                          if _applies(m, name)]}


def cipher(name: str):
    return load_module(PKG / "ciphers" / (name + ".py"))


def construction(name: str):
    return load_module(PKG / "constructions" / (name + ".py"))


def work(name: str):
    return load_module(PKG / "work" / (name + ".py"))


def reader(metric: str):
    """The reader of a per-layer metric: ``metrics/<name>.py``, else the
    reader of its quantity, ``metrics/<name before the first dot>.py``
    (``engine_host_ms.bulk`` and ``engine_host_ms.serve`` read alike)."""
    for stem in (metric, metric.split(".")[0]):
        path = PKG / "metrics" / (stem + ".py")
        if path.exists():
            return load_module(path)
    raise FileNotFoundError("no reader for per-layer metric %r under %s"
                            % (metric, PKG / "metrics"))
