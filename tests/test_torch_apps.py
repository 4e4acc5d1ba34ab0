"""The port's ``apps`` (sweep, codesign, plots) and ``serve/bench_pir``
against dpf_tpu's, on the CPU.

The sweep's summaries and the codesign join's frontier points equal
dpf_tpu's for the same access patterns; a small ``pir_point`` runs on
the CPU through its own equality gates.
"""

import sys

import numpy as np
import pytest
import torch

from dpf_tpu.apps import codesign as jcodesign
from dpf_tpu.apps import sweep as jsweep
from dpf_tpu_torch.apps import codesign, plots, sweep
from dpf_tpu_torch.serve import bench_pir


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _patterns(n_entries=100, n_sets=40, seed=0):
    rng = np.random.default_rng(seed)
    popularity = 1.0 / np.arange(1, n_entries + 1)
    popularity /= popularity.sum()
    return [[int(x) for x in rng.choice(n_entries, size=int(k),
                                        p=popularity)]
            for k in rng.integers(3, 10, n_sets)]


GRID = {"cache_size_fraction": [0.5, 1.0], "num_collocate": [0, 2],
        "bin_fraction": [0.2], "queries_to_hot": [1, 2],
        "queries_to_cold": [0, 1]}

PERF = [{"entries": 128, "dpfs_per_sec": 100000.0},
        {"entries": 16384, "dpfs_per_sec": 50000.0}]


def test_sweep_matches_dpf_tpu(tmp_path):
    """Every grid point's summary equals dpf_tpu's, and a second run
    loads the port's files from disk."""
    train, val = _patterns(seed=1), _patterns(seed=2)
    res = sweep.run_sweep(train, val, out_dir=str(tmp_path), grid=GRID)
    ref = jsweep.run_sweep(train, val, grid=GRID)
    assert len(res) == len(ref) == 12    # queries_to_cold > 0 needs cold
    assert res == ref
    assert sweep.run_sweep(train, val, out_dir=str(tmp_path),
                           grid=GRID) == res
    assert sweep.config_name(res[0]["config"]) == \
        jsweep.config_name(ref[0]["config"])


def test_sweep_more_queries_never_recover_less():
    pats = _patterns(seed=3)
    grid = {"cache_size_fraction": [1.0], "num_collocate": [0],
            "bin_fraction": [0.1, 0.3], "queries_to_hot": [1, 4],
            "queries_to_cold": [0]}
    res = sweep.run_sweep(pats, pats, grid=grid)
    by = {(r["config"]["bin_fraction"], r["config"]["queries_to_hot"]):
          r["mean_recovered"] for r in res}
    assert by[(0.1, 4)] >= by[(0.1, 1)] and by[(0.3, 4)] >= by[(0.3, 1)]


def test_codesign_join_and_frontier_match_dpf_tpu():
    res = sweep.run_sweep(_patterns(seed=1), _patterns(seed=2), grid=GRID)
    pts = codesign.join_sweep_with_perf(res, PERF)
    assert pts == jcodesign.join_sweep_with_perf(res, PERF)
    assert all(p["latency_ms"] > 0 and p["queries_per_sec"] > 0
               for p in pts)
    fr = codesign.pareto_frontier(pts)
    assert fr == jcodesign.pareto_frontier(pts)
    recs = [p["mean_recovered"] for p in fr]
    assert 1 <= len(fr) <= len(pts) and recs == sorted(recs)


def test_codesign_extrapolates_past_the_largest_measurement():
    res = sweep.run_sweep(_patterns(n_entries=400, seed=5),
                          _patterns(n_entries=400, seed=6),
                          grid={"cache_size_fraction": [1.0],
                                "num_collocate": [0], "bin_fraction": [0.9],
                                "queries_to_hot": [1], "queries_to_cold": [0]})
    perf = [{"entries": 16, "dpfs_per_sec": 1000.0}]
    pts = codesign.join_sweep_with_perf(res, perf)
    assert pts == jcodesign.join_sweep_with_perf(res, perf)
    assert pts[0]["perf_extrapolated"]
    with pytest.raises(ValueError, match="no perf results"):
        codesign.join_sweep_with_perf(res, [])


def test_plots_draw_where_matplotlib_imports(tmp_path):
    pytest.importorskip("matplotlib")
    res = sweep.run_sweep(_patterns(seed=1), _patterns(seed=2), grid=GRID)
    pts = codesign.join_sweep_with_perf(res, PERF)
    for path in (
            plots.plot_recovery_vs_queries(res, str(tmp_path / "a.png")),
            plots.plot_latency_vs_recovery(
                pts, str(tmp_path / "b.png"),
                frontier=codesign.pareto_frontier(pts)),
            plots.plot_throughput_table(PERF, str(tmp_path / "c.png"))):
        assert (tmp_path / path.split("/")[-1]).stat().st_size > 0


def test_plots_raise_without_matplotlib(monkeypatch):
    """Without matplotlib (the card's machine has none) each function
    raises the same RuntimeError as dpf_tpu's."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(RuntimeError, match="matplotlib is required"):
        plots.plot_throughput_table(PERF, "unused.png")


def test_pir_point_runs_on_the_cpu():
    """A tiny deployment (4096 entries, 16 bins of 256) through every
    gate of ``pir_point``: batched keys equal to the per-bin loop,
    answer equal to answer_scalar, streaming equal to answer, recovered
    rows equal to the table."""
    p = bench_pir.pir_point(entries=4096, bin_fraction=1 / 16., rounds=2,
                            reps=1, quiet=True, device="cpu")
    assert p["device"] == "cpu" and p["bins"] == 16
    assert p["answer"]["size_groups"] == {"256": 16}
    assert p["group_constructions"] == {"256": ["logn", 2]}
    assert p["e2e"]["batched_qps"] > 0 and p["streaming"]["qps"] > 0
    assert sum(s["batches_submitted"]
               for s in p["streaming"]["stats"].values()) == 4


def test_bench_pir_record_names_the_device(tmp_path):
    out = tmp_path / "pir.json"
    rec = bench_pir.main(["--entries", "2048", "--bin-fraction", "0.25",
                          "--scheme", "sqrtn", "--rounds", "1", "--reps",
                          "1", "--device", "cpu", "--out", str(out)])
    assert rec["device"] == "cpu" and rec["checked"]
    assert rec["points"][0]["group_constructions"] == {"512": ["sqrtn", 2]}
    assert out.exists()
