"""Figure rendering for sweep / codesign results.

Port of ``dpf_tpu/apps/plots.py`` (the role of the reference's
``sweep/{taobao,movielens,language_model}_plot.py`` and
``codesign/plot_{rec,lm}.py``).  Matplotlib is optional; each function
raises ``RuntimeError`` if it is missing."""

from __future__ import annotations


def _plt():
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        return plt
    except ImportError as e:  # pragma: no cover
        raise RuntimeError("matplotlib is required for plotting") from e


def plot_recovery_vs_queries(sweep_results, out_path: str):
    """Mean fraction recovered vs hot-query budget, one line per bin size."""
    plt = _plt()
    by_bin = {}
    for r in sweep_results:
        cfg = r["config"]
        by_bin.setdefault(cfg["bin_fraction"], []).append(
            (cfg["queries_to_hot"], r["mean_recovered"]))
    fig, ax = plt.subplots(figsize=(6, 4))
    for bin_fraction, pts in sorted(by_bin.items()):
        pts.sort()
        ax.plot([p[0] for p in pts], [p[1] for p in pts], marker="o",
                label="bin_fraction=%g" % bin_fraction)
    ax.set_xlabel("queries to hot table")
    ax.set_ylabel("mean fraction of batch recovered")
    ax.set_ylim(0, 1.05)
    ax.legend()
    ax.grid(True, alpha=0.3)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def plot_latency_vs_recovery(points, out_path: str, frontier=None):
    """Codesign frontier: per-batch service latency vs recovery (accuracy)."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(6, 4))
    ax.scatter([p["latency_ms"] for p in points],
               [p["mean_recovered"] for p in points],
               s=18, alpha=0.6, label="configs")
    if frontier:
        fr = sorted(frontier, key=lambda p: p["latency_ms"])
        ax.plot([p["latency_ms"] for p in fr],
                [p["mean_recovered"] for p in fr],
                color="crimson", marker="o", label="pareto frontier")
    ax.set_xlabel("service latency (ms)")
    ax.set_ylabel("mean fraction recovered")
    ax.set_xscale("log")
    ax.legend()
    ax.grid(True, alpha=0.3)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def plot_throughput_table(perf_results, out_path: str):
    """dpfs/sec vs table size, one line per PRF (the README-style table)."""
    plt = _plt()
    by_prf = {}
    for r in perf_results:
        by_prf.setdefault(r.get("prf", "?"), []).append(
            (r["entries"], r["dpfs_per_sec"]))
    fig, ax = plt.subplots(figsize=(6, 4))
    for prf_name, pts in sorted(by_prf.items()):
        pts.sort()
        ax.plot([p[0] for p in pts], [p[1] for p in pts], marker="s",
                label=prf_name)
    ax.set_xlabel("table entries")
    ax.set_ylabel("dpfs / sec")
    ax.set_xscale("log", base=2)
    ax.set_yscale("log")
    ax.legend()
    ax.grid(True, alpha=0.3, which="both")
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path
