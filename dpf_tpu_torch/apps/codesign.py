"""Codesign join: batch-PIR accuracy sweeps x measured DPF server perf.

Port of ``dpf_tpu/apps/codesign.py`` (the reference's
``paper/experimental/codesign/join_batch_pir_accuracy_with_gpu_dpf.py``):
combines (a) recovery/accuracy summaries from a config sweep with (b)
measured eval throughput (``utils.bench.test_dpf_perf`` records) into
latency/throughput-vs-accuracy frontier points, modelling hot and cold
service on two devices (or one).
"""

from __future__ import annotations


def join_sweep_with_perf(sweep_results, perf_results, entry_size_bytes=64):
    """Join sweep summaries with measured perf dicts.

    perf_results: list of dicts from ``utils.bench.test_dpf_perf``
    (keys: entries, dpfs_per_sec, ...).  For each sweep config, the hot and
    cold tables are matched to the smallest benchmarked table size that
    covers their bin count, and per-query latency/throughput is derived.

    Returns a list of frontier points:
      {accuracy, mean_recovered, queries_per_sec, latency_ms, upload_bytes,
       download_bytes, config}
    """
    perf_by_entries = sorted(
        ((int(p["entries"]), float(p["dpfs_per_sec"])) for p in perf_results))
    if not perf_by_entries:
        raise ValueError("no perf results to join against")

    def dpfs_per_sec_for(table_len):
        """(rate, extrapolated?) — the smallest measured size covering
        ``table_len``, or a 1/N extrapolation past the largest measured
        point (flagged so frontier consumers can see which points rest
        on real measurements)."""
        for entries, rate in perf_by_entries:
            if entries >= max(table_len, 1):
                return rate, False
        entries, rate = perf_by_entries[-1]
        return rate * entries / max(table_len, 1), True

    points = []
    for s in sweep_results:
        cfg = s.get("config", {})
        extra = s["extra"]
        qh = s["pir_config"]["queries_to_hot"]
        qc = s["pir_config"]["queries_to_cold"]
        # one DPF per bin per query round; each bin is its own mini-table
        hot_bins = max(1, extra["hot_table_size"]
                       // max(extra["hot_table_entries_per_bin"], 1))
        cold_bins = (extra["cold_table_size"]
                     // max(extra["cold_table_entries_per_bin"], 1)
                     if extra["cold_table_size"] else 0)
        hot_rate, hot_ex = dpfs_per_sec_for(
            extra["hot_table_entries_per_bin"])
        cold_rate, cold_ex = (
            dpfs_per_sec_for(extra["cold_table_entries_per_bin"])
            if cold_bins else (float("inf"), False))
        # hot and cold tables served by two devices in parallel (ref :49-133)
        hot_time = qh * hot_bins / hot_rate
        cold_time = (qc * cold_bins / cold_rate) if cold_bins else 0.0
        service_time = max(hot_time, cold_time)
        points.append({
            "config": cfg,
            "accuracy": (s.get("accuracy_stats") or {}).get("roc_auc"),
            "mean_recovered": s["mean_recovered"],
            "latency_ms": service_time * 1e3,
            "queries_per_sec": (1.0 / service_time if service_time > 0
                                else float("inf")),
            "upload_bytes": s["cost"]["upload_communication"],
            "download_bytes": s["cost"]["download_communication"],
            "perf_extrapolated": bool(hot_ex or cold_ex),
        })
    points.sort(key=lambda p: p["mean_recovered"], reverse=True)
    return points


def pareto_frontier(points, x="latency_ms", y="mean_recovered"):
    """Lower-x / higher-y pareto-optimal subset."""
    frontier = []
    best_y = -float("inf")
    for p in sorted(points, key=lambda p: (p[x], -p[y])):
        if p[y] > best_y:
            frontier.append(p)
            best_y = p[y]
    return frontier
