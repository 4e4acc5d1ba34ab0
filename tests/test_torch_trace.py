"""The port's profiler helpers, cache counters, build cache, joint digest
and observability bench, on the CPU."""

import gzip
import json
import threading

import numpy as np
import pytest
import torch

from dpf_tpu.utils import profiling as jprofiling
from dpf_tpu_torch.obs import bench_trace
from dpf_tpu_torch.obs import tracer as obs_tracer
from dpf_tpu_torch.ops import cuda_build
from dpf_tpu_torch.tune import cache as tcache
from dpf_tpu_torch.tune import compcache
from dpf_tpu_torch.utils import profiling


@pytest.fixture(autouse=True)
def fresh_cache(tmp_path, monkeypatch):
    monkeypatch.setenv(tcache.ENV, str(tmp_path / "tuning.json"))
    tcache.default_cache(refresh=True)


def _write_trace(path, events, gz=False):
    opener = gzip.open if gz else open
    with opener(path, "wt") as f:
        json.dump({"traceEvents": events}, f)


def test_self_times_match_dpf_tpu():
    events = [{"ph": "X", "name": "outer", "ts": 0, "dur": 100},
              {"ph": "X", "name": "inner", "ts": 10, "dur": 30},
              {"ph": "X", "name": "inner2", "ts": 50, "dur": 20},
              {"ph": "X", "name": "leaf", "ts": 55, "dur": 5},
              {"ph": "X", "name": "next", "ts": 120, "dur": 7}]
    assert profiling._self_times(events) == jprofiling._self_times(events)
    assert dict(map(tuple, profiling._self_times(events))) == {
        "outer": 50.0, "inner": 30.0, "inner2": 15.0, "leaf": 5.0,
        "next": 7.0}


@pytest.mark.parametrize("gz", [False, True])
def test_summarize_trace_reads_the_card_tracks(tmp_path, gz):
    events = [
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "pid": 1,
         "tid": 1, "ts": 0, "dur": 900},
        {"ph": "X", "cat": "kernel", "name": "subtree_kernel", "pid": 0,
         "tid": 7, "ts": 5, "dur": 400},
        {"ph": "X", "cat": "kernel", "name": "contract_kernel", "pid": 0,
         "tid": 7, "ts": 500, "dur": 100},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "pid": 0,
         "tid": 8, "ts": 0, "dur": 50},
        {"ph": "M", "name": "thread_name", "pid": 0, "tid": 7}]
    name = "run.pt.trace.json" + (".gz" if gz else "")
    _write_trace(tmp_path / name, events, gz)
    d = profiling.summarize_trace(str(tmp_path))
    assert d["tracks"] == "cuda_device" and d["device_ms"] == 0.55
    assert d["top_ops"][0] == {"op": "subtree_kernel", "ms": 0.4}
    assert profiling.summarize_trace(str(tmp_path / "none")) is None


def test_trace_and_summarize_on_the_cpu(tmp_path):
    with profiling.trace("small", base_dir=str(tmp_path)) as tdir:
        a = torch.arange(64 * 64, dtype=torch.float32).reshape(64, 64)
        (a @ a).sum()
    d = profiling.summarize_trace(tdir)
    assert d["trace_file"] == "small.pt.trace.json"
    assert d["tracks"] == "cpu_ops" and d["device_ms"] > 0
    assert any("mm" in op["op"] for op in d["top_ops"])
    t = obs_tracer.Tracer()
    with t.span("submit"):
        with t.span("dispatch"):
            pass
    joint = obs_tracer.joint_digest(tracer=t, trace_dir=tdir)
    assert {s["span"] for s in joint["host"]["top_spans"]} == {
        "submit", "dispatch"}
    assert joint["total_ms"] == round(joint["host"]["host_ms"]
                                      + joint["device"]["device_ms"], 3)
    assert obs_tracer.joint_digest(tracer=None) == {
        "host": None, "device": None, "total_ms": 0}


@pytest.mark.parametrize("native", [True, False])
def test_span_rings_match_dpf_tpu(native):
    """The C ring and the plain-Python ring keep what ``dpf_tpu``'s
    tracer keeps: the same spans after eviction, nesting, attributes
    (``set`` through ``as``, the error of a raising span) and threads."""
    from dpf_tpu.obs import tracer as jtracer

    def drive(span):
        with span("submit", batch=3):
            with span("admit"):
                pass
            with span("pack", phase="decode") as sp:
                sp.set(bucket=16)
        with pytest.raises(KeyError):
            with span("route", batch=1):
                raise KeyError("x")

        def worker():
            with span("rebuild", construction="logn"):
                with span("wait"):
                    pass
        th = threading.Thread(target=worker)
        th.start()
        th.join()
        for i in range(4):
            with span("decode", parts=i):
                pass

    def shape(tracer):
        ev = tracer.events()
        names = {e["span_id"]: e["name"] for e in ev}
        return sorted((e["name"], names.get(e["parent_id"]) or "",
                       json.dumps(e.get("attrs"), sort_keys=True),
                       e["tid"] == threading.get_ident()) for e in ev)

    ours = obs_tracer.Tracer(capacity=9, native=native)
    assert ours.native == (native and obs_tracer.spanring_error() is None)
    ref = jtracer.Tracer(capacity=9)
    drive(ours.span)
    drive(ref.span)
    assert shape(ours) == shape(ref)
    assert (ours.recorded, ours.dropped) == (ref.recorded, ref.dropped)
    assert all(e["dur_us"] >= e["self_us"] >= 0 for e in ours.events())
    ours.clear()
    assert (ours.recorded, ours.events()) == (0, [])


def test_timer_and_cache_counters():
    with profiling.Timer() as t:
        sum(range(1000))
    assert t.elapsed > 0
    c = profiling.CacheCounters(tuning_hits=2, compile_misses=1,
                                compile_time_saved_s=0.123456)
    assert c.as_dict() == {
        "tuning_hits": 2, "tuning_misses": 0, "tuning_stores": 0,
        "compile_hits": 0, "compile_misses": 1,
        "compile_time_saved_s": 0.1235}
    assert set(c.as_dict()) == set(jprofiling.CacheCounters().as_dict())
    assert c.reset().as_dict() == profiling.CacheCounters().as_dict()


def test_build_cache_counts_hits_and_misses(tmp_path, monkeypatch):
    old = cuda_build.BUILD_DIR
    try:
        d = compcache.enable(str(tmp_path / "builds"))
        assert compcache.enabled_dir() == d and cuda_build.BUILD_DIR.is_dir()
        assert str(cuda_build.library_path("contract")).startswith(d)
        cuda_build.library_path("contract").write_bytes(b"")  # present
        h, m = (profiling.CACHE_COUNTERS.compile_hits,
                profiling.CACHE_COUNTERS.compile_misses)
        assert cuda_build.build(("contract",)) == {}
        assert profiling.CACHE_COUNTERS.compile_hits == h + 1
        monkeypatch.setattr(cuda_build, "nvcc_path", lambda: (_ for _ in (
            )).throw(RuntimeError("nvcc not found")))
        with pytest.raises(RuntimeError, match="nvcc"):
            cuda_build.build(("subtree",))
        assert profiling.CACHE_COUNTERS.compile_misses == m + 1
        # no argument: the package's own build directory
        assert compcache.enable() == str(
            (cuda_build.PACKAGE_DIR / "_build").resolve())
    finally:
        cuda_build.BUILD_DIR = old
    assert compcache.default_dir() == str(cuda_build.PACKAGE_DIR / "_build")


def test_bench_trace_dryrun_holds_its_gates(tmp_path):
    rec = bench_trace.trace_bench(
        n=512, entry_size=8, cap=16, prf=0, seed=11, duration_s=1.5,
        on_rate=30.0, distinct=4, reps=1, profile_arrivals=12,
        constructions=("logn", "radix4"), trace_dir=str(tmp_path),
        overhead_gate=False, device="cpu", quiet=True)
    assert rec["checked"], rec["profile"]["joint_digest"]
    assert all(rec["openmetrics"]["families_required"].values())
    assert rec["chaos_flight"]["attributed_faults"] >= 1
    assert rec["profile"]["joint_digest"]["device"]["tracks"] == "cpu_ops"
    assert rec["overhead"]["pairs"] >= 1
    assert np.isfinite(rec["value"])
