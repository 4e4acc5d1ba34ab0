"""The port's chaos and multi-tenant benches and the loadgen planning
helpers, on the CPU.

``loadgen.scale_rate`` / ``concat_traces`` / ``bucket_rates`` give
``dpf_tpu``'s traces and rates on the same seeded inputs.
``chaos_bench`` at its dryrun size serves three legs (baseline, faults,
faults + an engine death) with every accepted answer equal to the CPU
oracle (``gate_escapes == 0``) and every injected corruption caught by
the inline check (``corruptions_detected == injected``).
``multitenant_bench`` at its dryrun size serves four tenants (three
shapes and one table-sharing tenant) with 0 gate escapes, the shared
ladder, a degraded victim, one promotion in its cold-table leg and
every tenant's label in the record's metrics.  Only deterministic
results are asserted: no latency, p99 or ratio.
"""

import numpy as np
import pytest
import torch

from dpf_tpu.serve import loadgen as jloadgen
from dpf_tpu.serve.buckets import Buckets as JBuckets
from dpf_tpu_torch.serve import bench_chaos, bench_multitenant, loadgen
from dpf_tpu_torch.serve.buckets import Buckets


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tuples(trace):
    return [(a.t, a.n, a.batch) for a in trace]


def _pair(kind, **kw):
    return (jloadgen.make_trace(kind, **kw), loadgen.make_trace(kind, **kw))


def test_scale_rate_matches_dpf_tpu():
    jtr, tr = _pair("bursty", on_rate=40.0, off_rate=3.0, on_s=0.5,
                    off_s=1.0, duration_s=4.0, cap=64, seed=5, n=4096)
    for f in (0.5, 1.0, 2.0, 4.0):
        assert _tuples(loadgen.scale_rate(tr, f)) == \
            _tuples(jloadgen.scale_rate(jtr, f))
        assert loadgen.scale_rate(tr, f) == loadgen.squeeze(tr, f)
    for mod, t in ((jloadgen, jtr), (loadgen, tr)):
        with pytest.raises(ValueError):
            mod.scale_rate(t, 0.0)


def test_concat_traces_matches_dpf_tpu():
    jday, day = _pair("diurnal", base_rate=5.0, peak_rate=30.0,
                      period_s=3.0, duration_s=3.0, cap=32, seed=9)
    jp, p = _pair("poisson", rate=20.0, duration_s=1.0, cap=16, seed=2)
    cases = [((day, day), {}), ((day, p, day), {"gap_s": 1.5}),
             (([], day, []), {}), ((), {}), ((p,), {"gap_s": 0.25})]
    jcases = [((jday, jday), {}), ((jday, jp, jday), {"gap_s": 1.5}),
              (([], jday, []), {}), ((), {}), ((jp,), {"gap_s": 0.25})]
    for (args, kw), (jargs, jkw) in zip(cases, jcases):
        got = loadgen.concat_traces(*args, **kw)
        assert _tuples(got) == _tuples(jloadgen.concat_traces(*jargs,
                                                              **jkw))
        assert loadgen.batch_sizes(got) == [
            a.batch for tr in args for a in tr]
    with pytest.raises(ValueError):
        loadgen.concat_traces(day, gap_s=-0.1)


def test_bucket_rates_matches_dpf_tpu():
    jtr, tr = _pair("bursty", on_rate=60.0, off_rate=2.0, on_s=1.0,
                    off_s=2.0, duration_s=6.0, cap=128, seed=11, n=4096)
    for sizes in ((16, 32, 64, 128), (4, 8), (128,)):
        got = loadgen.bucket_rates(tr, Buckets(sizes))
        assert got == jloadgen.bucket_rates(jtr, JBuckets(sizes))
        assert loadgen.bucket_rates(tr, sizes, duration_s=3.0) == \
            jloadgen.bucket_rates(jtr, sizes, duration_s=3.0)
    arrivals = [loadgen.Arrival(0.5, None, 3), loadgen.Arrival(1.0, None, 8),
                loadgen.Arrival(2.0, None, 20)]
    assert loadgen.bucket_rates(arrivals, (4, 8)) == {4: 1.0, 8: 1.5}
    assert loadgen.bucket_rates([4], (4, 8), duration_s=2.0) == \
        {4: 0.5, 8: 0.0}
    assert loadgen.bucket_rates([loadgen.Arrival(0.001, None, 4)],
                                (4,)) == {4: 1.0}
    with pytest.raises(ValueError):
        loadgen.bucket_rates([4], (4, 8), duration_s=0.0)


def _check_chaos(rec):
    assert rec["device"] == "cpu"
    assert rec["gate_escapes"] == 0
    injected = 0
    for leg in ("baseline_leg", "faults_leg", "chaos_leg"):
        r = rec[leg]
        assert r["gate_escapes"] == 0, leg
        f = r["faults"]
        assert f["corruptions_detected"] == f["corruptions_injected"], leg
        assert f["corruptions_injected"] == f["injected"]["corrupt_shares"]
        injected += f["corruptions_injected"]
        assert r["arrivals"] == rec["trace"]["arrivals"]
    assert rec["baseline_leg"]["faults"]["injected"] == {
        k: 0 for k in rec["baseline_leg"]["faults"]["injected"]}
    assert rec["faults_leg"]["faults"]["injected"]["dispatch_error"] > 0
    assert rec["chaos_leg"]["faults"]["injected"]["engine_death"] <= 1
    assert rec["chaos_leg"]["victim"] in ("logn", "radix4", "sqrtn")
    assert "dpf_router_routes" in rec["obs"]["metrics"]
    return injected


def test_chaos_bench_dryrun_gates_hold():
    rec = bench_chaos.main(["--dryrun", "--device", "cpu"])
    _check_chaos(rec)


def test_chaos_bench_detects_every_corruption():
    """A corruption rate high enough that corrupted batches certainly
    occur: each is caught by the inline check and served again."""
    rec = bench_chaos.chaos_bench(
        n=512, entry_size=8, cap=16, duration_s=1.5, on_rate=20.0,
        distinct=8, breaker_reset_s=0.2, corrupt_p=0.5, device="cpu",
        quiet=True)
    assert _check_chaos(rec) > 0
    assert rec["faults_leg"]["reserves_after_gate"] > 0


def test_multitenant_bench_dryrun():
    rec = bench_multitenant.multitenant_bench(
        dryrun=True, duration_s=1.2, distinct=6, device="cpu", quiet=True)
    assert rec["device"] == "cpu"
    assert rec["gate_escapes"] == 0
    assert rec["ladder_shared"] is True
    assert rec["victim_degraded"] is True
    assert rec["per_tenant_series"]["visible"] is True
    assert rec["per_tenant_series"]["metrics_tenants"] == sorted(
        bench_multitenant.CONFIGS["dryrun"])
    assert len({(t["n"], t["entry_size"])
                for t in rec["tenants"].values()}) == 3
    assert rec["tolerance"] == bench_multitenant.TOLERANCE == 1.5
    slack = rec["slack"]
    assert slack["batches"] == 3 and slack["tenant"] == "alpha"
    assert slack["ms"] == pytest.approx(3 * slack["batch_ms"], abs=1e-3)
    for name, iso in rec["isolation"].items():
        assert name != "victim"
        assert iso["p99_slack_ms"] == slack["ms"]
    sched = rec["scheduler"]["tenants"]
    for name, st in sched.items():
        assert st["in_flight"] == 0 and st["queue_depth"] == 0, name
    assert rec["scheduler"]["registry"]["counters"]["registrations"] == 3
    cold = rec["cold_table"]
    assert cold["demoted"] == "alpha" and cold["promotions"] == 1
    assert cold["promotion_s"] is not None
    assert rec["scheduler"]["registry"]["counters"]["promotions"] == 1
    plan = rec["faults"]["plan"]
    assert [s["kind"] for s in plan["specs"]] == ["dispatch_error",
                                                  "engine_death"]
    assert np.isfinite(rec["value"])
