"""The port's planning tier (``dpf_tpu_torch/plan``, ``utils.compat.
device_memory_stats``, ``obs.metrics.register_planner``) against
dpf_tpu's, on the CPU.

The twin is a pure function of its inputs, so the port's ``simulate``
must give dpf_tpu's event log and summary on the cases of
``tests/test_plan.py`` (faults, autoscaling, admission and the paging
fields included), and the planner's and autoscale policy's answers must
be dpf_tpu's, exactly.  The twin's mirrors must agree with the port's
own ``Buckets``, ``FaultInjector`` and ``quantile``; the pure core must
import without torch; a small ``plan_bench`` on the CPU must give a
record of dpf_tpu's shape (``PLAN_r17.json``, dpf_tpu's record).
"""

import json
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from dpf_tpu.plan import autoscale as jautoscale
from dpf_tpu.plan import capacity as jcapacity
from dpf_tpu.plan import twin as jtwin
from dpf_tpu_torch.plan import autoscale, capacity, twin

ROOT = Path(__file__).resolve().parent.parent

#: tests/test_plan.py's synthetic cost table and mixed trace
COSTS = {"logn@4": 0.002, "logn@8": 0.003, "logn@16": 0.006,
         "sqrtn@4": 0.004, "sqrtn@8": 0.004, "sqrtn@16": 0.004}
TRACE = ([(0.005 * j, 16) for j in range(20)]
         + [(0.4 + 0.05 * j, 3) for j in range(8)]
         + [(1.0 + 0.004 * j, 16) for j in range(20)])
PEAKS = ([(0.002 * j, 16) for j in range(60)]
         + [(0.5 + 0.05 * j, 2) for j in range(8)]
         + [(1.2 + 0.002 * j, 16) for j in range(60)])
HOT = [(0.0005 * j, 16) for j in range(200)]

FAULTS = {"seed": 5, "specs": [
    {"kind": "dispatch_error", "p": 0.3, "start": 2},
    {"kind": "latency", "p": 0.5, "latency_s": 0.002},
    {"kind": "engine_death", "start": 25, "p": 1.0}]}
DEATH = {"seed": 9, "specs": [{"kind": "engine_death", "start": 30,
                               "p": 1.0}]}
AUTO = dict(decide_every_s=0.05, cooldown_s=0.1, max_replicas=4)
BASE = dict(replicas={"logn": 1, "sqrtn": 1}, bucket_sizes=(4, 8, 16))
KW = dict(bucket_sizes=(4, 8, 16), dispatch_blocking=False, slo_s=0.5,
          rebuild_s=0.1, spinup_s=0.01, retry_max_attempts=4)

#: (trace, fleet kwargs, simulate kwargs, autoscale policy kwargs)
CASES = {
    "faults+autoscale": (TRACE, dict(BASE, dispatch_blocking=False,
                                     slo_s=0.5, rebuild_s=0.2),
                         dict(seed=7, fault_plan=FAULTS), AUTO),
    "p0.4 seed 1": (TRACE, BASE, dict(seed=0, fault_plan={
        "seed": 1, "specs": [{"kind": "dispatch_error", "p": 0.4}]}), None),
    "p0.4 seed 2": (TRACE, BASE, dict(seed=0, fault_plan={
        "seed": 2, "specs": [{"kind": "dispatch_error", "p": 0.4}]}), None),
    "plain hot": (HOT, BASE, {}, None),
    "shed hot": (HOT, dict(BASE, slo_s=0.01, max_queue_depth=4, shed=True),
                 {}, None),
    "static 3": (PEAKS, dict(KW, replicas={"logn": 3}),
                 dict(seed=3, fault_plan=DEATH), None),
    "autoscaled": (PEAKS, dict(KW, replicas={"logn": 1}),
                   dict(seed=3, fault_plan=DEATH),
                   dict(decide_every_s=0.02, cooldown_s=0.04,
                        max_replicas=4)),
    "paged": (TRACE, dict(replicas={"logn": 2}, dispatch_blocking=False,
                          table_bytes=8 << 30, hbm_bytes_per_replica=4 << 30,
                          page_gbps=1024.0), dict(seed=0), None),
    "paged prefetched": (TRACE, dict(replicas={"logn": 2},
                                     dispatch_blocking=False,
                                     table_bytes=8 << 30,
                                     hbm_bytes_per_replica=4 << 30,
                                     page_gbps=1024.0, prefetch_overlap=0.9),
                         dict(seed=0), None),
}


def _run(mod_twin, mod_auto, case):
    trace, fleet_kw, sim_kw, auto_kw = case
    fleet = mod_twin.FleetConfig(**fleet_kw)
    pol = None if auto_kw is None else mod_auto.AutoscalePolicy(**auto_kw)
    return mod_twin.simulate(trace, COSTS, fleet, autoscaler=pol, **sim_kw)


@pytest.mark.parametrize("name", sorted(CASES))
def test_simulate_matches_dpf_tpu(name):
    """Equal event logs and summaries, run for run."""
    mine = _run(twin, autoscale, CASES[name])
    ref = _run(jtwin, jautoscale, CASES[name])
    assert mine.events == ref.events and mine.events
    assert mine.summary() == ref.summary()
    assert mine.engine_hours() == ref.engine_hours()


def test_simulate_is_reproducible_and_seeded():
    a = _run(twin, autoscale, CASES["faults+autoscale"])
    b = _run(twin, autoscale, CASES["faults+autoscale"])
    assert a.events == b.events and a.summary() == b.summary()
    assert a.summary()["faults_injected"]["engine_death"] == 1
    assert (_run(twin, autoscale, CASES["p0.4 seed 1"]).events
            != _run(twin, autoscale, CASES["p0.4 seed 2"]).events)


def test_fleet_config_and_cost_table_match_dpf_tpu():
    for kw in (BASE, CASES["paged prefetched"][1]):
        mine, ref = twin.FleetConfig(**kw), jtwin.FleetConfig(**kw)
        assert mine.as_dict() == ref.as_dict()
        assert mine.paging_stall_s() == ref.paging_stall_s()
        assert mine.hosts() == ref.hosts()
    ct, jct = (twin.CostTable(COSTS, overhead_s=0.001),
               jtwin.CostTable(COSTS, overhead_s=0.001))
    assert ct.as_dict() == jct.as_dict()
    for lb in ("logn", "sqrtn"):
        for bk in (1, 2, 4, 8, 16, 32, 64):
            assert ct.service_s(lb, bk) == jct.service_s(lb, bk)
    with pytest.raises(KeyError):
        ct.service_s("radix4", 8)
    with pytest.raises(ValueError):
        twin.FleetConfig(replicas={"logn": 1}, bucket_sizes=(3, 8))


@pytest.mark.parametrize("slo_s,scales,max_shed", [
    (0.05, (0.5, 1.0, 1.5, 2.0), 0.0),
    (0.02, (0.5, 1.0, 2.0, 4.0), 0.0),
    (1e-6, (1.0,), 0.0),
    (0.01, (0.25, 1.0, 3.0), 0.1)])
def test_planner_matches_dpf_tpu(slo_s, scales, max_shed):
    fleet_kw = {"bucket_sizes": (4, 8, 16)}
    for label in ("logn", "sqrtn"):
        mine = capacity.required_replicas(
            TRACE, COSTS, label=label, slo_s=slo_s, fleet_kw=fleet_kw,
            max_replicas=5, max_shed_rate=max_shed)
        ref = jcapacity.required_replicas(
            TRACE, COSTS, label=label, slo_s=slo_s, fleet_kw=fleet_kw,
            max_replicas=5, max_shed_rate=max_shed)
        assert mine.as_dict() == ref.as_dict()
        kw = dict(label=label, slo_s=slo_s, load_scales=scales,
                  fleet_kw=fleet_kw, max_replicas=5,
                  max_shed_rate=max_shed)
        plan = capacity.plan_fleet(TRACE, COSTS, **kw)
        assert plan == jcapacity.plan_fleet(TRACE, COSTS, **kw)
        assert plan["monotone"]
        mem = dict(kw, table_bytes=10 ** 9 * 64 * 4,
                   hbm_bytes_per_host=16 << 30)
        plan = capacity.plan_fleet(TRACE, COSTS, **mem)
        assert plan == jcapacity.plan_fleet(TRACE, COSTS, **mem)
        assert plan["memory"]["hbm_source"] == "explicit"


def test_min_hosts_and_the_memory_floor_match_dpf_tpu():
    for tb in (0, 1, 16 << 30, (16 << 30) + 1, 10 ** 9 * 64 * 4):
        for hbm in (1, 4 << 30, 16 << 30, 80 * 10 ** 9):
            assert (capacity.min_hosts_for_memory(tb, hbm)
                    == jcapacity.min_hosts_for_memory(tb, hbm))
    for bad in ((-1, 1), (1, 0)):
        with pytest.raises(ValueError):
            capacity.min_hosts_for_memory(*bad)
    # the CPU has no device ceiling: the default, recorded as such
    plan = capacity.plan_fleet(TRACE, COSTS, label="logn", slo_s=0.05,
                               table_bytes=1 << 40, device="cpu",
                               fleet_kw={"bucket_sizes": (4, 8, 16)})
    assert plan["memory"]["hbm_source"] == "default"
    assert plan["memory"]["hbm_bytes_per_host"] == capacity.DEFAULT_HBM_BYTES
    assert capacity.detect_hbm_budget("cpu") is None


def test_autoscale_decisions_match_dpf_tpu():
    rng = np.random.default_rng(12)
    for kw in ({}, dict(cooldown_s=0.0, ewma_alpha=1.0, max_replicas=3),
               dict(p99_low_frac=0.6, high_util=0.6, ewma_alpha=0.3)):
        mine = autoscale.AutoscalePolicy(**kw)
        ref = jautoscale.AutoscalePolicy(**kw)
        assert mine.as_dict() == ref.as_dict()
        replicas = 1
        for _ in range(200):
            sig = dict(util=float(rng.random() * 1.2),
                       p99_s=(None if rng.random() < 0.2
                              else float(rng.random())),
                       slo_s=(None if rng.random() < 0.1 else 0.5),
                       replicas=replicas,
                       since_change_s=float(rng.random()))
            got = mine.decide(**sig)
            assert got == ref.decide(**sig), sig
            replicas = max(1, replicas + {"up": 1, "down": -1}.get(got, 0))
    with pytest.raises(ValueError):
        autoscale.AutoscalePolicy(min_replicas=3, max_replicas=2)


# -------------------------------------------- mirrors of the port's classes

def test_fleet_bucket_math_matches_the_ports_buckets():
    from dpf_tpu_torch.serve import Buckets
    for sizes in [(4, 8, 16), (2, 16), (1, 2, 4, 8), (64, 128, 256, 512)]:
        fleet = twin.FleetConfig(replicas={"logn": 1}, bucket_sizes=sizes)
        bk = Buckets(sizes)
        assert fleet.max_bucket == bk.max
        for b in range(1, 4 * max(sizes) + 1):
            if b <= bk.max:
                assert fleet.bucket_for(b) == bk.bucket_for(b)
            assert fleet.chunks(b) == bk.chunks(b)


def test_fault_mirror_matches_the_ports_injector():
    from dpf_tpu_torch.serve.faults import FaultPlan, FaultSpec
    plan = FaultPlan(specs=[
        FaultSpec(kind="dispatch_error", p=0.35),
        FaultSpec(kind="latency", p=0.6, construction="logn",
                  latency_s=0.01, max_fires=3),
        FaultSpec(kind="engine_death", p=0.5, start=3),
        FaultSpec(kind="host_drop", bucket=8, p=0.9, stop=9),
    ], seed=42)
    real = plan.injector()
    mirror = twin.FaultMirror(plan.as_dict())
    for j in range(12):
        real.begin_arrival(j)
        mirror.begin_arrival(j)
        for consult in range(3):
            for idx, spec in enumerate(plan.specs):
                r_fire = m_fire = False
                if (real._fires_left(idx, spec)
                        and spec.matches("logn", 8, j)):
                    r_fire = real._decide(idx, spec)
                m_spec = mirror.specs[idx]
                if (mirror._fires_left(idx, m_spec)
                        and mirror._matches(m_spec, "logn", 8)):
                    m_fire = mirror._decide(idx, m_spec)
                assert r_fire == m_fire, (j, consult, idx)
    assert mirror.injected == {k: v for k, v in real.injected.items() if v}


def test_twin_quantile_matches_the_ports_profiling():
    from dpf_tpu_torch.utils import profiling
    rng = np.random.default_rng(3)
    for n in (1, 2, 7, 100, 2048):
        xs = list(rng.random(n))
        for q in (0.0, 0.5, 0.95, 0.99, 1.0):
            assert twin.quantile(xs, q) == profiling.quantile(xs, q)
    assert twin.LATENCY_RING == profiling.LATENCY_RING


def test_plan_core_imports_without_torch():
    """The twin, planner and autoscaler load and simulate with neither
    torch nor the port's package root (which imports torch) imported."""
    import dpf_tpu_torch.plan as plan_pkg
    prog = textwrap.dedent("""
        import sys, types
        pkg = types.ModuleType("planpkg")
        pkg.__path__ = [%r]
        sys.modules["planpkg"] = pkg
        from planpkg.twin import FleetConfig, simulate
        from planpkg.capacity import plan_fleet
        from planpkg.autoscale import AutoscalePolicy, ReplicaPool
        res = simulate([(0.0, 4), (0.01, 8)], {"logn@8": 0.001},
                       FleetConfig(replicas={"logn": 1},
                                   bucket_sizes=(8,)))
        assert res.summary()["served"] == 2
        banned = [m for m in sys.modules if m.split(".")[0] in
                  ("torch", "jax", "jaxlib", "dpf_tpu", "dpf_tpu_torch")]
        assert not banned, "loaded: %%s" %% banned
        print("OK")
    """) % list(plan_pkg.__path__)[0]
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "OK" in out.stdout


# ------------------------------------------ device memory, metrics, bench

def test_device_memory_stats_on_cpu_and_a_patched_card(monkeypatch):
    from dpf_tpu_torch.utils.compat import device_memory_stats
    assert device_memory_stats("cpu") is None
    assert device_memory_stats(torch.device("cpu")) is None
    seen = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda d=None: seen.append(d) or (7 << 30, 80 << 30))
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda d=None: 123)
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda d=None: 456)
    assert device_memory_stats() == {
        "bytes_limit": 80 << 30, "bytes_free": 7 << 30,
        "bytes_in_use": 123, "bytes_reserved": 456}
    assert seen == [torch.device("cuda")]
    assert capacity.detect_hbm_budget() == 80 << 30
    assert capacity.detect_hbm_budget("cuda:0") == 80 << 30

    def lost(d=None):
        raise RuntimeError("CUDA error: device lost")
    monkeypatch.setattr(torch.cuda, "mem_get_info", lost)
    with pytest.raises(RuntimeError, match="device lost"):
        device_memory_stats("cuda")
    with pytest.raises(RuntimeError, match="device lost"):
        capacity.detect_hbm_budget()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        device_memory_stats()


def _series(metrics_mod, stats):
    reg = metrics_mod.MetricsRegistry()
    metrics_mod.register_planner(stats, registry=reg)
    return sorted({line.split("{")[0].split(" ")[0]
                   for line in reg.openmetrics().splitlines()
                   if line and not line.startswith("#")})


def test_register_planner_gives_dpf_tpus_series():
    from dpf_tpu.obs import metrics as jmetrics
    from dpf_tpu_torch.obs import metrics
    mine, ref = twin.PlannerStats(), jtwin.PlannerStats()
    for s in (mine, ref):
        s.twin_runs, s.sweeps, s.last_p99_ms, s.last_replicas = 3, 2, 1.5, 4
    got = _series(metrics, mine)
    assert got == _series(jmetrics, ref)
    assert "dpf_plan_twin_runs_total" in got
    assert "dpf_plan_last_replicas" in got


def _keys(d, depth=2):
    if not isinstance(d, dict) or depth == 0:
        return None
    return {k: _keys(v, depth - 1) for k, v in d.items()}


def test_plan_bench_on_cpu_has_dpf_tpus_record_shape(monkeypatch):
    from dpf_tpu_torch.plan.bench_plan import plan_bench
    monkeypatch.setenv("DPF_TPU_TORCH_TUNE_CACHE", "0")
    rec = plan_bench(n=256, entry_size=4, cap=8, prf=0, seed=11,
                     duration_s=1.0, on_rate=20.0, reps=1, distinct=4,
                     max_replicas=4, device="cpu", quiet=True)
    ref = json.loads((ROOT / "PLAN_r17.json").read_text())
    assert set(rec) - set(ref) == {"device"}
    assert set(ref) <= set(rec)
    for sec in ("fidelity", "planner", "autoscale_twin", "autoscale_real",
                "plan_stats"):
        assert set(rec[sec]) == set(ref[sec]), sec
    assert [leg["name"] for leg in rec["fidelity"]["legs"]] == [
        leg["name"] for leg in ref["fidelity"]["legs"]]
    assert set(rec["fidelity"]["legs"][0]) == set(
        ref["fidelity"]["legs"][0])
    assert rec["fidelity"]["dispatch_model"] == "blocking"
    assert rec["device"] == "cpu"
    assert rec["gate_rejections"] == 0 and rec["planner"]["monotone"]
    assert rec["autoscale_real"]["ok"]
    assert rec["plan_stats"]["twin_runs"] > 0


def test_replica_pool_scales_the_ports_engines():
    from dpf_tpu_torch import DPF
    from dpf_tpu_torch.serve import ServingEngine
    from dpf_tpu_torch.serve.engine import EngineClosed
    n = 256
    srv = DPF(prf=0, device="cpu")
    srv.eval_init(np.random.default_rng(17).integers(
        0, 2 ** 31, (n, 4), dtype=np.int64).astype(np.int32))
    keys = srv.gen_batch([i % n for i in range(4)], n)[0]
    refs = srv.eval_cpu(keys).numpy()
    pool = autoscale.ReplicaPool(
        lambda: ServingEngine(srv, max_in_flight=2, buckets=(4, 8),
                              label="logn"),
        policy=autoscale.AutoscalePolicy(max_replicas=2), initial=1)
    futs = [pool.submit(keys[:2]) for _ in range(3)]
    pool.scale_up()
    assert len(pool.replicas) == 2 and pool.scale_ups == 1
    futs.append(pool.submit(keys))
    kept = pool.replicas[0]
    assert pool.scale_down() and not pool.scale_down()
    for f in futs[:3]:
        assert np.array_equal(f.result(), refs[:2])
    assert np.array_equal(futs[3].result(), refs)
    assert pool.close() > 0 and not pool.replicas
    with pytest.raises(EngineClosed):
        kept.submit(keys[:1])
