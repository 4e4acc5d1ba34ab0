"""The port's fault machinery, router and load harness against dpf_tpu's,
on the CPU.

Seeded ``FaultInjector`` decisions, ``RetryPolicy`` backoffs and
``FaultPlan`` round trips equal the JAX package's for the same seed; the
circuit breaker, retries, failover and the supervisor behave as
``tests/test_faults.py`` has them; the ``SchemeRouter``'s argmin, EWMA
update and sticky fallback follow dpf_tpu's rules and its answers equal
dpf_tpu's CPU shares for PRF ids 0-5 in the three constructions; a
dpf_tpu trace replays through the port's harness; and ``bench_load
--dryrun`` makes a record with 0 gate rejections.
"""

import json
import time

import numpy as np
import pytest
import torch

import dpf_tpu
from dpf_tpu.serve import faults as jfaults
from dpf_tpu.serve import loadgen as jloadgen
from dpf_tpu.utils.config import EvalConfig as JEvalConfig
from dpf_tpu_torch.core.expand import DeadlineExceeded
from dpf_tpu_torch.serve import (CircuitBreaker, EngineDead, FaultPlan,
                                 FaultSpec, InjectedCompileError,
                                 InjectedDispatchError, LoadShed,
                                 RetryPolicy, SchemeRouter, ServingEngine,
                                 submit_with_retry)
from dpf_tpu_torch.serve.bench_load import _slo_stats, main, replay
from dpf_tpu_torch.serve.faults import HostDropped
from dpf_tpu_torch.serve.router import LABELS, RouteDecision
from dpf_tpu_torch.utils.profiling import EngineCounters

N, ENTRY, CAP = 256, 5, 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _table(n=N, entry=ENTRY, seed=5):
    return np.random.default_rng(seed).integers(
        -2 ** 31, 2 ** 31, (n, entry), dtype=np.int64).astype(np.int32)


# ------------------------------------------ seeded decisions == dpf_tpu

class _Fake:
    """A stand-in engine: the injector reads only ``label``."""

    def __init__(self, label):
        self.label = label


def _outcome(call):
    try:
        out = call()
    except Exception as e:                  # the decision is the class
        return type(e).__name__
    return "ok" if out is None else np.asarray(out).tolist()


SPECS = [
    dict(kind="dispatch_error", p=0.35, construction="logn"),
    dict(kind="latency", p=0.5, latency_s=0.0, bucket=8),
    dict(kind="corrupt_shares", p=0.3, start=3, stop=30, max_fires=4),
    dict(kind="engine_death", construction="radix4", p=0.2, start=5),
    dict(kind="compile_error", p=0.25, start=-1, stop=10),
    dict(kind="host_drop", construction="sqrtn", p=0.1, start=12),
]


@pytest.mark.parametrize("seed", [0, 7, 12345])
def test_fault_decisions_equal_dpf_tpu(seed):
    """A plan written by dpf_tpu loads here and gives the same decision
    at every consult: dispatch, result, warmup and heartbeat points over
    40 arrivals, three constructions and two buckets."""
    jplan = jfaults.FaultPlan([jfaults.FaultSpec(**s) for s in SPECS],
                              seed=seed)
    plan = FaultPlan.from_dict(json.loads(json.dumps(jplan.as_dict())))
    assert plan.as_dict() == jplan.as_dict()
    sides = []
    for p in (plan, jplan):
        inj = p.injector()
        engines = {lb: _Fake(lb) for lb in LABELS}
        seq = []
        for arrival in range(-1, 40):
            inj.begin_arrival(arrival)
            for lb, eng in engines.items():
                for bucket in (4, 8):
                    seq.append(_outcome(lambda: inj.on_dispatch(eng,
                                                                bucket)))
                    seq.append(_outcome(lambda: inj.on_result(
                        eng, bucket, np.arange(3, dtype=np.int32))))
                    seq.append(_outcome(lambda: inj.on_warmup(eng, bucket)))
                seq.append(_outcome(lambda: inj.on_heartbeat(eng)))
        sides.append((seq, inj.stats(), inj.corruptions))
    assert sides[0] == sides[1]
    assert sum(sides[0][1]["injected"].values()) > 10


@pytest.mark.parametrize("seed", [0, 3, 99])
def test_retry_backoffs_equal_dpf_tpu(seed):
    kw = dict(max_attempts=5, backoff_s=0.01, backoff_mult=1.5,
              jitter=0.7, seed=seed)
    ours, theirs = RetryPolicy(**kw), jfaults.RetryPolicy(**kw)
    assert ([ours.backoff(k) for k in range(1, 8)]
            == [theirs.backoff(k) for k in range(1, 8)])
    assert not ours.retryable(LoadShed("full"))
    assert not ours.retryable(DeadlineExceeded("late"))
    assert ours.retryable(InjectedDispatchError("flaky"))
    with pytest.raises(ValueError):
        RetryPolicy(max_attempts=0)
    stats, calls = EngineCounters(), []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise InjectedDispatchError("boom")
        return "ok"
    fast = RetryPolicy(max_attempts=4, backoff_s=0.0)
    assert submit_with_retry(flaky, fast, stats=stats) == "ok"
    assert stats.retries == 2
    with pytest.raises(InjectedDispatchError):
        submit_with_retry(lambda: (_ for _ in ()).throw(
            InjectedDispatchError("x")), RetryPolicy(max_attempts=2,
                                                     backoff_s=0.0))


def test_fault_spec_matching_and_breaker():
    with pytest.raises(ValueError):
        FaultSpec(kind="nope")
    s = FaultSpec(kind="dispatch_error", construction="logn", bucket=8,
                  start=2, stop=5)
    assert s.matches("logn", 8, 4) and not s.matches("logn", 8, 5)
    assert not s.matches("radix4", 8, 3) and not s.matches("logn", 4, 3)
    opened = []
    br = CircuitBreaker(failures=2, reset_s=0.05,
                        on_open=lambda b: opened.append(1))
    br.record_failure()
    assert br.available()
    br.record_failure()
    assert br.state == "open" and opened == [1]
    assert not br.should_probe()
    time.sleep(0.06)
    assert br.should_probe() and br.state == "half_open"
    br.record_failure()
    assert br.state == "open" and br.opens == 2
    time.sleep(0.06)
    assert br.should_probe()
    br.record_success()
    assert [s for _, s in br.transitions] == [
        "closed", "open", "half_open", "open", "half_open", "closed"]
    json.dumps(br.as_dict())


def test_engine_injection_points():
    """Corruption at resolution, a poisoned engine object (not server),
    an injected dispatch error unwinding cleanly, and a warmup fault."""
    d = dpf_tpu_torch_server()
    keys = d.gen_batch(list(range(8)), N)[0]
    ref = d.eval_gpu(keys[:3]).numpy()
    inj = FaultPlan([FaultSpec(kind="corrupt_shares", p=1.0,
                               max_fires=1)]).injector()
    eng = ServingEngine(d, buckets=(4, 8), label="logn", injector=inj)
    inj.begin_arrival(0)
    bad = eng.submit(keys[:3]).result()
    assert not np.array_equal(bad, ref) and bad.shape == ref.shape
    assert inj.corruptions == [("logn", 0)]
    assert np.array_equal(eng.submit(keys[:3]).result(), ref)
    inj = FaultPlan([FaultSpec(kind="engine_death", p=1.0)]).injector()
    eng = ServingEngine(d, buckets=(4, 8), label="logn", injector=inj)
    inj.begin_arrival(0)
    for _ in range(2):
        with pytest.raises(EngineDead):
            eng.submit(keys[:2])
    fresh = ServingEngine(d, buckets=(4, 8), label="logn", injector=inj)
    assert np.array_equal(fresh.submit(keys[:3]).result(), ref)
    inj = FaultPlan([FaultSpec(kind="dispatch_error", p=1.0, start=0,
                               bucket=8)]).injector()
    eng = ServingEngine(d, buckets=(4, 8), max_in_flight=4, label="logn",
                        injector=inj)
    inj.begin_arrival(0)
    with pytest.raises(InjectedDispatchError):
        eng.submit(keys[:3].repeat(4, 1)[:12])     # parts of 8, then 4
    assert eng.in_flight == 0 and eng.stats.batches_submitted == 0
    inj = FaultPlan([FaultSpec(kind="compile_error", start=-1)]).injector()
    with pytest.raises(InjectedCompileError):
        ServingEngine(d, buckets=(4,), injector=inj, warmup=True)
    inj = FaultPlan([FaultSpec(kind="host_drop", p=1.0)]).injector()
    inj.begin_arrival(0)
    with pytest.raises(HostDropped):
        inj.on_heartbeat(eng)


def dpf_tpu_torch_server(prf=0):
    from dpf_tpu_torch import DPF
    d = DPF(prf=prf, device="cpu")
    d.eval_init(_table())
    return d


# ------------------------------------------------------------- router

@pytest.fixture(scope="module")
def router():
    return SchemeRouter(_table(), prf=0, cap=CAP, buckets=(4, 8),
                        probe=True, device="cpu")


def _pools(r, m=6):
    out = {}
    for lb in r.constructions:
        srv = r.server(lb)
        keys = srv.gen_batch([(i * 31) % N for i in range(m)], N,
                             seeds=[b"rp-%s-%d" % (lb.encode(), i)
                                    for i in range(m)])[0]
        out[lb] = (keys, srv.eval_cpu(keys).numpy())
    return out


def test_router_argmin_ewma_and_sticky(router):
    for lb in LABELS:
        for bk in (4, 8):
            assert router.cost(lb, bk) is not None
    assert router.route(CAP).routed_from == "cost-model"
    orig = dict(router._costs)
    try:
        for i, lb in enumerate(LABELS):
            router._costs[(lb, 8)] = 0.010 + i * 0.010
        router._costs[("radix4", 8)] = 0.001
        dec = router.route(8)
        assert (dec.construction, dec.routed_from) == ("radix4",
                                                       "cost-model")
        before = router.cost("logn", 4)
        router._observe("logn", 4, 2 * before)
        assert router.cost("logn", 4) == pytest.approx(
            router.ewma_alpha * 2 * before
            + (1 - router.ewma_alpha) * before)
        assert router.seed_costs({"sqrtn@8": 0.5, ("radix4", 4): 0.25,
                                  "nope@4": 1.0}) == 2
        assert router.cost_table()["sqrtn@8"] == 0.5
    finally:
        router._costs = orig
    cold = SchemeRouter(_table(), prf=0, cap=CAP, buckets=(8,),
                        probe=False, warmup=False, device="cpu")
    dec = cold.route(5)
    assert dec.construction == cold.sticky == "logn"
    assert dec.routed_from == cold.routed_from == "heuristic"
    assert cold.stats()["routed_from_counts"] == {"heuristic": 1}
    with pytest.raises(ValueError, match="unknown construction"):
        SchemeRouter(_table(), constructions=("logn", "r5"), device="cpu")
    with pytest.raises(ValueError, match="ewma_alpha"):
        SchemeRouter(_table(), ewma_alpha=0.0, device="cpu")


def test_router_observes_and_explores(router):
    pools = _pools(router)
    dec = router.route(4)
    dec.construction = "logn"
    before = router.cost("logn", 4)
    fut = router.submit(dec, pools["logn"][0][:4])
    assert np.array_equal(fut.result(), pools["logn"][1][:4])
    assert router.cost("logn", 4) != before
    agg = router.counters()
    assert agg.batches_submitted == sum(
        e.stats.batches_submitted for e in router.engines.values())
    router._costs[("logn", 8)] = 99.0
    seen = set()
    for _ in range(router.EXPLORE_EVERY + 1):
        d = router.route(8)
        seen.add((d.construction, d.routed_from))
    assert ("logn", "explore") in seen
    router.submit(RouteDecision("logn", "explore", 8, 8),
                  pools["logn"][0][:6]).result()
    assert router.cost("logn", 8) < 99.0
    router.reset_counters()
    assert sum(router.route_counts.values()) == 0


@pytest.mark.parametrize("prf", range(6))
def test_router_answers_equal_dpf_tpu(prf):
    """Each construction's routed answer equals dpf_tpu's CPU shares,
    and two routers' answers recover the table rows."""
    table = _table()
    ra = SchemeRouter(table, prf=prf, cap=CAP, buckets=(4, 8),
                      probe=False, warmup=False, device="cpu")
    rb = SchemeRouter(table, prf=prf, cap=CAP, buckets=(4, 8),
                      probe=False, warmup=False, device="cpu")
    idx = [7, 0, N - 1, 100, 3]
    for lb in LABELS:
        ka, kb = ra.server(lb).gen_batch(idx, N, seeds=[
            b"rt-%s-%d" % (lb.encode(), i) for i in idx])
        dec = ra.route(len(idx))
        dec.construction = lb
        fa, fb = ra.submit(dec, ka), rb.submit(dec, kb)
        theirs = dpf_tpu.DPF(
            config=JEvalConfig(prf_method=prf,
                               radix=4 if lb == "radix4" else 2),
            scheme="sqrtn" if lb == "sqrtn" else None)
        theirs.eval_init(table)
        want = np.asarray(theirs.eval_cpu([k.numpy() for k in ka]))
        assert np.array_equal(fa.result(), want), lb
        rec = fa.result().view(np.uint32) - fb.result().view(np.uint32)
        assert (rec.view(np.int32) == table[idx]).all(), lb


def test_router_retry_failover_and_rebuild():
    table = _table()
    inj = FaultPlan([FaultSpec(kind="dispatch_error", p=1.0,
                               max_fires=2)], seed=7).injector()
    r = SchemeRouter(table, prf=0, cap=CAP, buckets=(4, 8), probe=True,
                     injector=inj, device="cpu",
                     retry=RetryPolicy(max_attempts=4, backoff_s=0.0))
    pools = _pools(r)
    inj.begin_arrival(0)
    fut = r.submit_resilient(3, lambda lb: pools[lb][0][:3])
    assert np.array_equal(fut.result(),
                          pools[fut.decision.construction][1][:3])
    assert r.recovery.retries == 2 and r.counters().retries == 2

    inj = FaultPlan([FaultSpec(kind="engine_death", construction="logn",
                               p=1.0)], seed=3).injector()
    r = SchemeRouter(table, prf=0, cap=CAP, buckets=(4, 8), probe=True,
                     injector=inj, device="cpu", breaker_failures=1,
                     breaker_reset_s=0.3, supervise=True,
                     retry=RetryPolicy(max_attempts=4, backoff_s=0.0))
    dead = r.engines["logn"]
    inj.begin_arrival(0)
    with pytest.raises(EngineDead):
        r.submit(r.route(2, exclude=("radix4", "sqrtn")),
                 pools["logn"][0][:2])
    assert r.breakers["logn"].state == "open"
    fut = r.submit_resilient(2, lambda lb: pools[lb][0][:2])
    assert fut.decision.construction != "logn"
    assert np.array_equal(fut.result(),
                          pools[fut.decision.construction][1][:2])
    r.supervisor.join(timeout=60)
    assert r.recovery.engine_restarts == 1
    assert r.engines["logn"] is not dead
    time.sleep(0.31)
    deadline = time.monotonic() + 20
    while (r.breakers["logn"].state != "closed"
           and time.monotonic() < deadline):
        r.route(2)
        time.sleep(0.02)
    assert r.breakers["logn"].state == "closed"
    dec = r.route(2, exclude=("radix4", "sqrtn"))
    assert np.array_equal(r.submit(dec, pools["logn"][0][:2]).result(),
                          pools["logn"][1][:2])
    for lb in r.constructions:
        r.breakers[lb].record_failure()
        r.breakers[lb].record_failure()
    assert r.route(2).construction in r.constructions   # degrades
    st = r.stats()
    assert set(st["breakers"]) == set(r.constructions)
    assert "supervisor" in st and "faults" in st
    r.close()
    shed = SchemeRouter(table, prf=0, cap=CAP, buckets=(8,), probe=False,
                        warmup=False, max_queue_depth=1, shed=True,
                        device="cpu")
    keys = _pools(shed)[shed.sticky][0]
    f1 = shed.submit(shed.route(6), keys)
    with pytest.raises(LoadShed):
        shed.submit(shed.route(6), keys)
    assert shed.counters().shed_batches == 1
    f1.result()


# ----------------------------------------------------- load harness

def test_replay_of_a_dpf_tpu_trace():
    """A dpf_tpu trace replays through the port's open-loop loop: sheds
    excluded, every other arrival resolved once, latencies against the
    scheduled times; then through a real engine."""
    trace = jloadgen.bursty_trace(on_rate=60.0, off_rate=5.0, on_s=0.2,
                                  off_s=0.2, duration_s=0.6, cap=8, seed=4)
    assert len(trace) > 5

    class Fut:
        def result(self):
            return None
    calls = []

    def submit(a, j):
        if j == 1:
            raise LoadShed("full")
        calls.append(j)
        return Fut()
    lats, done, makespan, sheds, shed_q = replay(trace, submit, window=2)
    assert sheds == 1 and shed_q == trace[1].batch
    assert len(lats) == len(done) == len(trace) - 1
    assert calls == [j for j in range(len(trace)) if j != 1]
    assert makespan >= trace[-1].t and all(x >= 0 for x in lats)
    s = _slo_stats(lats, slo_s=10.0)
    assert s["p50_ms"] <= s["p95_ms"] <= s["p99_ms"] <= s["max_ms"]
    assert _slo_stats([], 1.0)["p99_ms"] is None
    d = dpf_tpu_torch_server()
    keys = d.gen_batch(list(range(8)), N)[0]
    eng = d.serving_engine(buckets=(4, 8))
    lats, done, _, sheds, _ = replay(
        trace, lambda a, j: eng.submit(keys[:a.batch]))
    assert sheds == 0 and len(done) == len(trace)
    for a, _, fut in done:
        assert np.array_equal(fut.result(), d.eval_gpu(keys[:a.batch]))


def test_bench_load_dryrun_record(tmp_path):
    out = tmp_path / "load.json"
    main(["--dryrun", "--device", "cpu", "--out", str(out)])
    rec = json.loads(out.read_text())
    assert rec["gate_rejections"] == 0 and rec["checked"]
    assert rec["device"] == "cpu"
    for leg in ("sticky", "router"):
        for k in ("qps", "p50_ms", "p99_ms", "deadline_miss_batches"):
            assert k in rec[leg], (leg, k)
    assert "shed_batches" in rec["shed_leg"]
    assert rec["obs"]["flight"] and "swallowed" in rec["obs"]
