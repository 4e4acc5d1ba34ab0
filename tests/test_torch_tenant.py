"""The port's multi-tenant router (``serve/tenant.py``) on the CPU.

Each behaviour ``tests/test_tenant.py`` gives ``dpf_tpu``'s tenant tier
holds for the port's: spec validation, shared bucket ladders for
colliding shapes (and nothing else shared), answers equal to the CPU
oracle, re-promotion of a demoted table through the dispatch path, DRR
quota clipping with a small tenant never waiting behind a backlog,
FIFO pumping from a queued future, tenant-local admission shedding,
injected faults kept inside their tenant, a stalled tenant never
blocking another, and tenant-labelled flight events and metrics.  The
tenants' answers also equal ``dpf_tpu``'s ``eval_cpu`` of the same
keys, and concurrent submitters under budget churn leave the counters,
quotas and pins consistent.  Every check is on a deterministic
result: shares, counters and flight events, no latency.
"""

import threading

import numpy as np
import pytest
import torch

from dpf_tpu.serve.router import build_servers as jbuild_servers
from dpf_tpu_torch.obs.flight import FLIGHT
from dpf_tpu_torch.obs.metrics import MetricsRegistry, register_tenants
from dpf_tpu_torch.serve import EngineClosed
from dpf_tpu_torch.serve.bench_load import _batch_for, _key_pool
from dpf_tpu_torch.serve.engine import LoadShed
from dpf_tpu_torch.serve.faults import FaultPlan, FaultSpec, RetryPolicy
from dpf_tpu_torch.serve.registry import TableRegistry
from dpf_tpu_torch.serve.router import LABELS
from dpf_tpu_torch.serve.tenant import TenantRouter, TenantSpec

N, ENTRY, CAP = 256, 4, 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _table(n=N, entry=ENTRY, seed=11):
    return np.random.default_rng(seed).integers(
        0, 2 ** 31, (n, entry), dtype=np.int32)


def _mk(**reg_kw):
    # one construction keeps each tenant cheap; the scheduler and the
    # isolation machinery do not depend on the construction
    reg_kw.setdefault("labels", ("logn",))
    return TenantRouter(TableRegistry(device="cpu", **reg_kw))


def _spec(name, **kw):
    kw.setdefault("table", _table(seed=sum(name.encode())))
    kw.setdefault("cap", CAP)
    kw.setdefault("probe", False)
    return TenantSpec(name, **kw)


def _pool(tr, name, n=N, distinct=4):
    r = tr.router(name)
    return {lb: _key_pool(r.server(lb), n, distinct,
                          b"tn-%s-%s" % (name.encode(), lb.encode()))
            for lb in r.constructions}


def _submit_checked(tr, name, pool, j=0, b=2, arrival=None,
                    keys_for=None):
    """Submit one batch; returns (future, check) where check() asserts
    the answer equals the oracle's rows."""
    def default_keys_for(lb, _j=j, _b=b):
        return _batch_for(pool[lb], _j, _b)[0]
    fut = tr.submit(name, b, keys_for or default_keys_for,
                    arrival=arrival)

    def check():
        got = fut.result()
        lb = fut.decision.construction
        _, idxs = _batch_for(pool[lb], j, b)
        assert np.array_equal(got, pool[lb][1][idxs])
    return fut, check


# ----------------------------------------------- specs + shared state

def test_spec_validation_and_duplicate_tenant():
    with pytest.raises(ValueError):
        TenantSpec("w", weight=0.0)
    with pytest.raises(ValueError):
        TenantSpec("q", max_in_flight=0)
    tr = _mk()
    tr.add_tenant(_spec("a"))
    with pytest.raises(ValueError):
        tr.add_tenant(_spec("a"))
    tr.close()
    with pytest.raises(EngineClosed):
        tr.submit("a", 1, lambda lb: None)


def test_colliding_shapes_share_one_ladder_but_not_breakers():
    tr = _mk()
    tr.add_tenant(_spec("a"))
    tr.add_tenant(_spec("b", table=None, table_name="a"))
    tr.add_tenant(_spec("c", table=_table(n=512, seed=3)))
    assert tr.router("a").buckets is tr.router("b").buckets
    assert tr.router("a").buckets is not tr.router("c").buckets
    assert tr.router("a").buckets.sizes == (1, 2, 4, 8)
    # the table-sharing tenant serves the SAME prepared servers
    assert tr.router("a").server("logn") is tr.router("b").server("logn")
    # isolation state is never shared
    assert tr.router("a").breakers is not tr.router("b").breakers
    assert tr.router("a").tenant == "a"
    assert tr.router("b").tenant == "b"


# ------------------------------------------------------- correctness

def test_submit_resolves_against_the_oracle():
    tr = _mk()
    tr.add_tenant(_spec("a"))
    pool = _pool(tr, "a")
    for j in range(3):
        fut, check = _submit_checked(tr, "a", pool, j=j)
        check()
        assert fut.done()
    st = tr.stats()["tenants"]["a"]
    assert st["submitted"] == 3 and st["dispatched"] == 3
    assert st["errors"] == 0 and st["in_flight"] == 0
    # every lease was released once its batch resolved
    assert tr.registry.stats()["tables"][0]["pins"] == 0


def test_tenant_answers_equal_dpf_tpu_eval_cpu():
    """Two tenants over one three-construction table: every routed
    answer equals ``dpf_tpu``'s ``eval_cpu`` of the same keys."""
    table = _table(seed=21)
    tr = _mk(labels=LABELS, prf_method=3)
    tr.add_tenant(_spec("a", table=table))
    tr.add_tenant(_spec("b", table=None, table_name="a"))
    jservers = jbuild_servers(table, LABELS, prf_method=3)
    pool = _pool(tr, "a")
    for lb, (keys, refs) in pool.items():
        want = np.asarray(jservers[lb].eval_cpu(
            [np.asarray(k) for k in keys.numpy()]))
        assert np.array_equal(refs, want), lb
    futs = [_submit_checked(tr, name, pool, j=j, b=3)
            for j, name in enumerate("abab")]
    for _, check in futs:
        check()
    tr.close()


def test_dispatch_repromotes_demoted_table_bit_identical():
    tr = _mk()
    tr.add_tenant(_spec("a"))
    pool = _pool(tr, "a")
    _, check = _submit_checked(tr, "a", pool)
    check()
    # demote the tenant's table; the next dispatch pins + re-promotes
    assert tr.registry.demote("a") is True
    assert not tr.registry.stats()["tables"][0]["resident"]
    assert tr.router("a").server("logn").table_device is None
    _, check = _submit_checked(tr, "a", pool, j=1)
    check()
    assert tr.registry.counters["promotions"] == 1
    assert tr.registry.counters["misses"] == 1


# ----------------------------------------------------- DRR scheduling

def test_quota_clips_backlog_and_small_tenant_never_waits():
    tr = _mk()
    tr.add_tenant(_spec("big", max_in_flight=1))
    tr.add_tenant(_spec("small", table=_table(n=512, seed=5)))
    bp, sp = _pool(tr, "big"), _pool(tr, "small", n=512)
    big = [_submit_checked(tr, "big", bp, j=j) for j in range(4)]
    tb = tr.tenants["big"]
    # quota: exactly one dispatched, the rest is queued backlog
    assert tb.in_flight == 1 and len(tb.queue) == 3
    assert tb.quota_defers >= 1
    # the small tenant's batch is granted at once despite the backlog
    sf, scheck = _submit_checked(tr, "small", sp)
    ts = tr.tenants["small"]
    assert ts.in_flight == 1 and len(ts.queue) == 0
    scheck()
    # resolving frees quota: the backlog drains FIFO and correct
    for _, check in big:
        check()
    assert tb.dispatched == 4 and len(tb.queue) == 0
    assert tb.deficit == 0.0          # no banked credit while idle


def test_result_on_queued_future_pumps_fifo():
    tr = _mk()
    tr.add_tenant(_spec("a", max_in_flight=1))
    pool = _pool(tr, "a")
    futs = [_submit_checked(tr, "a", pool, j=j) for j in range(3)]
    # waiting on the LAST future first drains the tenant's older
    # in-flight batches (FIFO within a tenant), no deadlock
    futs[-1][1]()
    assert all(f.done() for f, _ in futs)
    for _, check in futs:
        check()


# -------------------------------------------------------- isolation

def test_tenant_admission_shed_is_local():
    tr = _mk()
    tr.add_tenant(_spec("v", max_in_flight=1, max_queue_depth=1,
                        shed=True))
    tr.add_tenant(_spec("q", table=_table(n=512, seed=6)))
    vp, qp = _pool(tr, "v"), _pool(tr, "q", n=512)
    f1, c1 = _submit_checked(tr, "v", vp)
    # depth (queue + in flight) at the cap: the tenant's OWN admission
    # rejects, and only its counters move
    with pytest.raises(LoadShed):
        _submit_checked(tr, "v", vp, j=1)
    assert tr.tenants["v"].shed_batches == 1
    _, cq = _submit_checked(tr, "q", qp)
    cq()
    assert tr.tenants["q"].shed_batches == 0
    c1()
    # quota freed: the shed tenant admits again
    _, c3 = _submit_checked(tr, "v", vp, j=2)
    c3()


def test_injected_faults_stay_inside_their_tenant():
    tr = _mk()
    plan = FaultPlan([FaultSpec("dispatch_error", p=1.0, start=0,
                                stop=1)], seed=9)
    tr.add_tenant(_spec(
        "v", plan=plan,
        retry=RetryPolicy(max_attempts=2, backoff_s=0.0, seed=9),
        breaker_failures=100, breaker_reset_s=30.0))
    tr.add_tenant(_spec("q", table=_table(n=512, seed=8)))
    vp, qp = _pool(tr, "v"), _pool(tr, "q", n=512)
    # every construction injected at p=1.0: retry + failover exhaust
    # and the error surfaces on the victim's future only
    fut, _ = _submit_checked(tr, "v", vp, arrival=0)
    with pytest.raises(Exception):
        fut.result()
    assert tr.tenants["v"].errors == 1
    assert tr.registry.stats()["tables"][0]["pins"] == 0
    # the quiet tenant is untouched: correct answer, clean counters
    _, cq = _submit_checked(tr, "q", qp)
    cq()
    assert tr.tenants["q"].errors == 0
    assert tr.tenants["q"].shed_batches == 0
    # outside the injector's arrival window the victim recovers
    _, cv = _submit_checked(tr, "v", vp, j=1, arrival=1)
    cv()


def test_stalled_tenant_dispatch_never_blocks_others():
    """The slow tenant's worker is held inside ITS dispatch (its key
    source blocks until released); the fast tenant's submit, dispatch
    and result complete meanwhile, and the stalled batch answers
    correctly once released."""
    tr = _mk()
    tr.add_tenant(_spec("slow"))
    tr.add_tenant(_spec("fast", table=_table(n=512, seed=7)))
    sp, fp = _pool(tr, "slow"), _pool(tr, "fast", n=512)
    entered, release = threading.Event(), threading.Event()

    def stalled_keys(lb):
        entered.set()
        assert release.wait(timeout=60)
        return _batch_for(sp[lb], 0, 2)[0]
    slow_fut, slow_check = _submit_checked(tr, "slow", sp,
                                           keys_for=stalled_keys)
    assert entered.wait(timeout=60)   # the slow worker is stalled now
    for j in range(3):
        fut, fcheck = _submit_checked(tr, "fast", fp, j=j)
        fcheck()
        assert fut.done()
    assert not slow_fut.done()
    release.set()
    slow_check()
    assert slow_fut.done()


# ----------------------------------------------------- observability

def test_tenant_labels_in_flight_and_metrics():
    FLIGHT.clear()
    tr = _mk()
    tr.add_tenant(_spec("lbl"))
    pool = _pool(tr, "lbl")
    _, check = _submit_checked(tr, "lbl", pool)
    check()
    evs = FLIGHT.dump()
    assert any(e.get("kind") == "tenant" and e.get("tenant") == "lbl"
               for e in evs)
    assert any(e.get("kind") == "route" and e.get("tenant") == "lbl"
               for e in evs)
    mr = MetricsRegistry()
    register_tenants(tr, registry=mr)
    snap = mr.snapshot()
    for fam in ("dpf_tenant_weight", "dpf_tenant_submitted",
                "dpf_tenant_in_flight"):
        assert any('tenant="lbl"' in k
                   for k in snap[fam]["series"]), fam
    assert snap["dpf_tenant_dispatched"]["series"][
        '{tenant="lbl"}'] == 1.0
    # the tenant's router and engines registered themselves, labelled
    from dpf_tpu_torch.obs.metrics import REGISTRY
    text = REGISTRY.openmetrics()
    assert 'dpf_router_routes_total{construction="logn",tenant="lbl"} 1' \
        in text
    assert ('dpf_engine_batches_submitted_total{engine="logn",'
            'tenant="lbl"} 1') in text
    # drain is a no-op with nothing outstanding
    tr.drain()


def test_concurrent_submitters_keep_counters_and_pins_consistent():
    """More submitting threads than cores, four tenants (two sharing a
    table), a 1 us switch interval: every batch answers correctly, and
    the scheduler's counters, the quotas and the registry's pins add up
    (a lost update would leave one off)."""
    import sys
    tr = _mk(budget_bytes=2 * N * ENTRY * 4)   # three tables, room for two
    tr.add_tenant(_spec("a", max_in_flight=2))
    tr.add_tenant(_spec("b", table=None, table_name="a", max_in_flight=1))
    tr.add_tenant(_spec("c", table=_table(n=512, seed=12)))
    tr.add_tenant(_spec("d", table=_table(seed=13), weight=0.5))
    pools = {"a": _pool(tr, "a"), "c": _pool(tr, "c", n=512),
             "d": _pool(tr, "d")}
    pools["b"] = pools["a"]
    per_thread, threads, failures = 6, [], []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def client(name, k):
            try:
                checks = [_submit_checked(tr, name, pools[name], j=k + j,
                                          b=1 + (k + j) % 3)[1]
                          for j in range(per_thread)]
                for check in checks:
                    check()
            except Exception as e:           # reported by the main thread
                failures.append(e)
        for k in range(3):
            for name in "abcd":
                threads.append(threading.Thread(target=client,
                                                args=(name, 7 * k)))
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    assert failures == []
    tr.drain()
    st = tr.stats()
    for name, t in st["tenants"].items():
        assert t["submitted"] == 3 * per_thread, name
        assert t["dispatched"] == 3 * per_thread, name
        assert t["in_flight"] == 0 and t["queue_depth"] == 0, name
        assert t["errors"] == 0 and t["shed_batches"] == 0, name
    reg = st["registry"]
    assert all(row["pins"] == 0 for row in reg["tables"])
    counters = reg["counters"]
    assert counters["hits"] + counters["misses"] == 4 + 4 * 3 * per_thread
    assert counters["promotions"] == counters["misses"]
    tr.close()
