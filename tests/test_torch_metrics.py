"""The port's metrics registry (``obs/metrics.py``) against dpf_tpu's.

The same metric state gives the same OpenMetrics text and JSON snapshot
in both packages, for each family the port has: the static counters,
gauges and histograms, and the engine, router, table-registry,
granule-store and tenant exporters; the keygen series; weak collectors
and broken collectors.  The port's serving objects register themselves
(engine, router, registry, tenants) and ``DPF.gen_batch`` counts its
keys; ``record_sections`` embeds the snapshot.
"""

import gc
import json
import warnings
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from dpf_tpu.obs import metrics as jmetrics
from dpf_tpu.serve import registry as jregistry
from dpf_tpu.utils.profiling import EngineCounters as JEngineCounters
from dpf_tpu_torch import DPF
from dpf_tpu_torch.obs import metrics, record_sections
from dpf_tpu_torch.serve import registry
from dpf_tpu_torch.utils.profiling import EngineCounters


def _both():
    return jmetrics.MetricsRegistry(), metrics.MetricsRegistry()


def _same(jreg, reg):
    text = reg.openmetrics()
    assert text == jreg.openmetrics()
    assert reg.snapshot() == jreg.snapshot()
    return text


class _Fake:
    def __init__(self, **kw):
        self.__dict__.update(kw)


def _static_ops(reg):
    c = reg.counter("dpf_x", "help text")
    c.inc()
    c.labels(construction="logn", bucket=16).inc(2)
    c.labels(k='quo"te').inc(3.5)
    g = reg.gauge("dpf_y")
    g.set(1.5)
    g.labels(table="t").set(3)
    g.labels(table="t").inc()
    h = reg.histogram("dpf_lat", "latency", buckets=(0.1, 1.0))
    for v in (0.05, 0.5, 5.0, 1.0):
        h.observe(v)
    h.labels(engine="e").observe(0.2)
    h.observe_counts([1, 0, 2], 7.25, 3)
    reg.histogram("dpf_default_ladder").observe(0.003)


def test_static_families_render_as_dpf_tpu():
    jreg, reg = _both()
    _static_ops(jreg)
    _static_ops(reg)
    text = _same(jreg, reg)
    assert "# HELP dpf_x help text" in text
    assert 'dpf_x_total{bucket="16",construction="logn"} 2' in text
    assert 'dpf_lat_bucket{le="+Inf"} 7' in text
    assert text.endswith("# EOF\n")
    assert metrics.LATENCY_BUCKETS_S == jmetrics.LATENCY_BUCKETS_S


def test_primitive_rules():
    reg = metrics.MetricsRegistry()
    c = reg.counter("req", "requests")
    c.inc()
    c.labels(construction="logn").inc(2)
    assert c.value == 1
    assert c.labels(construction="logn").value == 2
    with pytest.raises(ValueError):
        c.inc(-1)                         # counters only go up
    assert reg.counter("req") is c        # create-or-return by name
    with pytest.raises(ValueError):
        reg.gauge("req")                  # one meaning per name
    with pytest.raises(ValueError):
        reg.histogram("h", buckets=())
    snap = json.loads(json.dumps(reg.snapshot()))
    assert snap["req"]["kind"] == "counter"
    assert metrics.default_registry() is metrics.REGISTRY


def test_weakref_collector_prunes_on_gc():
    reg = metrics.MetricsRegistry()

    class Obj:
        pass
    obj = Obj()
    reg.watch(obj, lambda o: [("dpf_live", "gauge", "", {}, 1.0)])
    assert "dpf_live 1" in reg.openmetrics()
    del obj
    gc.collect()
    assert "dpf_live" not in reg.openmetrics()
    assert reg._collectors == []          # pruned, not just skipped


def test_broken_collector_never_breaks_the_scrape():
    from dpf_tpu_torch.utils.profiling import swallowed_snapshot
    reg = metrics.MetricsRegistry()
    reg.counter("dpf_ok").inc()
    reg.register_collector(lambda: 1 / 0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        text = reg.openmetrics()
    assert "dpf_ok_total 1" in text
    assert "ZeroDivisionError" in str(
        swallowed_snapshot().get("obs.metrics.collector", {}))


def _counters(cls):
    st = cls(batches_submitted=3, queries_submitted=40, dispatches=5,
             padded_queries=7, retries=2, failovers=1,
             pack_time_s=0.25, wait_time_s=1.5)
    st.note_dispatch(padded=3, in_flight=2)
    for v in (0.003, 0.2, 0.02, 11.0):
        st.note_latency(v)
    return st


def test_engine_exporter_renders_as_dpf_tpu():
    jreg, reg = _both()
    jeng = _Fake(label="e1", stats=_counters(JEngineCounters), tenant="t")
    eng = _Fake(label="e1", stats=_counters(EngineCounters), tenant="t")
    jmetrics.register_engine(jeng, jreg)
    metrics.register_engine(eng, reg)
    jmetrics.register_engine(
        _keep(_Fake(label="e2", stats=JEngineCounters())), jreg)
    metrics.register_engine(
        _keep(_Fake(label="e2", stats=EngineCounters())), reg)
    text = _same(jreg, reg)
    assert ('dpf_engine_batches_submitted_total{engine="e1",tenant="t"} 3'
            in text)
    assert ('dpf_engine_latency_seconds_bucket{engine="e1",tenant="t",'
            'le="0.005"} 1') in text
    assert 'dpf_engine_dispatches_total{engine="e2"} 0' in text


def _router(kernel):
    fake = _Fake(
        breakers={"logn": SimpleNamespace(state="open", opens=2),
                  "sqrtn": SimpleNamespace(state="half_open", opens=1)},
        _costs={("logn", 16): 0.001, ("sqrtn", 8): 0.0025},
        route_counts={"logn": 3, "sqrtn": 0},
        routed_from_counts={"cost-model": 3}, tenant="alpha")
    if kernel:
        fake.dispatch_kernel = lambda lb, bucket: "fused"
    return fake


@pytest.mark.parametrize("kernel", [False, True])
def test_router_exporter_renders_as_dpf_tpu(kernel):
    jreg, reg = _both()
    jr, r = _router(kernel), _router(kernel)
    jmetrics.register_router(jr, jreg)
    metrics.register_router(r, reg)
    text = _same(jreg, reg)
    assert ('dpf_breaker_state{construction="logn",tenant="alpha"} 1'
            in text)
    assert ('dpf_router_routed_from_total{source="cost-model",'
            'tenant="alpha"} 3') in text
    assert ('kernel="fused"' in text) == kernel


def _table(n=256, e=4, seed=7):
    return np.random.default_rng(seed).integers(
        0, 2 ** 31, (n, e), dtype=np.int32)


def test_registry_and_granule_exporters_render_as_dpf_tpu():
    one = 256 * 4 * 4
    regs = []
    for mod, kw in ((jregistry, {}), (registry, {"device": "cpu"})):
        tr = mod.TableRegistry(2 * one, labels=("logn",), **kw)
        for seed in (1, 2, 3):
            tr.register("m", _table(seed=seed))
        tr.acquire("m", version=1).release()
        store = tr.granule_store("m", granule=64, budget_bytes=2 * 64 * 16)
        store.lease(0).release()
        store.prefetch()
        regs.append((tr, store))
    jreg, reg = _both()
    jmetrics.register_table_registry(regs[0][0], jreg)
    jmetrics.register_granule_store(regs[0][1], jreg)
    metrics.register_table_registry(regs[1][0], reg)
    metrics.register_granule_store(regs[1][1], reg)
    text = _same(jreg, reg)
    assert "dpf_registry_evictions_total 2" in text
    assert 'dpf_registry_table_resident{table="m",version="1"} 1' in text
    assert 'dpf_registry_granules_resident{store="m@v3"} 2' in text


def _tenants():
    def tenant(weight, queue, in_flight, deficit, submitted):
        return SimpleNamespace(
            spec=SimpleNamespace(weight=weight), queue=[None] * queue,
            in_flight=in_flight, deficit=deficit, submitted=submitted,
            dispatched=submitted - queue, shed_batches=1,
            shed_queries=9, quota_defers=4)
    return _Fake(tenants={"alpha": tenant(1.0, 2, 1, 64.0, 10),
                          "victim": tenant(0.5, 0, 0, 0.0, 3)})


def test_tenant_exporter_renders_as_dpf_tpu():
    jreg, reg = _both()
    jmetrics.register_tenants(_keep(_tenants()), jreg)
    metrics.register_tenants(_keep(_tenants()), reg)
    text = _same(jreg, reg)
    assert 'dpf_tenant_deficit{tenant="alpha"} 64' in text
    assert 'dpf_tenant_quota_defers_total{tenant="victim"} 4' in text


_KEEP = []


def _keep(obj):
    """Hold a strong reference for the test's life (collectors are
    weak)."""
    _KEEP.append(obj)
    return obj


def test_keygen_series_render_as_dpf_tpu():
    jreg, reg = _both()
    for mod, r in ((jmetrics, jreg), (metrics, reg)):
        mod.observe_keygen("logn.r2", 8, 0.004, registry=r)
        mod.observe_keygen("logn.r2", 8, 0.5, registry=r)
        mod.observe_keygen("sqrtn.r2", 3, 0.02, registry=r)
    text = _same(jreg, reg)
    assert 'dpf_keygen_keys_total{batch="8",construction="logn.r2"} 16' \
        in text


@pytest.mark.parametrize("label, kw", [
    ("logn.r2", {}), ("logn.r4", {"radix": 4}),
    ("sqrtn.r2", {"scheme": "sqrtn"})])
def test_gen_batch_observes_keygen(label, kw):
    from dpf_tpu_torch import EvalConfig
    d = DPF(prf=0, config=EvalConfig(prf_method=0, **kw), device="cpu")
    fam = metrics.REGISTRY.counter("dpf_keygen_keys")
    child = fam.labels(construction=label, batch=5)
    before = child.value
    d.gen_batch(list(range(5)), 256)
    assert child.value == before + 5
    assert 'construction="%s"' % label in metrics.REGISTRY.openmetrics()


def test_serving_objects_register_and_record_sections_embed():
    srv = DPF(prf=0, device="cpu")
    srv.eval_init(_table(256, 4))
    eng = srv.serving_engine(max_in_flight=2, buckets=(4,))
    keys = srv.gen_batch([1, 2, 3], 256)[0]
    eng.submit(keys).result()
    from dpf_tpu_torch.serve import SchemeRouter
    router = SchemeRouter(_table(256, 4), prf=0, cap=4, probe=False,
                          constructions=("logn",), device="cpu",
                          tenant="rt")
    reg = registry.TableRegistry(labels=("logn",), device="cpu")
    reg.register("obs", _table(256, 4))
    text = metrics.REGISTRY.openmetrics()
    label = "engine-%x" % id(eng)
    assert 'dpf_engine_queries_submitted_total{engine="%s"} 3' % label \
        in text
    assert ('dpf_breaker_state{construction="logn",tenant="rt"} 0'
            in text)
    assert 'dpf_registry_table_resident{table="obs",version="1"} 1' in text
    assert "dpf_flight_events_total" in text
    assert "dpf_cache_" not in text       # the port has no compile cache
    sections = record_sections()
    assert set(sections) >= {"metrics", "flight", "swallowed"}
    assert "dpf_engine_dispatches" in sections["metrics"]
    json.dumps(sections)
    del router, eng
    assert torch.get_num_threads() >= 1
