"""The port's serving cluster (``parallel/cluster.py``) against
dpf_tpu's, in one process on the CPU.

Granule plans equal dpf_tpu's; granule partials sum to the one-device
share; under the same seeded ``FaultPlan`` (a ``host_drop`` at a fixed
arrival) the port's ``ClusterRouter`` and dpf_tpu's take the same
recovery decision, end with the same assignment and host states, and
answer every arrival with the same shares (dpf_tpu's ``eval_cpu``);
the hot standby, heartbeat, breaker-free degrade refusal, counters,
metrics and flight chain behave as ``tests/test_cluster.py`` has them;
a paged host under a byte budget serves exactly; the batch-PIR router
equals dpf_tpu's; the ``bench_multihost`` state machine runs.
"""

import numpy as np
import pytest
import torch

import dpf_tpu
from dpf_tpu.parallel import cluster as jcluster
from dpf_tpu.serve import faults as jfaults
from dpf_tpu_torch.core import expand, keygen
from dpf_tpu_torch.obs.flight import FLIGHT, flight_dump
from dpf_tpu_torch.parallel.cluster import (ClusterPIRRouter, ClusterRouter,
                                            ClusterShardServer,
                                            ClusterUnavailable,
                                            HostUnreachable, granule_rows,
                                            make_plan, reshard_plan)
from dpf_tpu_torch.serve.faults import FaultPlan, FaultSpec

N, E = 256, 5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _no_tuning_cache(monkeypatch):
    monkeypatch.setenv("DPF_TPU_TORCH_TUNE_CACHE", "0")


def _setup(n=N, entry=E, prf=0):
    jd = dpf_tpu.DPF(prf=prf)
    table = np.random.default_rng(7).integers(
        -2 ** 31, 2 ** 31, (n, entry), dtype=np.int64).astype(np.int32)
    jd.eval_init(table)
    keys = [np.asarray(jd.gen((i * 41) % n, n, seed=b"cluster-%d" % i)[0])
            for i in range(12)]
    return jd, table, keys


def _batch(keys, b, j=0):
    return [keys[(j + i) % len(keys)] for i in range(b)]


# ------------------------------------------------------------- planning

@pytest.mark.parametrize("n,hosts", [(256, 4), (16, 1), (1024, 8),
                                     (256, 3), (256, 512)])
def test_plan_math_equals_dpf_tpu(n, hosts):
    def both(fn, *a):
        out = []
        for f in (getattr(jcluster, fn), globals()[fn]):
            try:
                out.append(f(*a))
            except ValueError:
                out.append(ValueError)
        return out
    j, p = both("granule_rows", n, hosts)
    assert j == p
    j, p = both("make_plan", n, hosts)
    assert j == p
    lost = tuple(range(0, n, max(1, n // 4)))[:3]
    assert reshard_plan(lost, ["host1", "host2"]) == \
        jcluster.reshard_plan(lost, ["host1", "host2"])
    with pytest.raises(ValueError):
        reshard_plan((0,), [])


def test_shard_partials_sum_to_the_share_and_granule_management():
    jd, table, keys = _setup()
    perm = expand.permute_table(table)
    pk = keygen.decode_keys_batched(_batch(keys, 4))
    out = np.zeros((4, E), np.int32)
    for row0 in range(0, N, 64):
        srv = ClusterShardServer(perm, (row0,), 64, prf_method=0,
                                 device="cpu")
        with np.errstate(over="ignore"):
            out += srv._dispatch_packed(pk).numpy()
    np.testing.assert_array_equal(out, np.asarray(jd.eval_cpu(
        _batch(keys, 4))))
    srv = ClusterShardServer(perm[:128], (0,), 32, prf_method=0,
                             device="cpu")
    srv.add_granules((64, 0))
    assert srv.granules == (0, 64)
    srv.set_granules((96,))
    assert srv.granules == (96,)
    with pytest.raises(ValueError):
        srv.add_granules((7,))
    srv.set_granules(())
    with pytest.raises(RuntimeError):
        srv._dispatch_packed(None)


# ------------------------------------------- recovery against dpf_tpu's

def _drop(policy, hosts=4, at=2, arrivals=6):
    """Both packages' clusters under the same host_drop plan; every
    arrival's shares equal dpf_tpu's oracle."""
    jd, table, keys = _setup()
    victim = "host%d" % (hosts - 1)
    spec = dict(kind="host_drop", construction=victim, start=at)
    inj = FaultPlan([FaultSpec(**spec)], seed=3).injector()
    jinj = jfaults.FaultPlan([jfaults.FaultSpec(**spec)], seed=3).injector()
    c = ClusterRouter.local(table, hosts=hosts, prf_method=0,
                            buckets=(4, 8), injector=inj, policy=policy,
                            breaker_reset_s=60.0, device="cpu")
    jc = jcluster.ClusterRouter.local(table, hosts=hosts, oracle=jd,
                                      buckets=(4, 8), injector=jinj,
                                      policy=policy, breaker_reset_s=60.0)
    try:
        for j in range(arrivals):
            batch = _batch(keys, 4, j)
            want = np.asarray(jd.eval_cpu(batch))
            for router, injector in ((c, inj), (jc, jinj)):
                injector.begin_arrival(j)
                out = router.submit_resilient(batch).result()
                np.testing.assert_array_equal(out, want, err_msg=str(j))
        for k in ("hosts", "assignment", "down", "decision_counts",
                  "spare_granules"):
            assert c.stats()[k] == jc.stats()[k], k
        return c, victim
    finally:
        c.close()
        jc.close()


def test_host_drop_reshard_equals_dpf_tpu():
    c, victim = _drop("reshard")
    assert c.decision_counts == {"reshard": 1, "degrade": 0}
    assert c.spare is None and c.host_state(victim) == "down"
    moved = [g for lb, g in c.assignment.items() if lb != victim]
    assert sorted(sum(moved, ())) == list(range(0, N, 64))
    assert c.recovery.engine_restarts == 1


def test_host_drop_degrade_equals_dpf_tpu():
    seq0 = FLIGHT.recorded
    c, victim = _drop("degrade")
    assert c.decision_counts == {"reshard": 0, "degrade": 1}
    assert c.assignment["spare"] == (192,) and c.host_state("spare") == \
        "live"
    assert c.recovery.failovers == 1
    agg = c.counters()
    assert agg.failovers == 1 and agg.batches_submitted > 0
    evs = [e for e in flight_dump() if e["seq"] > seq0]
    drop = next(e for e in evs if e["kind"] == "host_drop")
    rec = next(e for e in evs if e["kind"] == "cluster_recovery")
    assert drop["host"] == victim == rec["host"]
    assert rec["decision"] == "degrade" and rec["granules"] == [192]
    assert drop["seq"] < rec["seq"] and "scatter" in [e["kind"]
                                                      for e in evs]


def test_hot_standby_heartbeat_and_unavailable():
    jd, table, keys = _setup()
    batch = _batch(keys, 4)
    want = np.asarray(jd.eval_cpu(batch))
    c = ClusterRouter.local(table, hosts=4, prf_method=0, buckets=(4, 8),
                            policy="degrade", standby=True, device="cpu")
    try:
        assert c.spare.granules == (0,) and "spare" not in c.assignment
        np.testing.assert_array_equal(c.submit(batch).result(), want)
        c._handle_drop("host2", RuntimeError("synthetic loss"))
        assert c.spare.granules == (128,) == c.assignment["spare"]
        np.testing.assert_array_equal(c.submit(batch).result(), want)
    finally:
        c.close()
    spec = dict(kind="host_drop", construction="host1", start=1)
    inj = FaultPlan([FaultSpec(**spec)], seed=3).injector()
    c = ClusterRouter.local(table, hosts=2, prf_method=0, buckets=(4, 8),
                            injector=inj, policy="auto", device="cpu")
    inj.begin_arrival(1)
    assert c.check_hosts() == {"host0": "live", "host1": "down"}
    assert c.decision_counts["reshard"] == 1
    np.testing.assert_array_equal(c.submit(batch).result(), want)
    c = ClusterRouter.local(table[:128], hosts=2, prf_method=0,
                            buckets=(4,), policy="degrade", device="cpu")
    c._table_perm = None
    with pytest.raises(ClusterUnavailable):
        c._handle_drop("host0", HostUnreachable("synthetic"))
    evs = [e for e in flight_dump() if e["kind"] == "cluster_recovery"
           and e["host"] == "host0"]
    assert evs and evs[-1]["ok"] is False


def test_cluster_metrics_with_process_labels():
    from dpf_tpu_torch.obs.metrics import REGISTRY
    c, victim = _drop("reshard", hosts=2, arrivals=3)
    text = REGISTRY.openmetrics()
    assert "dpf_cluster_host_state" in text
    assert 'host="%s"' % victim in text and 'process="' in text
    assert "dpf_cluster_recoveries" in text


def test_paged_hosts_serve_exactly_under_a_budget():
    """Every host paged with room for one granule of its two after a
    reshard: answers stay exact while granules page in and out."""
    jd, table, keys = _setup()
    c = ClusterRouter.local(table, hosts=4, prf_method=0, buckets=(4,),
                            policy="reshard", device="cpu",
                            host_budget_bytes=64 * E * 4)
    try:
        for j in range(3):
            batch = _batch(keys, 4, j)
            np.testing.assert_array_equal(c.submit(batch).result(),
                                          np.asarray(jd.eval_cpu(batch)))
            if j == 0:
                c._handle_drop("host3", HostUnreachable("synthetic"))
        stores = [n.server.store for n in c.hosts.values()]
        assert all(s is not None for s in stores)
        assert sum(s.counters["misses"] for s in stores) >= 5
        assert max(s.resident_bytes for s in stores) <= 64 * E * 4
    finally:
        c.close()


# ------------------------------------------------------ batch-PIR routing

def test_pir_group_routing_equals_dpf_tpu():
    from dpf_tpu.apps.batch_pir import (PrivateLookupClient,
                                        PrivateLookupServer)
    from dpf_tpu.parallel.cluster import ClusterPIRRouter as JPIR
    rng = np.random.default_rng(0)
    table = rng.integers(0, 2 ** 31, size=(1024, 5), dtype=np.int32)
    universe = rng.permutation(1024)
    bins, off = [], 0
    for sz in (150, 130, 60, 50, 20):
        bins.append(universe[off:off + sz].tolist())
        off += sz
    routed = ClusterPIRRouter(table, bins, hosts=3, prf=0, device="cpu")
    bcast = ClusterPIRRouter(table, bins, hosts=3, prf=0, routed=False,
                             device="cpu")
    jrouted = JPIR(table, bins, hosts=3, prf=0)
    client = PrivateLookupClient(
        bins, PrivateLookupServer(table, bins, prf=0).bin_sizes, prf=0)
    ka, _, _ = client.make_queries([b[len(b) // 2] for b in bins])
    want = jrouted.answer(ka)
    np.testing.assert_array_equal(routed.answer(ka), want)
    np.testing.assert_array_equal(bcast.answer(ka), want)
    assert routed.stats()["owners"] == jrouted.stats()["owners"]
    assert routed.dispatch_counts == jrouted.dispatch_counts
    assert sum(routed.dispatch_counts.values()) < \
        sum(bcast.dispatch_counts.values())
    with pytest.raises(ValueError, match="auto"):
        ClusterPIRRouter(table, bins, scheme="auto", device="cpu")


# ------------------------------------------------------ the chaos bench

def test_multihost_bench_simulated_state_machine():
    """The bench's legs in one process at a tiny size: no gate escape,
    each chaos leg attributed to its decision, the PIR leg checked.
    (Its availability is a time within the SLO: not a CPU claim.)"""
    from dpf_tpu_torch.serve.bench_multihost import multihost_bench
    rec = multihost_bench(n=128, entry_size=4, cap=8, prf=0, hosts=2,
                          mode="simulated", duration_s=0.6, on_rate=15.0,
                          distinct=4, breaker_reset_s=0.2, quiet=True,
                          slo_ms=60000.0, device="cpu")
    assert rec["gate_escapes"] == 0 and rec["device"] == "cpu"
    assert rec["pir_group_routing"]["checked"]
    for leg, decision in (("chaos_degrade_leg", "degrade"),
                          ("chaos_reshard_leg", "reshard")):
        assert rec[leg]["drop_attributed"]
        assert rec[leg]["decision_counts"][decision] == 1
        assert rec[leg]["failed_batches"] == 0
    assert rec["checked"]
