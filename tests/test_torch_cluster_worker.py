"""The port's socket tier (``parallel/cluster_net.py`` and
``cluster_worker.py``) on the CPU: one worker process behind a
``RemoteHost``, then two behind a ``ClusterRouter`` losing one.

The worker rebuilds ``make_table``'s table (byte-equal to dpf_tpu's) and
answers with shares equal to dpf_tpu's scalar oracle; a bad op comes
back as an error envelope; a killed worker raises ``HostUnreachable``
and the router degrades with exact answers.  Workers are few: each
costs a process start and a ``torch`` import.
"""

import numpy as np
import pytest

import dpf_tpu
from dpf_tpu.parallel import cluster_net as jcluster_net
from dpf_tpu_torch.core import expand, keygen
from dpf_tpu_torch.obs.flight import FLIGHT, flight_dump
from dpf_tpu_torch.parallel.cluster import ClusterRouter, HostUnreachable
from dpf_tpu_torch.parallel.cluster_net import (make_table, spawn_cluster,
                                                spawn_worker)

N, ENTRY, SEED = 128, 4, 9


def _oracle():
    jd = dpf_tpu.DPF(prf=0)
    jd.eval_init(jcluster_net.make_table(N, ENTRY, SEED))
    return jd


def test_make_table_equals_dpf_tpu():
    for n, e, seed in ((N, ENTRY, SEED), (4096, 16, 0), (64, 3, 123)):
        np.testing.assert_array_equal(make_table(n, e, seed),
                                      jcluster_net.make_table(n, e, seed))


def test_worker_round_trip_envelope_and_kill():
    node = spawn_worker({"label": "host0", "row0s": [0, 64],
                         "granule": 64, "n": N, "entry_size": ENTRY,
                         "table_seed": SEED, "prf_method": 0,
                         "process_index": 0, "buckets": [1, 2, 4],
                         "max_in_flight": 2, "device": "cpu"},
                        timeout_s=120.0)
    try:
        assert node.granules == (0, 64)
        assert (node.n, node.entry_size, node.process_index) == \
            (N, ENTRY, 0)
        jd = _oracle()
        keys = [np.asarray(jd.gen((i * 13) % N, N, seed=b"w-%d" % i)[0])
                for i in range(4)]
        out = node.submit(keygen.decode_keys_batched(keys)).result()
        np.testing.assert_array_equal(out, np.asarray(jd.eval_cpu(keys)))
        assert node.heartbeat()["host"] == "host0"
        stats = node.stats()
        assert stats["counters"]["batches_submitted"] >= 1
        # the worker labels its series with its process index
        assert any('process="0"' in k
                   for fam in stats["obs"]["metrics"].values()
                   for k in fam["series"])
        assert node.counters().batches_submitted >= 1
        with pytest.raises(RuntimeError):
            node._call({"op": "no-such-op"})
        assert node.heartbeat()["host"] == "host0"
        node.proc.kill()
        node.proc.wait()
        with pytest.raises(HostUnreachable):
            for _ in range(3):     # a first call may still fill a buffer
                node.heartbeat()
    finally:
        node.kill()


def test_two_worker_cluster_degrades_after_a_kill():
    seq0 = FLIGHT.recorded
    nodes = spawn_cluster(N, ENTRY, 2, table_seed=SEED, prf_method=0,
                          buckets=(1, 2, 4), timeout_s=120.0, device="cpu")
    jd = _oracle()
    keys = [np.asarray(jd.gen((i * 7) % N, N, seed=b"2p-%d" % i)[0])
            for i in range(4)]
    ref = np.asarray(jd.eval_cpu(keys))
    c = ClusterRouter(nodes, granule=N // 2,
                      table_perm=expand.permute_table(
                          make_table(N, ENTRY, SEED)),
                      policy="degrade", prf_method=0,
                      spare_engine_kw={"buckets": (1, 2, 4)}, device="cpu")
    try:
        np.testing.assert_array_equal(c.submit_resilient(keys).result(),
                                      ref)
        nodes[1].kill()                  # a real process death
        np.testing.assert_array_equal(c.submit_resilient(keys).result(),
                                      ref)
        assert c.host_state("host1") == "down"
        assert c.decision_counts["degrade"] == 1
        evs = [e for e in flight_dump() if e["seq"] > seq0]
        assert any(e["kind"] == "host_drop" and e["host"] == "host1"
                   for e in evs)
        assert any(e["kind"] == "cluster_recovery" and e["host"] == "host1"
                   and e["decision"] == "degrade" and e["ok"] for e in evs)
    finally:
        c.close()
        for node in nodes:
            node.kill()
