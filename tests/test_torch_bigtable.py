"""The port's big-table bench (``serve/bench_bigtable.py``) on CPU devices.

``bigtable_bench`` at a small size with ``device="cpu"``: every leg is
checked and no answer escapes the gate (each paged cluster answer and
each prefetch-race answer equals the CPU oracle ``eval_cpu``'s shares),
the paged hosts really page (misses and evictions), the 2D meshes equal
the 1D mesh and the one device.  The SLO is a minute: the plain versions
on a busy CPU are slow, and availability counts answers inside it.  The
planning leg is pure, so its numbers equal dpf_tpu's.  Tolerance 0:
every share is an int32.
"""

import numpy as np
import pytest
import torch

from dpf_tpu.serve import bench_bigtable as jbigtable
from dpf_tpu_torch import DPF
from dpf_tpu_torch.core import expand, keygen
from dpf_tpu_torch.parallel.cluster import ClusterShardServer
from dpf_tpu_torch.serve import bench_bigtable


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def record():
    import os
    old = os.environ.get("DPF_TPU_TORCH_TUNE_CACHE")
    os.environ["DPF_TPU_TORCH_TUNE_CACHE"] = "0"
    try:
        yield bench_bigtable.bigtable_bench(
            n=1024, entry_size=8, cap=16, prf=0, hosts=2, duration_s=1.0,
            rate=16.0, slo_ms=60000.0, distinct=8, device="cpu",
            quiet=True)
    finally:
        if old is None:
            del os.environ["DPF_TPU_TORCH_TUNE_CACHE"]
        else:
            os.environ["DPF_TPU_TORCH_TUNE_CACHE"] = old


def test_bench_is_checked_with_no_escape(record):
    """Every leg's gate holds; of the prefetch race only its exactness
    and its prefetch hits (its p99 verdict is a time on a shared CPU)."""
    assert record["gate_escapes"] == 0
    for leg in ("paged_cluster", "mesh_2d", "plan"):
        assert record[leg]["checked"], leg
    assert record["checked"] == record["prefetch_race"]["checked"]
    assert record["device"] == "cpu"


def test_paged_cluster_leg_pages_and_answers_exactly(record):
    leg = record["paged_cluster"]
    assert leg["checked"] and leg["gate_escapes"] == 0
    assert leg["assignment_exceeds_budget"]
    assert leg["served_ok"] == leg["arrivals"] > 0
    assert leg["failed_batches"] == 0 and leg["memory"] is None
    for st in leg["stores"].values():
        assert st["counters"]["misses"] > 0
        assert st["counters"]["evictions"] > 0
        assert st["resident_bytes"] <= st["budget_bytes"]


def test_prefetch_race_leg(record):
    race = record["prefetch_race"]
    for side in ("prefetch_on", "prefetch_off"):
        assert race[side]["gate_rejections"] == 0
        assert race[side]["arrivals"] == record["trace"]["arrivals"]
    assert race["prefetch_on"]["store"]["counters"]["prefetch_hits"] > 0
    assert (race["prefetch_on"]["prefetcher"]["ticks"]
            == record["trace"]["arrivals"])


def test_mesh_2d_leg(record):
    mesh = record["mesh_2d"]
    assert mesh["checked"] and mesh["parity_1d_vs_single"]
    assert [v["mesh"] for v in mesh["variants"]] == [
        "1x4b2", "1x4b2", "1x2b4", "1x2b4", "2x2b2", "2x2b2"]
    assert all(v["parity_vs_single"] and v["parity_vs_1d"]
               and v["recover_ok"] for v in mesh["variants"])


def test_plan_leg_equals_dpf_tpus():
    mine, ref = bench_bigtable._plan_leg(), jbigtable._plan_leg()
    assert mine == ref
    assert mine["checked"] and mine["memory_floor_binds"]
    assert mine["hosts_memory_floor"] == 15      # 256 GB over 16 GiB


@pytest.mark.parametrize("prf", [0, 2, 3])
def test_paged_host_equals_eval_cpu_under_churn(prf):
    """One host assigned four granules under a budget of one: every
    dispatch leases, evicts and prefetches, and each answer equals the
    unpaged host's and the oracle's partial over the same rows."""
    n, e, g = 512, 4, 128
    table = np.random.default_rng(prf).integers(
        -2 ** 31, 2 ** 31, (n, e), dtype=np.int64).astype(np.int32)
    d = DPF(prf=prf, device="cpu")
    d.eval_init(table)
    keys = d.gen_batch([(i * 97 + 3) % n for i in range(6)], n)[0]
    perm = expand.permute_table(table)
    paged = ClusterShardServer(perm, range(0, n, g), g, prf_method=prf,
                               budget_bytes=g * e * 4, device="cpu")
    whole = ClusterShardServer(perm, range(0, n, g), g, prf_method=prf,
                               device="cpu")
    want = d.eval_cpu(keys).numpy()
    for rep in range(3):
        pk = keygen.decode_keys_batched(keys)
        got = paged._dispatch_packed(pk).numpy()
        assert np.array_equal(got, whole._dispatch_packed(pk).numpy())
        assert np.array_equal(got, want), rep
    st = paged.store.stats()
    assert st["counters"]["misses"] >= 4 and st["counters"]["evictions"] > 0
