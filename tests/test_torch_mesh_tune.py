"""The port's mesh tier of tuning (``tune/mesh_tune.py``, the cluster
tier of ``tune/serve_tune.py``) against dpf_tpu's, on CPU devices.

The mesh-tagged cache keys, ``mesh_tag``, the split and stage
candidates and the heuristic knobs equal dpf_tpu's; ``tune_mesh_eval``
searches with every candidate gated against the scalar oracle, answers
a second call from the cache and ``ShardedDPFServer`` resolves its
knobs from there (explicit > mesh-tuned > single-device tuned >
heuristic); ``tune_mesh_serving`` persists under the serve kind with the
mesh field and an engine over the mesh server reads it back;
``tune_mesh_shape`` races the splits; ``tune_cluster``'s winner is what
``ClusterRouter.local`` runs.  Every test writes its own cache file.
"""

import numpy as np
import pytest
import torch

from dpf_tpu.parallel import sharded as jsharded
from dpf_tpu.tune import fingerprint as jfp
from dpf_tpu.tune import mesh_tune as jmesh_tune
from dpf_tpu.tune import serve_tune as jserve_tune
from dpf_tpu_torch.parallel.sharded import ShardedDPFServer, make_mesh
from dpf_tpu_torch.tune import mesh_tune
from dpf_tpu_torch.tune.fingerprint import cache_key, mesh_tag
from dpf_tpu_torch.utils.hermetic import force_cpu_mesh

CPU = force_cpu_mesh(8)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def tmp_cache(monkeypatch, tmp_path):
    path = str(tmp_path / "tuning.json")
    monkeypatch.setenv("DPF_TPU_TORCH_TUNE_CACHE", path)
    from dpf_tpu_torch.tune.cache import default_cache
    default_cache(refresh=True)
    return path


def _shape_half(key):
    return key.split("|")[2]


def test_mesh_keys_and_tags_equal_dpf_tpu():
    import jax
    for nb, nt, ny in ((2, 4, 1), (8, 1, 1), (1, 2, 2), (2, 2, 1)):
        if ny > 1:
            from dpf_tpu_torch.parallel.sharded import make_mesh_2d
            m = make_mesh_2d(nt, ny, nb, devices=CPU[:nb * nt * ny])
            jm = jsharded.make_mesh_2d(nt, ny, nb,
                                       devices=jax.devices()[:nb * nt * ny])
        else:
            m = make_mesh(nt, nb, devices=CPU[:nb * nt])
            jm = jsharded.make_mesh(nt, nb, devices=jax.devices()[:nb * nt])
        assert mesh_tag(m) == jfp.mesh_tag(jm)
        kw = dict(n=1024, entry_size=16, batch=8, prf_method=0,
                  mesh=mesh_tag(m))
        assert cache_key("mesh", fingerprint="fp", **kw) == \
            jfp.cache_key("mesh", fingerprint="fp", **kw)
    from dpf_tpu_torch.tune.serve_tune import cluster_cache_key
    kw = dict(n=4096, entry_size=16, batch=128, prf_method=3, hosts=4)
    assert _shape_half(cluster_cache_key(**kw)) == \
        _shape_half(jserve_tune.cluster_cache_key(**kw))


@pytest.mark.parametrize("n,batch,n_table,scheme", [
    (2048, 8, 8, "logn"), (1 << 20, 512, 4, "logn"), (4096, 64, 2, "sqrtn"),
    (1 << 20, 512, 4, "sqrtn")])
def test_candidates_and_heuristics_equal_dpf_tpu(n, batch, n_table, scheme):
    assert mesh_tune.mesh_split_candidates(8) == \
        jmesh_tune.mesh_split_candidates(8)
    assert mesh_tune.heuristic_mesh_knobs(
        n, batch, prf_method=3, scheme=scheme, n_table=n_table) == \
        jmesh_tune.heuristic_mesh_knobs(n, batch, prf_method=3,
                                        scheme=scheme, n_table=n_table)
    stages = mesh_tune.MESH_SQRT_STAGES if scheme == "sqrtn" else \
        mesh_tune.MESH_STAGES
    cur = mesh_tune.heuristic_mesh_knobs(n, batch, prf_method=3,
                                         scheme=scheme, n_table=n_table)
    for stage in stages:
        kw = dict(n=n, batch=batch, scheme=scheme, n_table=n_table)
        assert mesh_tune.mesh_stage_candidates(stage, cur, **kw) == \
            jmesh_tune.mesh_stage_candidates(stage, cur, **kw), stage


def test_tune_mesh_eval_search_and_consume(tmp_cache):
    from dpf_tpu_torch.tune.cache import lookup_mesh_knobs
    mesh = make_mesh(4, 2, devices=CPU)
    rec = mesh_tune.tune_mesh_eval(512, 4, mesh=mesh, prf_method=0, reps=1,
                                   distinct=4)
    assert rec["searched"] and rec["gated"]
    m = rec["measured"]
    assert m["rejected"] == 0 and m["mesh"] == "2x4"
    assert m["best_s"] <= m["heuristic_s"]
    assert not mesh_tune.tune_mesh_eval(512, 4, mesh=mesh, prf_method=0,
                                        reps=1, distinct=4)["searched"]
    knobs = lookup_mesh_knobs(n=512, entry_size=16, batch=4, prf_method=0,
                              mesh="2x4", device="cpu")
    assert knobs == rec["knobs"]
    table = np.zeros((512, 16), np.int32)
    srv = ShardedDPFServer(table, mesh, prf_method=0, batch_size=4)
    kn = srv.resolved_eval_knobs(4)
    assert (kn["chunk_leaves"], kn["psum_group"]) == \
        (knobs["chunk_leaves"], knobs["psum_group"])
    srv = ShardedDPFServer(table, mesh, prf_method=0, batch_size=4,
                           chunk_leaves=16)        # explicit wins
    assert srv.resolved_eval_knobs(4)["chunk_leaves"] == 16
    # another split has no mesh entry: the heuristic
    other = ShardedDPFServer(table, make_mesh(2, 1, devices=CPU[:2]),
                             prf_method=0, batch_size=4)
    assert other.resolved_eval_knobs(4)["chunk_leaves"] == \
        mesh_tune.heuristic_mesh_knobs(512, 4, prf_method=0,
                                       n_table=2)["chunk_leaves"]


def test_invalid_split_raises_value_error(tmp_cache):
    with pytest.raises(ValueError):
        mesh_tune.tune_mesh_eval(512, 4, mesh=make_mesh(8, 1, devices=CPU),
                                 prf_method=5, scheme="sqrtn", reps=1,
                                 distinct=2)


def test_tune_mesh_serving_and_shape_race(tmp_cache):
    from dpf_tpu_torch import DPF
    from dpf_tpu_torch.tune.serve_tune import (lookup_serve_knobs,
                                               serve_shape_of)
    mesh = make_mesh(4, 2, devices=CPU)
    table = np.random.default_rng(0).integers(
        0, 2 ** 31, (512, 16), dtype=np.int64).astype(np.int32)
    dpf = DPF(prf=0, device="cpu")
    srv = ShardedDPFServer(table, mesh, prf_method=0, batch_size=4)
    rec = mesh_tune.tune_mesh_serving(srv, dpf, cap=4, reps=1, distinct=4,
                                      trace=[4, 2, 3, 4], in_flight=(1,),
                                      ladders=[(4,), (2, 4)])
    assert rec["searched"] and rec["gated"]
    assert rec["measured"]["mesh"] == serve_shape_of(srv)["mesh"] == "2x4"
    assert lookup_serve_knobs(srv, 4) == rec["knobs"]
    eng = srv.serving_engine()
    eng.warmup(tune=True)
    assert list(eng.buckets.sizes) == rec["knobs"]["buckets"]
    dpf.eval_init(table)
    assert "mesh" not in serve_shape_of(dpf)
    assert lookup_serve_knobs(dpf, 4) is None
    devices = CPU[:2]
    mesh_tune.tune_mesh_eval(512, 4, mesh=make_mesh(2, 1, devices=devices),
                             prf_method=0, reps=1, distinct=4)
    race = mesh_tune.tune_mesh_shape(512, 4, devices=devices, prf_method=0,
                                     reps=1)
    splits = race["measured"]["splits"]
    assert {(r["n_batch"], r["n_table"]) for r in splits} == {(1, 2),
                                                             (2, 1)}
    assert any(r.get("from_cache") for r in splits
               if (r["n_batch"], r["n_table"]) == (1, 2))
    assert mesh_tune.lookup_mesh_split(
        n=512, entry_size=16, batch=4, prf_method=0, n_devices=2,
        device="cpu") == race["knobs"]


def test_tune_cluster_round_trip(tmp_cache):
    from dpf_tpu_torch.parallel.cluster import ClusterRouter
    from dpf_tpu_torch.tune.serve_tune import (lookup_cluster_knobs,
                                               tune_cluster)
    table = np.random.default_rng(1).integers(
        0, 2 ** 31, (256, 4), dtype=np.int64).astype(np.int32)
    rec = tune_cluster(table, hosts=2, prf_method=0, cap=8, reps=1,
                       distinct=4, in_flight=(1, 2), ladders=[(8,), (4, 8)],
                       device="cpu")
    assert rec["searched"] and rec["gated"]
    assert rec["measured"]["rejected"] == 0
    assert not tune_cluster(table, hosts=2, prf_method=0, cap=8,
                            device="cpu")["searched"]
    knobs = lookup_cluster_knobs(n=256, entry_size=4, hosts=2,
                                 prf_method=0, cap=8, device="cpu")
    assert knobs == rec["knobs"]
    c = ClusterRouter.local(table, hosts=2, prf_method=0,
                            engine_kw={"cap": 8}, device="cpu")
    eng = c.hosts["host0"].engine
    assert list(eng.buckets.sizes) == knobs["buckets"]
    assert eng.max_in_flight == knobs["max_in_flight"]
