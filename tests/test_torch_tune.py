"""The port's tuning subsystem (``dpf_tpu_torch.tune``) against dpf_tpu's,
on the CPU (``device="cpu"``).

Key grammar, the cache's round trip and nearest-batch fallback, the
candidate generators and ``scheme="auto"`` on a cold cache are held
equal to ``dpf_tpu``'s; every candidate the staged search offers must
give the oracle's shares, bit for bit; a stored knob must steer the
resolver (``tuned``, ``searched``) unless the config pins it.  Every
test runs on a tuning cache of its own under ``tmp_path`` (the port's
and ``dpf_tpu``'s env vars), so none reads or writes ``~/.cache``.
"""

import json

import numpy as np
import pytest
import torch

import dpf_tpu
from dpf_tpu.core import expand as jexpand
from dpf_tpu.core import sqrtn as jsqrtn
from dpf_tpu.tune import fingerprint as jfp
from dpf_tpu.tune import search as jsearch
from dpf_tpu.utils.config import EvalConfig as JaxEvalConfig
from dpf_tpu_torch import DPF
from dpf_tpu_torch.apps.batch_pir import (PrivateLookupClient,
                                          PrivateLookupServer)
from dpf_tpu_torch.core import expand, radix4, sqrtn
from dpf_tpu_torch.ops import matmul128, sqrt_grid, subtree
from dpf_tpu_torch.serve import Buckets
from dpf_tpu_torch.serve.router import SchemeRouter, resolve_sticky
from dpf_tpu_torch.tune import cache as tcache
from dpf_tpu_torch.tune import fingerprint, search, serve_tune
from dpf_tpu_torch.utils.config import EvalConfig
from dpf_tpu_torch.utils.profiling import CACHE_COUNTERS, SWALLOWED_ERRORS

CPU = torch.device("cpu")
CONSTRUCTIONS = (("logn", 2), ("logn", 4), ("sqrtn", 2))


@pytest.fixture(autouse=True)
def fresh_cache(tmp_path, monkeypatch):
    """Both packages' tuning caches in tmp_path, one torch thread."""
    monkeypatch.setenv(tcache.ENV, str(tmp_path / "tuning.json"))
    monkeypatch.setenv("DPF_TPU_TUNE_CACHE", str(tmp_path / "jax.json"))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield tcache.default_cache(refresh=True)
    torch.set_num_threads(threads)


def _table(n, e=3, seed=0):
    return np.random.default_rng(seed).integers(
        -2 ** 31, 2 ** 31, (n, e), dtype=np.int64).astype(np.int32)


def _server(prf, scheme, radix, n, e=3, **cfg):
    d = DPF(config=EvalConfig(prf_method=prf, scheme=scheme, radix=radix,
                              **cfg), device="cpu")
    d.eval_init(_table(n, e))
    return d


def _keys(d, n, count, tag=b"tt"):
    return d.gen_batch([(i * 37 + 5) % n for i in range(count)], n,
                       seeds=[tag + b"%d" % i for i in range(count)])[0]


# ------------------------------------------------------------ key grammar


@pytest.mark.parametrize("shape", [
    dict(n=1024, entry_size=16, batch=512, prf_method=3),
    dict(n=1 << 20, entry_size=1, batch=7, prf_method=5, scheme="sqrtn"),
    dict(n=4096, entry_size=0, batch=64, prf_method=2, radix=4),
    dict(n=128, entry_size=8, batch=1, prf_method=0, scheme="any",
         radix=0)])
def test_key_grammar_matches_dpf_tpu(shape):
    assert fingerprint.shape_key(**shape) == jfp.shape_key(**shape)
    for kind in ("eval", "kvariant", "scheme", "serve", "router"):
        assert fingerprint.cache_key(kind, fingerprint="fp", **shape) == \
            jfp.cache_key(kind, fingerprint="fp", **shape)


def test_fingerprint_tiers_never_answer_each_other(fresh_cache,
                                                   monkeypatch):
    cpu_fp = fingerprint.device_fingerprint("cpu")
    assert cpu_fp.startswith("cpu/") and "/x1/torch" in cpu_fp
    assert fingerprint.device_fingerprint(None) == cpu_fp   # no card here

    class Props:
        name, major, minor, multi_processor_count = "Card X", 9, 0, 132
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda i: Props)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    fingerprint._fingerprint.cache_clear()
    try:
        gpu_fp = fingerprint.device_fingerprint("cuda")
        assert gpu_fp.startswith("cuda/Card_X/sm90/132sm/x1/torch")
        shape = dict(n=1024, entry_size=16, batch=64, prf_method=3)
        fresh_cache.store(fingerprint.cache_key("eval", device="cpu",
                                                **shape),
                          {"knobs": {"chunk_leaves": 256}})
        assert fresh_cache.lookup_knobs("eval", device="cpu",
                                        **shape) == {"chunk_leaves": 256}
        assert fresh_cache.lookup_knobs("eval", device="cuda",
                                        nearest_batch=True, **shape) is None
    finally:
        fingerprint._fingerprint.cache_clear()


# ---------------------------------------------------------- tuning cache


def test_tuning_cache_roundtrip_and_counters(tmp_path):
    path = str(tmp_path / "own.json")
    c = tcache.TuningCache(path)
    key = fingerprint.cache_key("eval", n=1024, entry_size=16, batch=64,
                                prf_method=0, device="cpu")
    h0, m0 = CACHE_COUNTERS.tuning_hits, CACHE_COUNTERS.tuning_misses
    s0 = CACHE_COUNTERS.tuning_stores
    assert c.lookup(key) is None
    assert CACHE_COUNTERS.tuning_misses == m0 + 1
    c.store(key, {"knobs": {"dot_impl": "mxu", "chunk_leaves": 256}})
    assert CACHE_COUNTERS.tuning_stores == s0 + 1
    assert c.lookup(key)["knobs"]["dot_impl"] == "mxu"
    assert CACHE_COUNTERS.tuning_hits == h0 + 1
    c2 = tcache.TuningCache(path)        # a second process's view
    assert c2.lookup(key)["knobs"]["chunk_leaves"] == 256
    assert "tuned_at" in c2.entries[key]
    # merge on save: two writers keep each other's entries
    other = fingerprint.cache_key("eval", n=2048, entry_size=16, batch=64,
                                  prf_method=0, device="cpu")
    c2.store(other, {"knobs": {"dot_impl": "i32"}})
    c.store(key, {"knobs": {"dot_impl": "i32"}})
    assert set(json.load(open(path))["entries"]) == {key, other}
    with open(path, "w") as f:       # corrupt file = cold cache
        f.write("{not json")
    bad = tcache.TuningCache(path)
    assert bad.lookup(key) is None and bad.load_error


def test_tuning_cache_nearest_batch_fallback(tmp_path):
    c = tcache.TuningCache(str(tmp_path / "t.json"))
    shape = dict(n=2048, entry_size=16, prf_method=0, device="cpu")
    c.store(fingerprint.cache_key("eval", batch=512, **shape),
            {"knobs": {"dot_impl": "mxu"}})
    c.store(fingerprint.cache_key("eval", batch=32, **shape),
            {"knobs": {"dot_impl": "i32"}})
    assert c.lookup_knobs("eval", batch=512, **shape)["dot_impl"] == "mxu"
    # below: the largest tuned batch <= 64; above: the smallest > 8
    assert c.lookup_knobs("eval", batch=64, nearest_batch=True,
                          **shape)["dot_impl"] == "i32"
    assert c.lookup_knobs("eval", batch=8, nearest_batch=True,
                          **shape)["dot_impl"] == "i32"
    assert c.lookup_knobs("eval", batch=1024, nearest_batch=True,
                          **shape)["dot_impl"] == "mxu"
    assert c.lookup_knobs("eval", batch=64, **shape) is None


def test_cache_path_is_the_ports_own(monkeypatch, tmp_path):
    monkeypatch.delenv(tcache.ENV)
    monkeypatch.setenv("HOME", str(tmp_path))
    assert tcache.default_path() == str(
        tmp_path / ".cache" / "dpf_tpu_torch" / "tuning.json")
    from dpf_tpu.tune import cache as jcache
    monkeypatch.delenv("DPF_TPU_TUNE_CACHE")
    assert jcache.default_path() != tcache.default_path()
    monkeypatch.setenv("DPF_TPU_TUNE_CACHE", str(tmp_path / "x.json"))
    assert tcache.default_path() != str(tmp_path / "x.json")
    monkeypatch.setenv(tcache.ENV, "0")
    c = tcache.default_cache()
    assert c.path is None
    c.store("k", {"knobs": {}})          # in memory only
    assert c.lookup("k") is not None and not list(tmp_path.rglob("*.json"))


# ---------------------------------------------------- candidate generators


@pytest.mark.parametrize("n,batch", [(256, 1), (1024, 16), (4096, 512),
                                     (1 << 16, 512), (1 << 20, 512),
                                     (1 << 20, 37)])
def test_candidate_generators_match_dpf_tpu(n, batch):
    """The live-seed routes' (AES, DUMMY) and the plain scan's
    candidates are dpf_tpu's, value for value."""
    cands = expand.chunk_candidates(n, batch)
    assert cands == jexpand.chunk_candidates(n, batch)
    for c in cands:
        assert expand.f_level_candidates(n, c, batch) == \
            jexpand.f_level_candidates(n, c, batch)
        assert expand.clamp_chunk(c, n, batch) == c
    k, r = sqrtn.default_split(n)
    assert sqrtn.sqrt_chunk_candidates(r, k, batch) == \
        jsqrtn.sqrt_chunk_candidates(r, k, batch)


@pytest.mark.parametrize("n", [256, 1 << 13, 1 << 20])
def test_k2_and_k4_candidates_follow_their_rules(n):
    depth = n.bit_length() - 1
    top = subtree.subtree_chunk_leaves(n)
    binary = subtree.block_leaves_candidates(n)
    assert top in binary and max(binary) == top <= 4096
    assert all(c & (c - 1) == 0 for c in binary)
    ars = radix4.arities(n)
    for c in subtree.block_leaves_candidates(n, ars):
        assert radix4._suffix_chunk(ars, c)[1] == c <= 4096
    for c in binary:
        for fl in subtree.frontier_level_candidates(n, c, 512):
            assert 0 <= fl <= depth - (c.bit_length() - 1)
            assert (1 << fl) * 16 * 512 <= expand.CHUNK_SEED_BYTES_BOUND
    k, r = sqrtn.default_split(n)
    steps = sqrt_grid.row_chunk_candidates(r, k, 512)
    assert sqrt_grid.heuristic_grid_rows(r, k, 512) in steps
    for rc in steps:       # every step is one K4 takes as given
        assert sqrtn._resolve_row_chunk(r, k, 1, rc) == rc


def test_heuristic_knobs_are_the_cold_resolution():
    n, batch = 1024, 16
    for scheme, radix in CONSTRUCTIONS:
        for prf in range(6):
            d = _server(prf, scheme, radix, n)
            got = d.resolved_eval_knobs(batch)
            h = search.heuristic_knobs(n, batch, prf_method=prf,
                                       radix=radix, scheme=scheme)
            assert got["kernel_resolved_from"] == "heuristic"
            if scheme == "sqrtn":
                assert got["row_chunk_effective"] == h["row_chunk"]
            else:
                assert (got["chunk_leaves"], got["dot_impl"],
                        got["dispatch_group"]) == (
                    h["chunk_leaves"], h["dot_impl"], h["dispatch_group"])
    assert search.heuristic_scheme(1024) == jsearch.heuristic_scheme(1024)


# ------------------------------------------------------------ scheme=auto


def test_scheme_auto_cold_cache_matches_dpf_tpu():
    n = 512
    ours = DPF(prf=5, scheme="auto", device="cpu")
    theirs = dpf_tpu.DPF(prf=5, scheme="auto")
    ka, kb = ours.gen(77, n, seed=b"auto-wire")
    ja, jb = theirs.gen(77, n, seed=b"auto-wire")
    assert (ours.scheme, ours.radix) == (theirs.scheme, theirs.radix)
    assert ours.scheme_resolved_from == theirs.scheme_resolved_from \
        == "heuristic"
    assert np.array_equal(ka.numpy(), np.asarray(ja))
    assert np.array_equal(kb.numpy(), np.asarray(jb))
    srv = DPF(prf=5, scheme="auto", device="cpu")
    srv.eval_init(_table(n))
    assert (srv.scheme, srv.scheme_resolved_from) == ("logn", "heuristic")
    assert torch.equal(srv.eval_gpu([ka]), srv.eval_cpu([ka]))


def test_scheme_auto_reads_the_scheme_winner(fresh_cache):
    n, e = 1024, 3
    fresh_cache.store(
        search.scheme_cache_key(n=n, entry_size=e, batch=512, prf_method=2,
                                device="cpu"),
        {"knobs": {"scheme": "sqrtn", "radix": 2, "construction": "sqrtn"}})
    srv = DPF(prf=2, scheme="auto", device="cpu")
    srv.eval_init(_table(n, e))
    cli = DPF(prf=2, scheme="auto", entry_size=e, device="cpu")
    ka, kb = cli.gen(9, n, seed=b"w")
    assert (srv.scheme, srv.scheme_resolved_from) == ("sqrtn", "cache")
    assert cli.scheme == "sqrtn"
    assert ((srv.eval_gpu([ka]) - srv.eval_gpu([kb])).numpy()
            == srv.table[9]).all()
    # another width misses the entry: the binary tree
    other = DPF(prf=2, scheme="auto", entry_size=16, device="cpu")
    other.gen(1, n)
    assert (other.scheme, other.scheme_resolved_from) == ("logn",
                                                          "heuristic")
    assert resolve_sticky(n, e, 2, 512, device="cpu") == ("sqrtn", "cache")
    assert resolve_sticky(n, 16, 2, 512, device="cpu") == ("logn",
                                                           "heuristic")


# -------------------------------------------------------- the resolution


def test_stored_knobs_resolve_tuned_searched_and_config(fresh_cache):
    n, batch = 1024, 8
    shape = dict(n=n, entry_size=3, batch=batch, prf_method=3,
                 scheme="logn", radix=2, device="cpu")
    fresh_cache.store(fingerprint.cache_key("eval", **shape),
                      {"knobs": {"chunk_leaves": 256, "dot_impl": "mxu",
                                 "kernel_impl": "fused"}})
    d = _server(3, "logn", 2, n, kernel_impl=None, dot_impl=None)
    kn = d.resolved_eval_knobs(batch)
    assert kn["kernel_resolved_from"] == "tuned"
    assert (kn["chunk_leaves"], kn["dot_impl"]) == (256, "mxu")
    keys = _keys(d, n, batch)
    assert torch.equal(d.eval_gpu(keys), d.eval_cpu(keys))
    # the memo: one lookup per batch size until eval_init
    hits = CACHE_COUNTERS.tuning_hits
    d.resolved_eval_knobs(batch)
    assert CACHE_COUNTERS.tuning_hits == hits
    # a searched variant outranks the tuned knobs
    from dpf_tpu_torch.tune.kernel_search import KernelVariant
    v = KernelVariant(family="ggm", engine="dispatch", chunk_leaves=128,
                      dispatch_group=2, dot_impl="i32")
    fresh_cache.store(fingerprint.cache_key("kvariant", **shape),
                      {"knobs": v.eval_knobs()})
    d.eval_init(d.table)
    kn = d.resolved_eval_knobs(batch)
    assert kn["kernel_resolved_from"] == "searched"
    assert (kn["kernel_impl"], kn["chunk_leaves"], kn["dispatch_group"],
            kn["dot_impl"]) == ("dispatch", 128, 2, "i32")
    assert kn["kernel_variant"]["family"] == "ggm"
    assert torch.equal(d.eval_gpu(keys), d.eval_cpu(keys))
    # explicit config fields win over both
    p = _server(3, "logn", 2, n, kernel_impl="fused", dot_impl="i32",
                chunk_leaves=512)
    kn = p.resolved_eval_knobs(batch)
    assert (kn["kernel_resolved_from"], kn["chunk_leaves"],
            kn["dot_impl"]) == ("config", 512, "i32")
    # a tuned chunk of another route does not ride the pinned one
    q = _server(3, "logn", 2, n, kernel_impl="dispatch", dot_impl=None)
    fresh_cache.store(fingerprint.cache_key("kvariant", **shape), {})
    q.eval_init(q.table)
    assert q.resolved_eval_knobs(batch)["chunk_leaves"] == \
        expand.clamp_chunk(None, n, batch)


def test_tuned_k4_grid_step_runs_as_given(fresh_cache):
    n, batch = 4096, 8
    k, r = sqrtn.default_split(n)
    fresh_cache.store(fingerprint.cache_key(
        "eval", n=n, entry_size=3, batch=batch, prf_method=4,
        scheme="sqrtn", radix=2, device="cpu"),
        {"knobs": {"row_chunk": 16, "kernel_impl": "fused"}})
    d = _server(4, "sqrtn", 2, n)
    kn = d.resolved_eval_knobs(batch)
    assert kn["kernel_resolved_from"] == "tuned"
    assert kn["grid_rows"] == kn["row_chunk_effective"] == 16
    assert kn["row_chunk"] is None
    keys = _keys(d, n, batch)
    assert torch.equal(d.eval_gpu(keys), d.eval_cpu(keys))


def test_explicit_chunk_is_clamped_and_surfaced_or_refused():
    n, batch = 1 << 14, 8
    before = sum(SWALLOWED_ERRORS.get("api.chunk_leaves_clamped",
                                      {}).values())
    d = _server(2, "logn", 2, n, chunk_leaves=8192)   # over K2's 4096
    kn = d.resolved_eval_knobs(batch)
    assert kn["chunk_leaves"] == kn["chunk_leaves_effective"] == 4096
    after = sum(SWALLOWED_ERRORS.get("api.chunk_leaves_clamped",
                                     {}).values())
    assert after == before + 1
    with pytest.raises(ValueError, match="power of two"):
        _server(2, "logn", 2, n, chunk_leaves=3000).resolved_eval_knobs(8)
    a = _server(3, "logn", 2, n, chunk_leaves=3000)
    with pytest.raises(ValueError, match="power of two"):
        a.eval_gpu(_keys(a, n, 2))
    ok = _server(3, "logn", 2, n, chunk_leaves=1024)
    assert "chunk_leaves_effective" not in ok.resolved_eval_knobs(8)


def test_applied_restores_the_matmul_default_after_a_crash():
    assert matmul128.default_impl() == "i32"
    with pytest.raises(RuntimeError):
        with EvalConfig(dot_impl="mxu").applied():
            assert matmul128.default_impl() == "mxu"
            raise RuntimeError("a crashed candidate")
    assert matmul128.default_impl() == "i32"
    cfg = EvalConfig(round_unroll=True).with_(chunk_leaves=64)
    assert (cfg.round_unroll, cfg.chunk_leaves) == (True, 64)
    d = DPF(config=cfg, device="cpu")
    d.eval_init(_table(256))
    assert d.resolved_eval_knobs(4)["round_unroll"] is True   # recorded


# --------------------------------------------------------------- searches


def test_tune_eval_searches_then_hits():
    kw = dict(prf_method=3, reps=1, distinct=4, device="cpu")
    rec = search.tune_eval(1024, 16, **kw)
    m = rec["measured"]
    assert rec["searched"] and rec["gated"]
    assert m["rejected"] == 0 and m["gate_escapes"] == 0
    assert m["candidates_tried"] >= 4 and m["best_s"] <= m["heuristic_s"]
    hits = CACHE_COUNTERS.tuning_hits
    again = search.tune_eval(1024, 16, **kw)
    assert again["searched"] is False and again["knobs"] == rec["knobs"]
    assert CACHE_COUNTERS.tuning_hits == hits + 1
    d = _server(3, "logn", 2, 1024, e=16, kernel_impl=None, dot_impl=None)
    assert d.resolved_eval_knobs(16)["kernel_resolved_from"] == "tuned"


def _stage_knob_sets(n, batch, prf, scheme, radix):
    """The heuristic and every single-knob substitution the staged search
    offers, dispatch groups under the dispatch route."""
    base = search.heuristic_knobs(n, batch, prf_method=prf, radix=radix,
                                  scheme=scheme)
    stages = search.SQRT_STAGES if scheme == "sqrtn" else search.STAGES
    out = [dict(base)]
    for cur in (base, {**base, "kernel_impl": "dispatch"}):
        for stage in stages:
            for cand in search.stage_candidates(stage, cur, n=n,
                                                batch=batch, prf_method=prf,
                                                radix=radix):
                knobs = {**cur, stage: cand}
                if knobs not in out:
                    out.append(knobs)
        if scheme == "sqrtn":
            break
    return out


@pytest.mark.parametrize("scheme,radix", CONSTRUCTIONS)
@pytest.mark.parametrize("prf", range(6))
def test_every_stage_candidate_gives_the_oracle_shares(prf, scheme, radix):
    n, batch = 1024, 4
    dpf, keys, oracle = search._workload(n, batch, 3, prf, scheme, radix,
                                         batch, CPU)
    gate = search._Gate(dpf, keys, oracle, prf_method=prf, radix=radix,
                        scheme=scheme, batch=batch, reps=1, log=None)
    jd = dpf_tpu.DPF(config=JaxEvalConfig(prf_method=prf, radix=radix,
                                          scheme=scheme))
    jd.eval_init(dpf.table)
    want = np.asarray(jd.eval_cpu([k.numpy() for k in keys]))
    assert np.array_equal(oracle.numpy(), want)
    if (prf, scheme, radix) in ((5, "logn", 2), (0, "logn", 4)) or \
            scheme == "sqrtn":
        assert np.array_equal(np.asarray(jd.eval_tpu(
            [k.numpy() for k in keys])), want)
    knob_sets = _stage_knob_sets(n, batch, prf, scheme, radix)
    assert len(knob_sets) >= 2
    for knobs in knob_sets:
        with gate.pin(knobs).applied():
            assert np.array_equal(gate.run().numpy(), want), knobs


# -------------------------------------------------------- serving knobs


def test_warmup_tune_replaces_buckets_in_place(fresh_cache):
    d = _server(2, "logn", 2, 256)
    engine = d.serving_engine(buckets=(2, 4, 8))
    fresh_cache.store(
        fingerprint.cache_key("serve", batch=8,
                              **serve_tune.serve_shape_of(d)),
        {"knobs": {"buckets": [4, 8], "max_in_flight": 1}})
    engine.warmup(tune=True)
    assert engine.buckets.sizes == (4, 8) and engine.max_in_flight == 1
    keys = _keys(d, 256, 5)
    assert np.array_equal(engine.submit(keys).result(),
                          d.eval_cpu(keys).numpy())
    # a miss searches (every candidate gated) and stores the winner
    e2 = _server(2, "logn", 2, 128).serving_engine(buckets=(2, 4))
    e2.warmup(tune=True, trace=[4, 1, 3, 4])
    rec = fresh_cache.lookup(fingerprint.cache_key(
        "serve", batch=4, **serve_tune.serve_shape_of(e2._server)))
    assert rec["gated"] and rec["measured"]["rejected"] == 0
    assert list(e2.buckets.sizes) == rec["knobs"]["buckets"]
    assert e2.max_in_flight == rec["knobs"]["max_in_flight"]


def test_router_and_tenant_ladders_read_the_cache(fresh_cache):
    n, e, cap = 256, 3, 8
    table = _table(n, e)
    fresh_cache.store(serve_tune.router_cache_key(
        n=n, entry_size=e, batch=cap, prf_method=2, device="cpu"),
        {"knobs": {"buckets": [2, 8], "max_in_flight": 1,
                   "ewma_alpha": 0.5}})
    fresh_cache.store(search.scheme_cache_key(
        n=n, entry_size=e, batch=cap, prf_method=2, device="cpu"),
        {"knobs": {"scheme": "logn", "radix": 4, "construction": "radix4"},
         "measured": {"per_construction": [
             {"construction": "radix4", "tuned_s": 0.25},
             {"construction": "logn", "tuned_s": 0.5}]}})
    r = SchemeRouter(table, prf=2, cap=cap, probe=False, warmup=False,
                     device="cpu")
    assert r.buckets.sizes == (2, 8) and r.ewma_alpha == 0.5
    assert (r.sticky, r.sticky_resolved_from) == ("radix4", "cache")
    assert r._costs[("radix4", cap)] == 0.25
    assert serve_tune.cached_cost_table(
        n=n, entry_size=e, cap=cap, prf_method=2, device="cpu") == {
            "radix4@8": 0.25, "logn@8": 0.5}
    from dpf_tpu_torch.serve.tenant import TenantRouter
    ladder, knobs = TenantRouter()._ladder(r._servers, cap)
    assert ladder.sizes == (2, 8) and knobs["max_in_flight"] == 1
    assert TenantRouter()._ladder(r._servers, 4)[0].sizes == \
        Buckets.default_sizes(4)


def test_tune_router_gates_every_answer_and_stores(fresh_cache):
    n, cap = 256, 4
    rec = serve_tune.tune_router(
        _table(n), prf_method=2, cap=cap, trace=[4, 1, 3], ladders=[(2, 4)],
        in_flight=(1,), reps=1, distinct=2, device="cpu",
        constructions=("logn", "radix4"))
    assert rec["searched"] and rec["gated"]
    assert rec["measured"]["rejected"] == 0
    assert rec["knobs"]["buckets"] == [2, 4]


def test_batch_pir_auto_resolves_per_size_group(fresh_cache):
    table = _table(600, 4)
    bins = [set(range(0, 200)), set(range(200, 400)), set(range(400, 600))]
    cold = PrivateLookupServer(table, bins, prf=2, scheme="auto",
                               device="cpu")
    assert set(cold.group_constructions().values()) == {("logn", 2)}
    fresh_cache.store(search.scheme_cache_key(
        n=256, entry_size=4, batch=4, prf_method=2, device="cpu"),
        {"knobs": {"scheme": "sqrtn", "radix": 2}})
    srv = PrivateLookupServer(table, bins, prf=2, scheme="auto",
                              device="cpu")
    cli = PrivateLookupClient(bins, srv.bin_sizes, prf=2, scheme="auto",
                              entry_size=4, device="cpu")
    assert srv.group_constructions() == cli.group_constructions() == {
        256: ("sqrtn", 2)}
    ka, kb, plan = cli.make_queries([5, 250, 590], seeds=[
        b"bp%d" % i for i in range(3)])
    diff = srv.answer(ka) - srv.answer(kb)
    for bi, idx in enumerate(plan):
        if idx is not None:
            assert (diff[bi] == table[idx]).all()
