"""The port's batch-PIR planner, lookup server, client and stream against
dpf_tpu's, on the CPU (``device="cpu"``: the kernels' plain versions).

The planner's bins, hot/cold split, collocation map and costs, the
client's keys under pinned seeds and the servers' shares are held equal
to dpf_tpu's, bit for bit, for the binary, radix-4 and sqrt-N
constructions.  ``PrivateLookupServer(mesh=...)`` on meshes of CPU
devices (1 x 4, 2 x 4 and the 1 x 2 x 2 rows x bytes mesh) equals
dpf_tpu's meshed server on the matching mesh of the 8 forced JAX CPU
devices (``tests/conftest.py``) and the port's one-device server, with
group counts that are not multiples of the mesh size; ``scheme="auto"``
resolves every size group on a cold tuning cache to the caller's log-N
radix.
"""

import json

import numpy as np
import pytest
import torch

from dpf_tpu.apps import batch_pir as jbp
from dpf_tpu_torch import DPF, EvalConfig
from dpf_tpu_torch.apps import batch_pir
from dpf_tpu_torch.apps.batch_pir import (BatchPIROptimize, CollocateConfig,
                                          HotColdConfig, PIRConfig,
                                          PrivateLookupClient,
                                          PrivateLookupServer)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch's CPU ops on one thread here: the suite runs several worker
    processes side by side."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _access_patterns(n_entries=200, n_sets=60, seed=0):
    rng = np.random.default_rng(seed)
    # zipf-ish popularity so the hot/cold split is meaningful
    popularity = 1.0 / np.arange(1, n_entries + 1)
    popularity /= popularity.sum()
    pats = []
    for _ in range(n_sets):
        k = int(rng.integers(3, 12))
        pats.append(list(rng.choice(n_entries, size=k, p=popularity)))
    return [[int(x) for x in p] for p in pats]


def _both(train, val, frac=1.0, colloc=0, **pir):
    """The same plan from both packages."""
    mine = BatchPIROptimize(train, val, HotColdConfig(frac),
                            CollocateConfig(colloc), PIRConfig(**pir))
    ref = jbp.BatchPIROptimize(train, val, jbp.HotColdConfig(frac),
                               jbp.CollocateConfig(colloc),
                               jbp.PIRConfig(**pir))
    return mine, ref


# ------------------------------------------------------------ planner

@pytest.mark.parametrize("frac,colloc,pir", [
    (1.0, 0, dict(bin_fraction=0.05, queries_to_hot=3)),
    (0.5, 2, dict(bin_fraction=0.1, queries_to_hot=1, queries_to_cold=1)),
    (0.25, 1, dict(bin_fraction=0.3, queries_to_hot=2, queries_to_cold=1,
                   scheme="sqrtn")),
    (1.0, 0, dict(bin_fraction=1 / 256., radix=4)),
])
def test_planner_matches_dpf_tpu(frac, colloc, pir):
    """Hot and cold tables (the sha256 stable shuffle), bins, the
    collocation map, every fetch's recovered set and cost, and the
    evaluation summary equal dpf_tpu's."""
    train, val = _access_patterns(seed=1), _access_patterns(seed=2)
    mine, ref = _both(train, val, frac, colloc, **pir)
    assert mine.hot_table == ref.hot_table
    assert mine.cold_table == ref.cold_table
    assert mine.hot_table_bins == ref.hot_table_bins
    assert mine.cold_table_bins == ref.cold_table_bins
    assert mine.collocation_map == ref.collocation_map
    for v in val:
        got, cost = mine.fetch(v)
        want, wcost = ref.fetch(v)
        assert got == want and cost._asdict() == wcost._asdict()
    assert mine.evaluate() == ref.evaluate()
    assert mine.summarize_evaluation() == ref.summarize_evaluation()


def test_optimizer_full_recovery_with_enough_queries():
    train, val = _access_patterns(seed=1), _access_patterns(seed=2)
    opt = BatchPIROptimize(
        train, val, HotColdConfig(1.0), CollocateConfig(0),
        PIRConfig(bin_fraction=0.05, queries_to_hot=12, queries_to_cold=0))
    opt.evaluate()
    s = opt.summarize_evaluation()
    assert s["mean_recovered"] > 0.9
    assert s["cost"]["computation"] > 0
    assert s["cost"]["upload_communication"] > 0


def test_optimizer_fewer_queries_recover_less():
    train, val = _access_patterns(seed=1), _access_patterns(seed=2)

    def run(q):
        opt = BatchPIROptimize(
            train, val, HotColdConfig(1.0), CollocateConfig(0),
            PIRConfig(bin_fraction=0.2, queries_to_hot=q))
        opt.evaluate()
        return np.mean(opt.percentage_of_query_recovered)

    assert run(1) <= run(2) <= run(8)


def test_hot_cold_split_by_frequency():
    opt = BatchPIROptimize(
        [[0, 0, 1], [0, 1], [0], [2]], [[0, 3]], HotColdConfig(0.5),
        CollocateConfig(0),
        PIRConfig(bin_fraction=1.0, queries_to_hot=1, queries_to_cold=1))
    assert set(opt.hot_table) == {0, 1}
    assert set(opt.cold_table) == {2, 3}


def test_collocation_recovers_neighbors_free():
    opt = BatchPIROptimize(
        [[10, 11]] * 20 + [[12]] * 5, [[10, 11]], HotColdConfig(1.0),
        CollocateConfig(1), PIRConfig(bin_fraction=1.0, queries_to_hot=1))
    recovered, _ = opt.fetch([10, 11])
    assert 10 in recovered and 11 in recovered
    opt.evaluate()
    assert np.mean(opt.percentage_of_query_recovered) == 1.0


def test_fetch_prefers_unrecovered_most_needed():
    opt = BatchPIROptimize(
        [[0], [0], [0], [0, 1]], [[0, 0, 1, 1]], HotColdConfig(1.0),
        CollocateConfig(0),
        PIRConfig(bin_fraction=1.0, queries_to_hot=2, queries_to_cold=0))
    recovered, _ = opt.fetch([0, 0, 1, 1])
    assert recovered == {0, 1}


def test_collocate_cache_loads_across_packages(tmp_path):
    """A collocation cache written by dpf_tpu loads in the port, and the
    reverse, to the same map."""
    train = _access_patterns(seed=4)
    to_port, to_ref = tmp_path / "ref.json", tmp_path / "port.json"
    ref = jbp.BatchPIROptimize(train, train, jbp.HotColdConfig(1.0),
                               jbp.CollocateConfig(2), jbp.PIRConfig(),
                               collocate_cache=str(to_port))
    mine = BatchPIROptimize(train, train, HotColdConfig(1.0),
                            CollocateConfig(2), PIRConfig(),
                            collocate_cache=str(to_port))
    assert mine.collocation_map == ref.collocation_map
    mine2 = BatchPIROptimize(train, train, HotColdConfig(1.0),
                             CollocateConfig(2), PIRConfig(),
                             collocate_cache=str(to_ref))
    ref2 = jbp.BatchPIROptimize(train, train, jbp.HotColdConfig(1.0),
                                jbp.CollocateConfig(2), jbp.PIRConfig(),
                                collocate_cache=str(to_ref))
    assert ref2.collocation_map == mine2.collocation_map
    assert json.loads(to_port.read_text()) == json.loads(to_ref.read_text())


def test_pir_config_rejects_unresolved_auto():
    with pytest.raises(ValueError, match="must be one of"):
        PIRConfig(scheme="auto")
    with pytest.raises(ValueError):
        PIRConfig(radix=3)
    with pytest.raises(ValueError, match="has no radix"):
        PIRConfig(scheme="sqrtn", radix=4)


def test_dpf_key_cost_model():
    assert batch_pir.dpf_key_cost_bytes(0) == 0
    assert batch_pir.dpf_key_cost_bytes(1) == 524 * 4
    assert batch_pir.dpf_key_cost_bytes(1 << 20) == 524 * 4
    assert batch_pir.dpf_key_cost_bytes(1 << 20, "logn", 4) == 524 * 4
    assert batch_pir.dpf_key_cost_bytes(1 << 20, "sqrtn") \
        == (4 + 1024 + 2 * 1024) * 16
    with pytest.raises(ValueError):
        batch_pir.dpf_key_cost_bytes(128, "auto")
    with pytest.raises(ValueError):
        batch_pir.dpf_key_cost_bytes(128, "logn", 3)


def test_dpf_key_cost_model_matches_real_keys():
    """The model equals the serialized bytes of real keys over the same
    padded bin domain, and dpf_tpu's model, for every construction."""
    rng = np.random.default_rng(5)
    sizes = [int(s) for s in rng.integers(1, 3000, 5)] + [1, 128, 129]
    for size in sizes:
        n = batch_pir._pad_pow2(size)
        alpha = int(rng.integers(0, size))
        for scheme, radix in (("logn", 2), ("logn", 4), ("sqrtn", 2)):
            key = DPF(prf=0, config=EvalConfig(radix=radix, scheme=scheme),
                      device="cpu").gen(alpha, n, seed=b"c")[0]
            cost = batch_pir.dpf_key_cost_bytes(size, scheme, radix)
            assert cost == key.numpy().nbytes
            assert cost == jbp.dpf_key_cost_bytes(size, scheme, radix)


# ------------------------------------------------- lookups on the card

def _setup(scheme="logn", radix=2, prf=DPF.PRF_DUMMY, n=300, e=4,
           bin_fraction=0.34):
    table = np.random.default_rng(9).integers(
        0, 2 ** 31, (n, e), dtype=np.int64).astype(np.int32)
    train = _access_patterns(n_entries=n, seed=3)
    opt = BatchPIROptimize(
        train, train, HotColdConfig(1.0), CollocateConfig(0),
        PIRConfig(bin_fraction=bin_fraction, queries_to_hot=1))
    sa, sb = (PrivateLookupServer(table, opt.hot_table_bins, prf=prf,
                                  radix=radix, scheme=scheme, device="cpu")
              for _ in range(2))
    cl = PrivateLookupClient(opt.hot_table_bins, sa.bin_sizes, prf=prf,
                             radix=radix, scheme=scheme, entry_size=e)
    return table, opt, sa, sb, cl


CONSTRUCTIONS = [("logn", 2, DPF.PRF_DUMMY), ("logn", 4, DPF.PRF_CHACHA20),
                 ("sqrtn", 2, DPF.PRF_CHACHA20)]


@pytest.mark.parametrize("scheme,radix,prf", CONSTRUCTIONS)
def test_client_keys_match_dpf_tpu(scheme, radix, prf):
    """Batched keys equal the per-bin gen loop's and dpf_tpu's client's,
    byte for byte, under pinned seeds."""
    table, opt, sa, _, cl = _setup(scheme, radix, prf)
    ref = jbp.PrivateLookupClient(opt.hot_table_bins, sa.bin_sizes, prf=prf,
                                  radix=radix, scheme=scheme, entry_size=4)
    assert cl.group_constructions() == ref.group_constructions()
    assert sa.group_constructions() == cl.group_constructions()
    wanted = [sorted(b)[0] for b in opt.hot_table_bins[:3]]
    seeds = [b"par-%d" % i for i in range(len(sa.bins))]
    ka, kb, plan = cl.make_queries(wanted, seeds=seeds)
    ka_s, kb_s, plan_s = cl.make_queries_scalar(wanted, seeds=seeds)
    ja, jb, jplan = ref.make_queries(wanted, seeds=seeds)
    assert plan == plan_s == jplan
    assert len(ka) == len(opt.hot_table_bins)
    for a, b, c in zip(ka + kb, ka_s + kb_s, ja + jb):
        assert a.dtype == np.int32
        assert np.array_equal(a, b) and np.array_equal(a, np.asarray(c))


@pytest.mark.parametrize("scheme,radix,prf", CONSTRUCTIONS + [
    ("logn", 2, DPF.PRF_CHACHA20_BLK), ("logn", 4, DPF.PRF_AES128),
    ("sqrtn", 2, DPF.PRF_AES128)])
def test_answer_matches_dpf_tpu(scheme, radix, prf):
    """Both servers' shares equal dpf_tpu's answer, answer ==
    answer_scalar, and the client recovers the rows exactly."""
    table, opt, sa, sb, cl = _setup(scheme, radix, prf)
    ref = jbp.PrivateLookupServer(table, opt.hot_table_bins, prf=prf,
                                  radix=radix, scheme=scheme)
    wanted = [sorted(b)[0] for b in opt.hot_table_bins[:3]]
    ka, kb, plan = cl.make_queries(wanted)
    ans_a, ans_b = sa.answer(ka), sb.answer(kb)
    assert ans_a.dtype == np.int32 and ans_a.shape == (len(sa.bins), 4)
    assert np.array_equal(ans_a, np.asarray(ref.answer(ka)))
    assert np.array_equal(ans_b, np.asarray(ref.answer(kb)))
    assert np.array_equal(ans_a, sa.answer_scalar(ka))
    got = cl.recover(ans_a, ans_b, plan)
    for w in wanted:
        assert w in got and (got[w] == table[w]).all()


def test_two_size_groups_match_dpf_tpu():
    """An uneven split gives two size groups (128- and 256-row bins),
    two dispatches; shares equal dpf_tpu's."""
    table = np.arange(300 * 4, dtype=np.int32).reshape(300, 4)
    bins = [set(range(100)), set(range(100, 280))]
    sa = PrivateLookupServer(table, bins, prf=DPF.PRF_SALSA20, device="cpu")
    ref = jbp.PrivateLookupServer(table, bins, prf=DPF.PRF_SALSA20)
    assert sorted(sa._groups) == [128, 256]
    cl = PrivateLookupClient(bins, sa.bin_sizes, prf=DPF.PRF_SALSA20)
    ka, kb, plan = cl.make_queries([5, 150])
    ans = sa.answer(ka)
    assert np.array_equal(ans, np.asarray(ref.answer(ka)))
    assert np.array_equal(ans, sa.answer_scalar(ka))
    got = cl.recover(ans, sa.answer(kb), plan)
    assert (got[5] == table[5]).all() and (got[150] == table[150]).all()


# ------------------------------------------------------- validation

def test_answer_rejects_wrong_domain_key_with_bin_index():
    _, opt, sa, _, cl = _setup()
    ka, _, _ = cl.make_queries([0])
    bad = list(ka)
    bad[1] = DPF(prf=DPF.PRF_DUMMY, device="cpu").gen(0, 512)[0].numpy()
    with pytest.raises(ValueError, match=r"bin 1 .*got n=512"):
        sa.answer(bad)
    with pytest.raises(ValueError, match=r"bin 1"):
        sa.answer_scalar(bad)


def test_answer_rejects_wrong_construction_key():
    _, opt, sa, _, cl = _setup()
    ka, _, _ = cl.make_queries([0])
    bad = list(ka)
    d4 = DPF(config=EvalConfig(prf_method=DPF.PRF_DUMMY, radix=4),
             device="cpu")
    bad[2] = d4.gen(0, sa.bin_sizes[2])[0].numpy()
    with pytest.raises(ValueError, match=r"bin 2 .*radix marker 4"):
        sa.answer(bad)

    _, _, sa4, _, cl4 = _setup("logn", 4, DPF.PRF_CHACHA20)
    ka4, _, _ = cl4.make_queries([0])
    bad = list(ka4)
    bad[0] = DPF(prf=DPF.PRF_CHACHA20, device="cpu").gen(
        0, sa4.bin_sizes[0])[0].numpy()
    with pytest.raises(ValueError, match=r"bin 0 .*radix marker 0"):
        sa4.answer(bad)


def test_answer_rejects_malformed_inputs():
    _, opt, sa, _, cl = _setup()
    ka, _, _ = cl.make_queries([0])
    with pytest.raises(ValueError, match="expected one key per bin"):
        sa.answer(ka[:-1])
    with pytest.raises(ValueError, match="expected one key per bin"):
        sa.answer_scalar(ka[:-1])
    truncated = list(ka)
    truncated[0] = truncated[0][:100]
    with pytest.raises(ValueError):
        sa.answer(truncated)
    _, _, sq, _, cq = _setup("sqrtn")
    kq, _, _ = cq.make_queries([0])
    bad = list(kq)
    bad[1] = DPF(prf=DPF.PRF_DUMMY, scheme="sqrtn", device="cpu").gen(
        0, 512)[0].numpy()
    with pytest.raises(ValueError, match=r"size-128 group"):
        sq.answer(bad)
    bad = [k.copy() for k in kq]
    bad[1].reshape(-1, 4).view(np.uint32)[2, 0] = 256
    with pytest.raises(ValueError, match=r"bin 1 .*got n=256"):
        sq.answer(bad)


def test_sqrtn_group_rejects_short_keys_cleanly():
    table = np.arange(300 * 4, dtype=np.int32).reshape(300, 4)
    sa = PrivateLookupServer(table, [set(range(100))], prf=DPF.PRF_DUMMY,
                             scheme="sqrtn", device="cpu")
    with pytest.raises(ValueError, match=r"size-128 group .*malformed"):
        sa.answer([np.zeros(8, np.int32)])
    with pytest.raises(ValueError, match=r"size-128 group"):
        sa.answer([np.zeros(6, np.int32)])


def test_auto_scheme_and_bad_constructions():
    table = np.zeros((300, 4), np.int32)
    bins = [set(range(100))]
    # scheme="auto" on a cold tuning cache: every size group resolves to
    # the caller's log-N radix, on the server and the client alike
    srv = PrivateLookupServer(table, bins, scheme="auto", radix=4,
                              device="cpu")
    cli = PrivateLookupClient(bins, [128], scheme="auto", radix=4,
                              entry_size=4, device="cpu")
    assert srv.group_constructions() == cli.group_constructions() == {
        128: ("logn", 4)}
    with pytest.raises(ValueError, match="scheme must be one of"):
        PrivateLookupServer(table, bins, scheme="bogus", device="cpu")
    with pytest.raises(ValueError, match="has no radix"):
        PrivateLookupServer(table, bins, scheme="sqrtn", radix=4,
                            device="cpu")


def test_server_raises_without_a_card(monkeypatch):
    """No CPU route unless device="cpu" was asked for."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PrivateLookupServer(np.zeros((300, 4), np.int32),
                            [set(range(100))])


# -------------------------------------------------------- streaming

@pytest.mark.parametrize("scheme,radix,prf", CONSTRUCTIONS)
def test_lookup_stream_matches_answer(scheme, radix, prf):
    """Rounds through the per-group serving engines equal answer() on
    every round; the counters fold into one."""
    table, opt, sa, sb, cl = _setup(scheme, radix, prf)
    stream = sa.stream(max_in_flight=2, warmup=True)
    rounds, futs = [], []
    for r in range(3):
        wanted = [sorted(b)[min(r, len(b) - 1)]
                  for b in opt.hot_table_bins[:3]]
        ka, kb, plan = cl.make_queries(wanted)
        rounds.append((ka, kb, plan, wanted))
        futs.append(stream.submit(ka))
    stream.drain()
    for (ka, kb, plan, wanted), fut in zip(rounds, futs):
        assert fut.done()
        ans = fut.result()
        assert np.array_equal(ans, sa.answer(ka))
        got = cl.recover(ans, sb.answer(kb), plan)
        for w in wanted:
            assert w in got and (got[w] == table[w]).all()
    stats = stream.stats()
    assert sum(s["batches_submitted"] for s in stats.values()) == 3 * len(
        stats)
    agg = stream.counters()
    assert agg.batches_submitted == 3 * len(stats)
    assert agg.dispatches == sum(s["dispatches"] for s in stats.values())
    with pytest.raises(ValueError, match="expected one key per bin"):
        stream.submit(rounds[0][0][:-1])


def test_lookup_stream_bad_round_leaves_no_orphan_dispatch():
    table = np.arange(300 * 4, dtype=np.int32).reshape(300, 4)
    bins = [set(range(100)), set(range(100, 280))]  # pads 128 and 256
    sa = PrivateLookupServer(table, bins, prf=DPF.PRF_DUMMY, device="cpu")
    cl = PrivateLookupClient(bins, sa.bin_sizes, prf=DPF.PRF_DUMMY)
    assert len(sa._groups) == 2
    stream = sa.stream(warmup=True)
    ka, kb, plan = cl.make_queries([0, 150])
    bad = list(ka)
    bad[1] = DPF(prf=DPF.PRF_DUMMY, device="cpu").gen(0, 512)[0].numpy()
    with pytest.raises(ValueError, match=r"bin 1 .*got n=512"):
        stream.submit(bad)
    assert all(s["batches_submitted"] == 0
               for s in stream.stats().values())
    fut = stream.submit(ka)
    stream.drain()
    assert np.array_equal(fut.result(), sa.answer(ka))


# ------------------------------------------------------------- the mesh

MESHES = {"1x4": (1, 4, 1), "2x4": (2, 4, 1), "1x2x2": (1, 2, 2)}


def _mesh(shape):
    from dpf_tpu_torch.parallel import sharded
    from dpf_tpu_torch.utils.hermetic import force_cpu_mesh
    nb, nt, ny = shape
    devs = force_cpu_mesh(nb * nt * ny)
    if ny > 1:
        return sharded.make_mesh_2d(nt, ny, nb, devices=devs)
    return sharded.make_mesh(nt, nb, devices=devs)


def _jmesh(shape):
    import jax
    from dpf_tpu.parallel import sharded as jsharded
    nb, nt, ny = shape
    devs = jax.devices()
    if ny > 1:
        return jsharded.make_mesh_2d(nt, ny, nb, devices=devs[:nb * nt * ny])
    return jsharded.make_mesh(nt, nb, devices=devs[:nb * nt])


@pytest.mark.parametrize("scheme,radix,prf,meshes", [
    ("logn", 2, DPF.PRF_DUMMY, ("1x4", "2x4", "1x2x2")),
    ("logn", 4, DPF.PRF_CHACHA20, ("1x4", "2x4")),
    ("sqrtn", 2, DPF.PRF_CHACHA20, ("1x4", "2x4")),
])
def test_mesh_matches_dpf_tpu_and_one_device(scheme, radix, prf, meshes):
    """The meshed server's shares equal dpf_tpu's meshed server's and the
    one-device server's on every mesh; 10 bins of one size (G = 10, not a
    multiple of 4 or 8, so zero bins pad each group) and two servers
    recover every planned row; answer == answer_scalar."""
    table, opt, one, _, cl = _setup(scheme, radix, prf, bin_fraction=0.1)
    assert [len(g.idxs) for g in one._groups.values()] == [10]
    wanted = [sorted(b)[1] for b in opt.hot_table_bins[:4]]
    ka, kb, plan = cl.make_queries(wanted)
    want = one.answer(ka)
    for name in meshes:
        srv = PrivateLookupServer(table, opt.hot_table_bins, prf=prf,
                                  radix=radix, scheme=scheme,
                                  mesh=_mesh(MESHES[name]))
        ref = jbp.PrivateLookupServer(table, opt.hot_table_bins, prf=prf,
                                      radix=radix, scheme=scheme,
                                      mesh=_jmesh(MESHES[name]))
        (grp,) = srv._groups.values()
        assert grp.gpad == (-10) % srv.mesh.size
        assert [t.shape[0] for t in grp.tables] == [grp.padded //
                                                    srv.mesh.size] * \
            srv.mesh.size
        got = srv.answer(ka)
        assert np.array_equal(got, want), name
        assert np.array_equal(got, np.asarray(ref.answer(ka))), name
        assert np.array_equal(got, srv.answer_scalar(ka)), name
        rows = cl.recover(got, srv.answer(kb), plan)
        for w in wanted:
            assert (rows[w] == table[w]).all(), (name, w)


def test_mesh_two_size_groups_and_more_entries_than_bins():
    """Two size groups (G = 1 and 2) over 4 entries: entries past the
    last bin evaluate the last key against zero tables; equal to
    dpf_tpu's meshed server and to the one-device server."""
    table = np.arange(300 * 4, dtype=np.int32).reshape(300, 4)
    bins = [set(range(100)), set(range(100, 280)), set(range(280, 300))]
    one = PrivateLookupServer(table, bins, prf=DPF.PRF_SALSA20,
                              device="cpu")
    srv = PrivateLookupServer(table, bins, prf=DPF.PRF_SALSA20,
                              mesh=_mesh(MESHES["1x4"]))
    ref = jbp.PrivateLookupServer(table, bins, prf=DPF.PRF_SALSA20,
                                  mesh=_jmesh(MESHES["1x4"]))
    assert {n: (len(g.idxs), g.gpad) for n, g in srv._groups.items()} == {
        128: (2, 2), 256: (1, 3)}
    assert srv._shard_spans(srv._groups[256]) == [(0, 1)] * 4
    cl = PrivateLookupClient(bins, one.bin_sizes, prf=DPF.PRF_SALSA20)
    ka, kb, plan = cl.make_queries([5, 150, 290])
    got = srv.answer(ka)
    assert np.array_equal(got, one.answer(ka))
    assert np.array_equal(got, np.asarray(ref.answer(ka)))
    assert np.array_equal(got, srv.answer_scalar(ka))
    rows = cl.recover(got, srv.answer(kb), plan)
    assert all((rows[w] == table[w]).all() for w in (5, 150, 290))


@pytest.mark.parametrize("scheme,radix,prf", CONSTRUCTIONS)
def test_mesh_lookup_stream_matches_answer(scheme, radix, prf):
    """Rounds through the meshed server's stream (each engine's bucket
    the group's mesh-padded size) equal its answer() and recover."""
    table, opt, one, _, cl = _setup(scheme, radix, prf, bin_fraction=0.1)
    srv = PrivateLookupServer(table, opt.hot_table_bins, prf=prf,
                              radix=radix, scheme=scheme,
                              mesh=_mesh(MESHES["2x4"]))
    stream = srv.stream(max_in_flight=2, warmup=True)
    assert [eng.buckets.sizes for _, _, eng in stream._engines] == [(16,)]
    rounds = []
    for r in range(3):
        wanted = [sorted(b)[r] for b in opt.hot_table_bins[:3]]
        ka, kb, plan = cl.make_queries(wanted)
        rounds.append((ka, kb, plan, wanted, stream.submit(ka)))
    stream.drain()
    for ka, kb, plan, wanted, fut in rounds:
        ans = fut.result()
        assert np.array_equal(ans, srv.answer(ka))
        assert np.array_equal(ans, one.answer(ka))
        rows = cl.recover(ans, one.answer(kb), plan)
        assert all((rows[w] == table[w]).all() for w in wanted)


def test_mesh_group_knobs_fall_back_to_the_mesh_entry(tmp_path,
                                                      monkeypatch):
    """A meshed server reads the mesh-tuned entry of its split when the
    one-device entry is absent, prefers the one-device entry when both
    exist, and clamps against each entry's keys; a server without a
    mesh never reads the mesh entry."""
    from dpf_tpu_torch.tune import cache as tcache
    from dpf_tpu_torch.tune.fingerprint import cache_key
    monkeypatch.setenv("DPF_TPU_TORCH_TUNE_CACHE", str(tmp_path / "t.json"))
    tcache.default_cache(refresh=True)
    table = np.arange(128 * 4, dtype=np.int32).reshape(128, 4)
    bins = [list(range(i * 16, (i + 1) * 16)) for i in range(8)]
    shape = dict(n=128, entry_size=4, batch=8, prf_method=0,
                 scheme="logn", radix=2, device=torch.device("cpu"))
    tcache.default_cache().store(
        cache_key("mesh", mesh="2x4", **shape),
        {"knobs": {"chunk_leaves": 32, "psum_group": 1}})
    tcache.default_cache(refresh=True)
    srv = PrivateLookupServer(table, bins, prf=0, mesh=_mesh(MESHES["2x4"]))
    assert srv._group_knobs(128, 8, "logn", 2) == {"chunk_leaves": 32}
    one = PrivateLookupServer(table, bins, prf=0, device="cpu")
    assert one._group_knobs(128, 8, "logn", 2) == {"chunk_leaves": 128}
    tcache.default_cache().store(cache_key("eval", **shape),
                                 {"knobs": {"chunk_leaves": 64}})
    tcache.default_cache(refresh=True)
    srv = PrivateLookupServer(table, bins, prf=0, mesh=_mesh(MESHES["2x4"]))
    assert srv._group_knobs(128, 8, "logn", 2) == {"chunk_leaves": 64}
    cl = PrivateLookupClient(bins, srv.bin_sizes, prf=0)
    ka, _, _ = cl.make_queries([3, 40])
    assert np.array_equal(srv.answer(ka), one.answer(ka))


def test_mesh_rejects_ranks_and_a_device():
    table = np.zeros((300, 4), np.int32)
    bins = [set(range(100))]
    mesh = _mesh(MESHES["1x4"])
    with pytest.raises(ValueError, match="mesh= or device="):
        PrivateLookupServer(table, bins, mesh=mesh, device="cpu")
    mesh.ranks = np.zeros(mesh.devices.shape, dtype=int)
    mesh.rank = 0
    with pytest.raises(ValueError, match="spans processes"):
        PrivateLookupServer(table, bins, mesh=mesh)
