"""The port's radix-4 (mixed-radix) GGM path against dpf_tpu's, on the CPU.

Every comparison is bit for bit: wire words, packed codewords, PRF
outputs, level children (mod 2^128) and server shares (mod 2^32).
Inputs come from numpy seeds and are handed to both packages.  The tests
that launch the CUDA kernels need a card and skip without one.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import dpf_tpu
import dpf_tpu_torch
from dpf_tpu.core import prf as jprf
from dpf_tpu.core import radix4 as jr4
from dpf_tpu.ops import aes_planes
from dpf_tpu.utils.compat import has_tpu_interpret_mode
from dpf_tpu.utils.config import EvalConfig as JaxEvalConfig
from dpf_tpu_torch import interop
from dpf_tpu_torch.core import expand, prf, radix4
from dpf_tpu_torch.core.u32 import from_u32, to_u32
from dpf_tpu_torch.ops import aes_level, subtree
from dpf_tpu_torch.utils.config import EvalConfig


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch's CPU ops on one thread here: the suite runs several worker
    processes side by side, and an oversubscribed host stalls the other
    workers' timing-sensitive tests."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rand_u32(rng, *shape):
    return rng.integers(0, 2 ** 32, shape, dtype=np.uint64).astype(np.uint32)


def _table(n, e=16, seed=0):
    return np.random.default_rng(seed).integers(
        -2 ** 31, 2 ** 31, (n, e), dtype=np.int64).astype(np.int32)


def _mixed_keys(n, count, method, seed=b"r4"):
    """dpf_tpu's radix-4 keys, alternating servers, as wire words."""
    return np.stack([jr4.generate_keys_r4((i * 131 + 7) % n, n,
                                          seed + b"%d" % i, method)[i % 2]
                     .serialize() for i in range(count)])


def _device_keys(wire):
    pk = radix4.decode_mixed_keys_batched(wire)
    return [from_u32(a) for a in (pk.cw1, pk.cw2, pk.last)]


def _radix4_dpf(method, **kw):
    return dpf_tpu_torch.DPF(config=EvalConfig(radix=4, prf_method=method,
                                               **kw), device="cpu")


def test_schedule_helpers_match_dpf_tpu():
    for depth in range(1, 17):
        n = 1 << depth
        ars = radix4.arities(n)
        assert ars == jr4.arities(n)
        assert radix4.cw_offsets(ars) == jr4.cw_offsets(ars)
        assert (radix4.mixed_reverse_indices(ars)
                == jr4.mixed_reverse_indices(ars)).all()
        for target in (1, 4, 64, 4096, n):
            assert radix4._suffix_chunk(ars, target) == \
                jr4._suffix_chunk(ars, target)


@pytest.mark.parametrize("method", range(6))
@pytest.mark.parametrize("n", [1 << 7, 1 << 10])
def test_generate_keys_r4_matches_dpf_tpu(method, n):
    for alpha in (0, n - 1, (n * 5) // 7):
        seed = b"wire-%d-%d" % (method, alpha)
        ours = radix4.generate_keys_r4(alpha, n, seed, method)
        theirs = jr4.generate_keys_r4(alpha, n, seed, method)
        for o, t in zip(ours, theirs):
            assert (o.serialize() == t.serialize()).all()
        got = radix4.evaluate_mixed(ours[0], alpha, method)
        other = radix4.evaluate_mixed(ours[1], alpha, method)
        assert (got - other) % (1 << 128) == 1
        assert got == jr4.evaluate_mixed(theirs[0], alpha, method)


def test_decode_mixed_keys_batched_and_rejections():
    n = 1 << 9
    wire = _mixed_keys(n, 5, 2)
    pk = radix4.decode_mixed_keys_batched(wire)
    want = jr4.decode_mixed_keys_batched(wire)
    for f in ("cw1", "cw2", "last"):
        assert (getattr(pk, f) == getattr(want, f)).all()
    assert (pk.n, pk.depth, pk.batch) == (n, 9, 5)
    mk = [radix4.deserialize_mixed_key(torch.from_numpy(k)) for k in wire]
    cw1, cw2, last = radix4.pack_mixed_keys(mk)
    assert (cw1 == pk.cw1).all() and (last == pk.last).all()
    assert radix4.is_mixed_key(wire[0])
    binary = dpf_tpu_torch.DPF(prf=2, device="cpu").gen(3, n, seed=b"b")[0]
    assert not radix4.is_mixed_key(binary)
    with pytest.raises(ValueError, match="not a mixed-radix key"):
        radix4.decode_mixed_keys_batched([wire[0], binary.numpy()])
    other_n = jr4.generate_keys_r4(1, 256, b"o", 2)[0].serialize()
    with pytest.raises(ValueError, match="mixed table sizes"):
        radix4.decode_mixed_keys_batched([wire[0], other_n])
    bad = wire[0].copy()
    bad[2] = 0                                   # binary-level count
    with pytest.raises(ValueError, match="inconsistent"):
        radix4.decode_mixed_keys_batched([bad])
    with pytest.raises(ValueError, match="inconsistent"):
        radix4.deserialize_mixed_key(bad)
    with pytest.raises(ValueError, match="524"):
        radix4.decode_mixed_keys_batched([wire[0][:520]])


@pytest.mark.parametrize("method", range(6))
@pytest.mark.parametrize("arity", [2, 4])
def test_prf_multi_matches_dpf_tpu(method, arity):
    seeds = _rand_u32(np.random.default_rng(method + arity), 3, 5, 4)
    got = prf.prf_multi(method, from_u32(seeds), arity)
    want = jprf.prf_multi(method, seeds if method != 3 else
                          jnp.asarray(seeds), arity)
    assert len(got) == len(want) == arity
    for g, w in zip(got, want):
        assert (to_u32(g) == np.asarray(w)).all()


def test_plain_aes_level_arity4_matches_aes_level_step_ref():
    rng = np.random.default_rng(11)
    seeds = _rand_u32(rng, 32, 2, 4)              # one 32-key tile
    cw1, cw2 = _rand_u32(rng, 32, 4, 4), _rand_u32(rng, 32, 4, 4)
    want = np.asarray(aes_planes.aes_level_step_ref(
        jnp.asarray(seeds), jnp.asarray(cw1), jnp.asarray(cw2), arity=4))
    args = [from_u32(x) for x in (seeds, cw1, cw2)]
    assert (to_u32(aes_level.aes_level_step_plain(*args, 4)) == want).all()
    # the wrapper takes the plain version for CPU tensors
    assert (to_u32(aes_level.aes_level_step(*args, arity=4)) == want).all()
    with pytest.raises(ValueError, match="arity"):
        aes_level.aes_level_step(*args, arity=3)
    with pytest.raises(ValueError, match=r"\[B, 2, 4\]"):
        aes_level.aes_level_step(*args)


@pytest.mark.parametrize("method,depth", [(1, 9), (2, 10), (4, 10), (5, 9)])
def test_plain_subtree_mixed_matches_xla_expand_and_contract(method, depth):
    """A frontier from dpf_tpu's first mixed level (f_lv = 1), the port's
    plain mixed subtree contraction over it at several block sizes,
    against the JAX XLA path end to end."""
    n = 1 << depth
    wire = _mixed_keys(n, 3, method)
    pk = jr4.decode_mixed_keys_batched(wire)
    table = _table(n, 5, seed=method)
    ars = jr4.arities(n)
    tperm = table[jr4.mixed_reverse_indices(ars)]
    want = np.asarray(jr4.expand_and_contract_mixed(
        pk.cw1, pk.cw2, pk.last, jnp.asarray(tperm), n=n,
        prf_method=method, chunk_leaves=64))
    a0 = ars[0]
    frontier = jr4._level_step_mixed(pk.last[:, None, :], pk.cw1[:, :a0],
                                     pk.cw2[:, :a0], method, a0)
    args = [from_u32(x) for x in (frontier, pk.cw1, pk.cw2)]
    tp = torch.from_numpy(tperm)
    for block in (None, 16, 64, n // a0):
        got = subtree.subtree_contract_mixed_plain(
            *args, tp, ars=ars, f_lv=1, prf_method=method,
            block_leaves=block)
        assert (got.numpy() == want).all(), block
    got = subtree.subtree_contract_mixed(*args, tp, ars=ars, f_lv=1,
                                         prf_method=method)
    assert (got.numpy() == want).all()
    # from the root, as the server drives it
    cw1, cw2, last = _device_keys(wire)
    got = radix4.expand_and_contract_mixed(cw1, cw2, last, tp, n=n,
                                           prf_method=method,
                                           chunk_leaves=None)
    assert (got.numpy() == want).all()


@pytest.mark.parametrize("method", [1, 5])
def test_plain_subtree_mixed_matches_pallas_interpret(method):
    if not has_tpu_interpret_mode():
        pytest.skip("pltpu.force_tpu_interpret_mode unavailable "
                    "(jax >= 0.4.38)")
    from jax.experimental.pallas import tpu as pltpu
    n = 256
    wire = _mixed_keys(n, 2, method, seed=b"pal")
    pk = jr4.decode_mixed_keys_batched(wire)
    tperm = _table(n, 16, seed=5)[jr4.mixed_reverse_indices(jr4.arities(n))]
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jr4.expand_and_contract_mixed_pallas(
            pk.cw1, pk.cw2, pk.last, jnp.asarray(tperm), n=n,
            prf_method=method, interpret=True))
    cw1, cw2, last = _device_keys(wire)
    got = radix4.expand_and_contract_mixed(
        cw1, cw2, last, torch.from_numpy(tperm), n=n, prf_method=method,
        chunk_leaves=None)
    assert (got.numpy() == want).all()


def test_subtree_mixed_wrapper_rejects_bad_input():
    z = torch.zeros
    ars = (4, 4, 4, 4)
    fr, cw = z(2, 1, 4, dtype=torch.int32), z(2, 64, 4, dtype=torch.int32)
    tb = z(256, 4, dtype=torch.int32)
    kw = dict(ars=ars, f_lv=0, prf_method=2)
    with pytest.raises(ValueError, match="PRF"):
        subtree.subtree_contract_mixed(fr, cw, cw, tb, ars=ars, f_lv=0,
                                       prf_method=3)
    with pytest.raises(ValueError, match="block_leaves"):
        subtree.subtree_contract_mixed(fr, cw, cw, tb, block_leaves=8, **kw)
    with pytest.raises(ValueError, match="match arities"):
        subtree.subtree_contract_mixed(fr, cw, cw, tb[:128], **kw)
    with pytest.raises(ValueError, match="f_lv"):
        subtree.subtree_contract_mixed(fr, cw, cw, tb, ars=ars, f_lv=4,
                                       prf_method=2)
    with pytest.raises(ValueError, match="contiguous"):
        subtree.subtree_contract_mixed(fr, cw, cw, z(4, 256,
                                                     dtype=torch.int32).t(),
                                       **kw)


@pytest.mark.parametrize("method", [0, 3])
def test_grouped_mixed_routes(method, monkeypatch):
    """AES (K1 per level at the level's arity) and DUMMY (plain mixed
    steps) over frontier groups, with several groups forced, against
    dpf_tpu's host one-hot expansion times the table."""
    n = 1 << 9
    wire = _mixed_keys(n, 3, method, seed=b"grp")
    pk = jr4.decode_mixed_keys_batched(wire)
    table = _table(n, 3, seed=8)
    tperm = table[jr4.mixed_reverse_indices(jr4.arities(n))]
    hots = jr4.expand_leaves_mixed(pk.cw1, pk.cw2, pk.last, n=n,
                                   prf_method=method)
    want = (hots.view(np.uint32) @ table.view(np.uint32)).view(np.int32)
    cw1, cw2, last = _device_keys(wire)
    tp = torch.from_numpy(tperm)
    for groups, chunk in ((1, 64), (2, 64), (4, 32), (1, None)):
        monkeypatch.setattr(expand, "choose_group", lambda f, c, g=groups: g)
        got = radix4.expand_and_contract_mixed(cw1, cw2, last, tp, n=n,
                                               prf_method=method,
                                               chunk_leaves=chunk)
        assert (got.numpy() == want).all(), (groups, chunk)


@pytest.mark.parametrize("method", range(6))
@pytest.mark.parametrize("n", [1 << 9, 1 << 10])
def test_radix4_server_matches_dpf_tpu(method, n):
    """The port's radix-4 server, 4 keys per dispatch over 6 keys, against
    dpf_tpu's jitted radix-4 server and its host oracle."""
    table = _table(n, seed=method + n)
    idx = [0, 5, n - 1, n // 3, 77, n // 2 + 3]
    ours = _radix4_dpf(method, batch_size=4)
    ours.eval_init(torch.from_numpy(table))
    theirs = dpf_tpu.DPF(config=JaxEvalConfig(radix=4, prf_method=method))
    theirs.eval_init(table)
    pairs = [ours.gen(i, n, seed=b"srv%d" % i) for i in idx]
    ka, kb = [p[0] for p in pairs], [p[1] for p in pairs]
    sa, sb = ours.eval_gpu(ka), ours.eval_gpu(kb)
    assert sa.dtype == torch.int32 and tuple(sa.shape) == (6, 16)
    assert ((sa - sb).numpy() == table[idx]).all()
    jka = [k.numpy() for k in ka]
    assert (sa.numpy() == np.asarray(theirs.eval_tpu(jka))).all()
    assert (sa.numpy() == np.asarray(theirs.eval_cpu(jka))).all()
    assert torch.equal(sa, ours.eval_cpu(ka))
    assert all((k.numpy() == theirs.gen(i, n, seed=b"srv%d" % i)[0].numpy())
               .all() for i, k in zip(idx, ka))


@pytest.mark.parametrize("method", [2, 3])
def test_radix4_one_hot_points_and_eval_cpu_match_dpf_tpu(method):
    n = 256
    d = _radix4_dpf(method)
    theirs = dpf_tpu.DPF(config=JaxEvalConfig(radix=4, prf_method=method))
    ka, kb = d.gen(99, n, seed=b"oh")
    hot = d.eval_one_hot([ka, kb])
    jkeys = [ka.numpy(), kb.numpy()]
    want = np.asarray(theirs.eval_cpu(jkeys, one_hot_only=True))
    assert (hot.numpy() == want).all()
    # dpf_tpu's eval_one_hot is expand_leaves_mixed on device arrays; the
    # same function on host arrays gives its bits without the eager cost
    pk = jr4.decode_mixed_keys_batched(jkeys)
    assert (np.asarray(jr4.expand_leaves_mixed(
        pk.cw1, pk.cw2, pk.last, n=n, prf_method=method)) == want).all()
    assert torch.equal(hot, d.eval_cpu([ka, kb], one_hot_only=True))
    assert ((hot[0] - hot[1]).numpy() == (np.arange(n) == 99)).all()
    pts = [0, 98, 99, 255, 17]
    got = d.eval_points([ka, kb], pts).numpy()
    assert (got == want[:, pts]).all()
    mk = [jr4.deserialize_mixed_key(k) for k in jkeys]
    assert (got.view(np.uint32) == [[jr4.evaluate_mixed(k, p, method)
                                     & 0xFFFFFFFF for p in pts]
                                    for k in mk]).all()
    with pytest.raises(ValueError, match="indices"):
        d.eval_points([ka], [n])
    table = _table(n, 4, seed=3)
    d.eval_init(table)
    theirs.eval_init(table)
    assert (d.eval_cpu([ka, kb]).numpy()
            == np.asarray(theirs.eval_cpu(jkeys))).all()


@pytest.mark.parametrize("method", [3, 5])
def test_radix4_keys_cross_packages_and_constructions(method):
    n = 512
    table = _table(n, 4, seed=9)
    ours = _radix4_dpf(method)
    ours.eval_init(table)
    theirs = dpf_tpu.DPF(config=JaxEvalConfig(radix=4, prf_method=method))
    theirs.eval_init(table)
    ja, jb = theirs.gen(200, n, seed=b"j")        # minted by dpf_tpu
    rec = ours.eval_gpu([ja]) - ours.eval_gpu([jb])
    assert (rec.numpy() == table[200]).all()
    oa, ob = ours.gen(17, n, seed=b"o")            # minted by the port
    assert ((np.asarray(theirs.eval_cpu([oa.numpy()]))
             - np.asarray(theirs.eval_cpu([ob.numpy()]))) == table[17]).all()
    # a radix-4 key sent to a binary server raises, and the reverse
    binary = dpf_tpu_torch.DPF(prf=method, device="cpu")
    binary.eval_init(table)
    for call in (binary.eval_gpu, binary.eval_one_hot, binary.eval_cpu):
        with pytest.raises(ValueError, match="mixed-radix"):
            call([oa])
    bk = binary.gen(17, n, seed=b"b")[0]
    for call in (ours.eval_gpu, ours.eval_one_hot, ours.eval_cpu):
        with pytest.raises(ValueError, match="not a mixed-radix key"):
            call([bk])
    with pytest.raises(ValueError, match="n=1024"):
        ours.eval_gpu([ours.gen(3, 1024, seed=b"w")[0]])


def test_radix4_knobs_and_construction_checks():
    d = _radix4_dpf(2)
    d.eval_init(_table(1 << 13, 2))
    assert "radix=4" in repr(d)
    assert d.resolved_eval_knobs(512) == {
        "chunk_leaves": 4096, "kernel": "subtree_contract_mixed",
        "kernel_impl": "fused", "dispatch_group": None,
        "kernel_resolved_from": "heuristic", "dot_impl": "i32"}
    a = _radix4_dpf(3)
    a.eval_init(_table(1 << 12, 2))
    assert a.resolved_eval_knobs(512)["kernel"] == "aes_level_step_a4"
    assert a.resolved_eval_knobs(512)["chunk_leaves"] == 4096
    # the binary chunk 2^11 of a 2^12 table is rounded down to 4^5
    assert a.resolved_eval_knobs(2048)["chunk_leaves"] == 1024


@pytest.mark.parametrize("method", [0, 4])
def test_interop_state_with_radix4_keys(method):
    n = 512
    table = _table(n, 16, seed=12)
    wire = _mixed_keys(n, 3, method, seed=b"io")
    st = interop.state_from_numpy(table, wire, device="cpu")
    assert st.radix == 4
    tperm = table[jr4.mixed_reverse_indices(jr4.arities(n))]
    assert (st.table_perm.numpy() == tperm).all()
    got = radix4.expand_and_contract_mixed(st.cw1, st.cw2, st.last,
                                           st.table_perm, n=n,
                                           prf_method=method,
                                           chunk_leaves=None)
    pk = jr4.decode_mixed_keys_batched(wire)
    want = np.asarray(jr4.expand_and_contract_mixed(
        pk.cw1, pk.cw2, pk.last, jnp.asarray(tperm), n=n,
        prf_method=method, chunk_leaves=None))
    assert (got.numpy() == want).all()
    with pytest.raises(ValueError, match="rows"):
        interop.state_from_numpy(table[:256], wire, device="cpu")


def test_bench_with_radix4_config():
    from dpf_tpu_torch.utils import bench
    r = bench.test_dpf_perf(N=256, batch=4, entrysize=2, prf=5, reps=1,
                            keys_distinct=2, check=True, quiet=True,
                            config=EvalConfig(radix=4), device="cpu")
    assert r["checked"] and r["radix"] == 4 and r["prf"] == "CHACHA20_BLK"


def test_cuda_radix4_kernels_match_plain_versions():
    """On a card: K1 at arity 4 and the mixed K2 bit-equal to their plain
    versions, and their launch counters moved."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    g = torch.Generator(device="cuda").manual_seed(2)

    def rnd(*shape):
        return torch.randint(-2 ** 31, 2 ** 31, shape, dtype=torch.int64,
                             device="cuda", generator=g).to(torch.int32)

    before = (aes_level.aes_level_step.launches_a4,
              subtree.subtree_contract_mixed.launches)
    seeds, cw1, cw2 = rnd(33, 70, 4), rnd(33, 64, 4), rnd(33, 64, 4)
    assert torch.equal(
        aes_level.aes_level_step(seeds, cw1[:, 4:8], cw2[:, 4:8], arity=4),
        aes_level.aes_level_step_plain(seeds, cw1[:, 4:8], cw2[:, 4:8], 4))
    ars = radix4.arities(1 << 13)
    for method in subtree.SUBTREE_PRFS:
        fr, tbl = rnd(3, 2, 4), rnd(1 << 13, 16)
        kw = dict(ars=ars, f_lv=1, prf_method=method, block_leaves=256)
        assert torch.equal(
            subtree.subtree_contract_mixed(fr, cw1[:3], cw2[:3], tbl, **kw),
            subtree.subtree_contract_mixed_plain(fr, cw1[:3], cw2[:3], tbl,
                                                 **kw))
    after = (aes_level.aes_level_step.launches_a4,
             subtree.subtree_contract_mixed.launches)
    assert [x - y for x, y in zip(after, before)] == [1, 4]
