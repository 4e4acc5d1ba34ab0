"""The port's DPF API against dpf_tpu's, on the CPU (``device="cpu"``).

Shares must be bit-identical to ``dpf_tpu``'s for every PRF id, keys
minted by either package must serve on the other, and the client must
recover table rows exactly.
"""

import numpy as np
import pytest
import torch

import dpf_tpu
import dpf_tpu_torch
from dpf_tpu.core import expand as jexpand
from dpf_tpu.core import keygen as jkeygen
from dpf_tpu_torch import interop
from dpf_tpu_torch.core import expand
from dpf_tpu_torch.utils import bench
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


def _table(n, e=16, seed=0):
    return np.random.default_rng(seed).integers(
        -2 ** 31, 2 ** 31, (n, e), dtype=np.int64).astype(np.int32)


def _pairs(d, n, idx, tag=b"api"):
    return [d.gen(i, n, seed=tag + b"%d" % i) for i in idx]


@pytest.mark.parametrize("method", range(6))
@pytest.mark.parametrize("n", [128, 1024])
def test_round_trip_matches_dpf_tpu(method, n):
    table = _table(n, seed=method)
    idx = [0, 3, n // 2 + 1, n - 1]
    ours = dpf_tpu_torch.DPF(prf=method, device="cpu")
    ours.eval_init(torch.from_numpy(table))
    theirs = dpf_tpu.DPF(prf=method)
    theirs.eval_init(table)
    pairs = _pairs(ours, n, idx)
    ka, kb = [p[0] for p in pairs], [p[1] for p in pairs]
    sa, sb = ours.eval_gpu(ka), ours.eval_gpu(kb)
    assert sa.dtype == torch.int32 and tuple(sa.shape) == (4, 16)
    assert ((sa - sb).numpy() == table[idx]).all()
    assert torch.equal(sa, ours.eval_cpu(ka))
    jka = [k.numpy() for k in ka]
    assert (sa.numpy() == np.asarray(theirs.eval_cpu(jka))).all()
    if n == 128:  # the jitted JAX server (one XLA compile per PRF id)
        assert (sa.numpy() == np.asarray(theirs.eval_tpu(jka))).all()
    # the same wire keys from the same seed
    assert all((k.numpy() == theirs.gen(i, n, seed=b"api%d" % i)[0].numpy())
               .all() for i, k in zip(idx, ka))


@pytest.mark.parametrize("radix", [2, 4])
@pytest.mark.parametrize("method", [0, 3])
def test_grouped_servers_match_dpf_tpu(method, radix, monkeypatch):
    """AES and DUMMY servers whose batch runs over several frontier
    groups (chunk and group forced small): every group hands K3 a
    contiguous plane of low limbs; the shares equal dpf_tpu's jitted
    server's."""
    from dpf_tpu.utils.config import EvalConfig as JaxEvalConfig
    from dpf_tpu_torch.ops import matmul128
    n = 256
    table = _table(n, 3, seed=20 + method + radix)
    monkeypatch.setattr(expand, "clamp_chunk", lambda chunk, n, batch: 32)
    monkeypatch.setattr(expand, "choose_group", lambda f, c: 2)
    calls = []
    dot = matmul128.dot_i32

    def counted(a, b):
        calls.append((tuple(a.shape), a.is_contiguous()))
        return dot(a, b)

    monkeypatch.setattr(matmul128, "dot_i32", counted)
    ours = dpf_tpu_torch.DPF(config=EvalConfig(radix=radix,
                                               prf_method=method),
                             device="cpu")
    ours.eval_init(torch.from_numpy(table))
    theirs = dpf_tpu.DPF(config=JaxEvalConfig(radix=radix,
                                              prf_method=method))
    theirs.eval_init(table)
    idx = [0, 77, 130, n - 1]
    pairs = _pairs(ours, n, idx, tag=b"grp")
    ka, kb = [p[0] for p in pairs], [p[1] for p in pairs]
    sa = ours.eval_gpu(ka)
    # binary: 8 subtrees of 32 leaves; radix-4: 16 of 16, 2 to a group
    if radix == 2:
        assert calls == [((4, 64), True)] * 4
    else:
        assert calls == [((4, 32), True)] * 8
    assert ((sa - ours.eval_gpu(kb)).numpy() == table[idx]).all()
    assert (sa.numpy() == np.asarray(theirs.eval_tpu(
        [k.numpy() for k in ka]))).all()


@pytest.mark.parametrize("method", [2, 3])
def test_keys_cross_packages(method):
    n = 256
    table = _table(n, 4, seed=9)
    ours = dpf_tpu_torch.DPF(prf=method, device="cpu")
    ours.eval_init(table)
    theirs = dpf_tpu.DPF(prf=method)
    theirs.eval_init(table)
    ja, jb = theirs.gen(200, n, seed=b"j")        # minted by dpf_tpu
    rec = ours.eval_gpu([ja]) - ours.eval_gpu([jb])
    assert (rec.numpy() == table[200]).all()
    oa, ob = ours.gen(17, n, seed=b"o")            # minted by the port
    got = np.asarray(theirs.eval_cpu([oa.numpy()]))
    assert (got == ours.eval_gpu([oa]).numpy()).all()
    assert ((np.asarray(theirs.eval_cpu([oa.numpy()]))
             - np.asarray(theirs.eval_cpu([ob.numpy()]))) == table[17]).all()


@pytest.mark.parametrize("method", [1, 3])
def test_one_hot_and_points_match_dpf_tpu(method):
    n = 256
    d = dpf_tpu_torch.DPF(prf=method, device="cpu")
    theirs = dpf_tpu.DPF(prf=method)
    ka, kb = d.gen(99, n, seed=b"oh")
    hot = d.eval_one_hot([ka, kb])
    want = np.asarray(theirs.eval_cpu([ka.numpy(), kb.numpy()],
                                      one_hot_only=True))
    assert (hot.numpy() == want).all()
    assert torch.equal(hot, d.eval_cpu([ka, kb], one_hot_only=True))
    assert ((hot[0] - hot[1]).numpy() == (np.arange(n) == 99)).all()
    pts = [0, 98, 99, 255]
    assert (d.eval_points([ka, kb], pts).numpy() == want[:, pts]).all()
    with pytest.raises(ValueError, match="indices"):
        d.eval_points([ka], [n])


def test_padding_rules_and_rejections():
    n_real = 200
    table = _table(n_real, 3, seed=4)
    loose = dpf_tpu_torch.DPF(prf=0, strict=False, device="cpu")
    loose.eval_init(table)
    assert loose.table_num_entries == 256
    ka, kb = loose.gen(150, n_real, seed=b"pad")
    assert ((loose.eval_gpu([ka]) - loose.eval_gpu([kb])).numpy()
            == table[150]).all()
    strict = dpf_tpu_torch.DPF(prf=0, device="cpu")
    with pytest.raises(ValueError, match="power of two"):
        strict.eval_init(table)
    with pytest.raises(ValueError, match="power of two"):
        strict.gen(3, n_real)
    with pytest.raises(ValueError, match="at least"):
        strict.eval_init(_table(64))
    with pytest.raises(ValueError, match="entry dimension"):
        strict.eval_init(_table(128, 17))
    with pytest.raises(ValueError, match="less than n"):
        strict.gen(128, 128)
    with pytest.raises(RuntimeError, match="eval_init"):
        strict.eval_gpu([ka])
    strict.eval_init(_table(128))
    with pytest.raises(ValueError, match="n=256"):
        strict.eval_gpu([ka])                      # key for a wrong n
    good = strict.gen(5, 128, seed=b"g")[0]
    with pytest.raises(ValueError, match="524"):
        strict.eval_gpu([good[:523]])              # malformed key
    with pytest.raises(ValueError, match="empty"):
        strict.eval_gpu([])
    strict.eval_free()
    assert strict.table_device is None


def test_more_keys_than_batch_size():
    n = 128
    table = _table(n, 5, seed=6)
    d = dpf_tpu_torch.DPF(config=EvalConfig(prf_method=2, batch_size=4),
                          device="cpu")
    d.eval_init(table)
    idx = list(range(3, 13))
    pairs = _pairs(d, n, idx, tag=b"many")
    sa = d.eval_gpu([p[0] for p in pairs])
    sb = d.eval_gpu(np.stack([p[1].numpy() for p in pairs]))
    assert tuple(sa.shape) == (10, 5)
    assert ((sa - sb).numpy() == table[idx]).all()
    assert torch.equal(sa, d.eval_cpu([p[0] for p in pairs]))
    assert d.eval_tpu is not None and d.resolved_eval_knobs(4) == {
        "chunk_leaves": 128, "kernel": "subtree_contract",
        "kernel_impl": "fused", "dispatch_group": None,
        "kernel_resolved_from": "heuristic"}


def test_unported_constructions_raise():
    sq = dpf_tpu_torch.DPF(scheme="sqrtn", device="cpu")
    assert sq.scheme == "sqrtn" and sq.radix == 2
    with pytest.raises(ValueError, match="no radix"):
        dpf_tpu_torch.DPF(scheme="sqrtn", config=EvalConfig(radix=4),
                          device="cpu")
    radix4 = dpf_tpu_torch.DPF(config=EvalConfig(radix=4), device="cpu")
    assert radix4.radix == 4 and radix4.prf_method == dpf_tpu_torch.PRF_AES128
    with pytest.raises(ValueError, match="radix"):
        dpf_tpu_torch.DPF(config=EvalConfig(radix=8), device="cpu")
    with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
        dpf_tpu_torch.DPF(scheme="auto", device="cpu")
    with pytest.raises(ValueError):
        dpf_tpu_torch.DPF(scheme="bogus", device="cpu")
    ka, kb = dpf_tpu_torch.DPF(device="cpu").gen([1, 2], 128)
    assert ka.shape == kb.shape == (2, 524)
    assert ka.dtype == kb.dtype == torch.int32


def test_default_device_is_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dpf_tpu_torch.DPF()
    with pytest.raises(RuntimeError, match="CUDA"):
        dpf_tpu_torch.DPF(prf=2, device="cuda")
    assert dpf_tpu_torch.DPF(device="cpu").device.type == "cpu"


@pytest.mark.parametrize("method", [0, 2])
def test_interop_state_matches_jax_expand(method):
    n = 128
    table = _table(n, 16, seed=12)
    flat = [jkeygen.generate_keys(i * 5, n, b"io%d" % i,
                                   method)[i % 2]
            for i in range(3)]
    wire = np.stack([k.serialize() for k in flat])
    st = interop.state_from_numpy(table, wire, device="cpu")
    got = expand.expand_and_contract(st.cw1, st.cw2, st.last, st.table_perm,
                                     depth=st.depth, prf_method=method,
                                     chunk_leaves=32)
    cw1, cw2, last = jexpand.pack_keys(flat)
    want = np.asarray(jexpand.expand_and_contract(
        cw1, cw2, last, jexpand.permute_table(table), depth=7,
        prf_method=method, chunk_leaves=128))
    assert (got.numpy() == want).all()
    with pytest.raises(ValueError, match="rows"):
        interop.state_from_numpy(table[:64], wire, device="cpu")


def test_bench_and_sample_on_cpu(capsys):
    r = bench.test_dpf_perf(N=128, batch=4, entrysize=2, prf=2, reps=1,
                            keys_distinct=2, check=True, quiet=True,
                            device="cpu")
    assert r["checked"] and r["device"] == "cpu" and r["dpfs_per_sec"] > 0
    from dpf_tpu_torch import sample
    sample.client(device="cpu")
    assert "Recovered table[42]" in capsys.readouterr().out
