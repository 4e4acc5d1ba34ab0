"""The port's mesh path against dpf_tpu's, on CPU devices.

``dpf_tpu_torch.parallel.sharded.ShardedDPFServer`` on meshes of CPU
devices (1 x 4, 2 x 2, 4 x 2 and the 2D 2 x 2 rows x bytes mesh) must
give shares bit-equal to ``dpf_tpu``'s ``ShardedDPFServer`` on the
matching mesh of the 8 forced JAX CPU devices (``tests/conftest.py``),
and to ``dpf_tpu``'s scalar oracle ``eval_cpu``, for the three
constructions, AES-128 and a block-PRG id, with and without
``psum_group``.  ``eval_leaf_range_local`` is held against dpf_tpu's at
every granule ``row0``; the in-process sum wraps mod 2^32; knob
resolution follows dpf_tpu's.  Tolerance 0: every share is an int32.
"""

import numpy as np
import pytest
import torch

import dpf_tpu
from dpf_tpu.parallel import sharded as jsharded
from dpf_tpu.utils.config import EvalConfig as JEvalConfig
from dpf_tpu_torch.core import expand
from dpf_tpu_torch.core.u32 import from_u32
from dpf_tpu_torch.parallel import sharded
from dpf_tpu_torch.utils.hermetic import force_cpu_mesh

CPU = force_cpu_mesh(8)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _no_tuning_cache(monkeypatch):
    monkeypatch.setenv("DPF_TPU_TORCH_TUNE_CACHE", "0")


def _table(n, e, seed=11):
    return np.random.default_rng(seed).integers(
        -2 ** 31, 2 ** 31, (n, e), dtype=np.int64).astype(np.int32)


def _jdpf(prf, scheme, radix, table):
    d = dpf_tpu.DPF(config=JEvalConfig(prf_method=prf, scheme=scheme,
                                       radix=radix))
    d.eval_init(table)
    return d


def _keys(jd, n, batch, tag=b"sh"):
    """dpf_tpu's two servers' keys for ``batch`` distinct indices."""
    pairs = [jd.gen((i * 997 + 5) % n, n, seed=tag + b"-%d" % i)
             for i in range(batch)]
    return [np.asarray(a) for a, _ in pairs], [np.asarray(b)
                                               for _, b in pairs]


def _mesh(shape, devices):
    nb, nt, ny = shape
    if ny > 1:
        return sharded.make_mesh_2d(nt, ny, nb, devices=devices[:nb * nt * ny])
    return sharded.make_mesh(nt, nb, devices=devices[:nb * nt])


def _jmesh(shape):
    import jax
    nb, nt, ny = shape
    devs = jax.devices()
    if ny > 1:
        return jsharded.make_mesh_2d(nt, ny, nb, devices=devs[:nb * nt * ny])
    return jsharded.make_mesh(nt, nb, devices=devs[:nb * nt])


# ------------------------------------------- against dpf_tpu's mesh server

JAX_CASES = [
    # (prf, scheme, radix, (n_batch, n_table, n_byte), psum_group, n, e)
    pytest.param(2, "logn", 2, (1, 4, 1), 0, 1024, 4, id="chacha20-1x4"),
    pytest.param(4, "logn", 4, (2, 2, 1), 2, 1024, 4,
                 id="salsa20blk-radix4-2x2-psum2"),
    pytest.param(5, "sqrtn", 2, (2, 2, 1), 0, 4096, 16,
                 id="chacha20blk-sqrtn-2x2"),
    pytest.param(0, "logn", 2, (1, 2, 2), 0, 2048, 8, id="dummy-2d-2x2"),
]


@pytest.mark.parametrize("prf,scheme,radix,shape,pg,n,e", JAX_CASES)
def test_equals_dpf_tpu_sharded_server(prf, scheme, radix, shape, pg, n, e):
    table = _table(n, e)
    jd = _jdpf(prf, scheme, radix, table)
    ka, kb = _keys(jd, n, 4)
    chunk = 64 if scheme == "logn" else None
    jsrv = jsharded.ShardedDPFServer(
        table, _jmesh(shape), prf_method=prf, radix=radix, scheme=scheme,
        psum_group=pg, chunk_leaves=chunk)
    srv = sharded.ShardedDPFServer(
        table, _mesh(shape, CPU), prf_method=prf, radix=radix,
        scheme=scheme, psum_group=pg, chunk_leaves=chunk)
    want = np.asarray(jsrv.eval(ka))
    got = srv.eval(ka).numpy()
    np.testing.assert_array_equal(got, want)
    rec = (got.astype(np.int64) - srv.eval(kb).numpy()).astype(np.int32)
    idx = [(i * 997 + 5) % n for i in range(4)]
    np.testing.assert_array_equal(rec, table[idx])


# ---------------------------------- the matrix, against the scalar oracle

# (mesh, psum_group): the grouped sum where the shard has >= 4 chunks
MESHES = [((1, 4, 1), 0), ((2, 2, 1), 2), ((4, 2, 1), 0), ((1, 2, 2), 2)]
CONSTRUCTIONS = [  # (prf, scheme, radix, n, e)
    pytest.param(3, "logn", 2, 1024, 4, id="aes-binary"),
    pytest.param(5, "logn", 2, 1024, 4, id="chacha20blk-binary"),
    pytest.param(3, "logn", 4, 1024, 4, id="aes-radix4"),
    pytest.param(5, "logn", 4, 1024, 4, id="chacha20blk-radix4"),
    pytest.param(3, "sqrtn", 2, 4096, 16, id="aes-sqrtn"),
    pytest.param(5, "sqrtn", 2, 4096, 16, id="chacha20blk-sqrtn"),
]


@pytest.mark.parametrize("prf,scheme,radix,n,e", CONSTRUCTIONS)
def test_mesh_matrix_equals_dpf_tpu_oracle(prf, scheme, radix, n, e):
    table = _table(n, e, seed=prf + 3 * radix)
    jd = _jdpf(prf, scheme, radix, table)
    # the plain AES costs most on the CPU: two keys (padded to the
    # batch axis) for it, four for the block PRG
    ka, _ = _keys(jd, n, 2 if prf == 3 else 4, tag=b"mx")
    want = np.asarray(jd.eval_cpu(ka))
    for shape, pg in MESHES:
        if shape[2] > 1 and (scheme, radix) != ("logn", 2):
            with pytest.raises(ValueError, match="byte-axis"):
                sharded.ShardedDPFServer(table, _mesh(shape, CPU),
                                         prf_method=prf, radix=radix,
                                         scheme=scheme)
            continue
        srv = sharded.ShardedDPFServer(
            table, _mesh(shape, CPU), prf_method=prf, radix=radix,
            scheme=scheme, psum_group=pg,
            chunk_leaves=128 if scheme == "logn" else None,
            row_chunk=4 if scheme == "sqrtn" else None)
        np.testing.assert_array_equal(srv.eval(ka).numpy(), want,
                                      err_msg=str((shape, pg)))


# ------------------------------------------------------------ leaf range

def test_leaf_range_every_row0_equals_dpf_tpu():
    """DUMMY at every granule row0 of two granule sizes against dpf_tpu's
    ``eval_leaf_range_local``, and the partials' sum is the share."""
    n, e, prf = 1024, 4, 0
    table = _table(n, e, seed=2)
    jd = _jdpf(prf, "logn", 2, table)
    ka, _ = _keys(jd, n, 3, tag=b"lr")
    from dpf_tpu.core import keygen as jkeygen
    jpk = jkeygen.decode_keys_batched(ka)
    cw1, cw2, last = (from_u32(a) for a in (jpk.cw1, jpk.cw2, jpk.last))
    perm = expand.permute_table(table)
    want_full = np.asarray(jd.eval_cpu(ka))
    for g, chunk in ((256, 64), (128, 128)):
        acc = np.zeros_like(want_full)
        for row0 in range(0, n, g):
            tbl = perm[row0:row0 + g]
            want = np.asarray(jsharded.eval_leaf_range_local(
                jpk.cw1, jpk.cw2, jpk.last, tbl, row0, depth=10,
                prf_method=prf, chunk_leaves=chunk, n_total=n))
            got = sharded.eval_leaf_range_local(
                cw1, cw2, last, torch.from_numpy(tbl), row0, depth=10,
                prf_method=prf, chunk_leaves=chunk, n_total=n).numpy()
            np.testing.assert_array_equal(got, want, err_msg=str(row0))
            with np.errstate(over="ignore"):
                acc += got
        np.testing.assert_array_equal(acc, want_full)


@pytest.mark.parametrize("prf,radix", [(2, 2), (4, 4), (3, 4)])
def test_leaf_ranges_sum_to_the_share(prf, radix):
    """Unaligned-to-the-root windows (3 granules of 128 rows from row
    128) through K2's leaf-range form and the per-level route."""
    n, e = 512, 3
    table = _table(n, e, seed=4)
    jd = _jdpf(prf, "logn", radix, table)
    ka, _ = _keys(jd, n, 2, tag=b"ws")
    want = np.asarray(jd.eval_cpu(ka))
    from dpf_tpu_torch.core import keygen, radix4
    if radix == 4:
        pk = radix4.decode_mixed_keys_batched(ka)
        perm = table[radix4.mixed_reverse_indices(radix4.arities(n))]
    else:
        pk = keygen.decode_keys_batched(ka)
        perm = expand.permute_table(table)
    cw1, cw2, last = (from_u32(a) for a in (pk.cw1, pk.cw2, pk.last))
    acc = torch.zeros((2, e), dtype=torch.int32)
    for row0, rows in ((0, 128), (128, 384)):
        acc += sharded.eval_leaf_range_local(
            cw1, cw2, last, torch.from_numpy(perm[row0:row0 + rows].copy()),
            row0, prf_method=prf, chunk_leaves=64, n_total=n, radix=radix)
    np.testing.assert_array_equal(acc.numpy(), want)


def test_leaf_range_rejects_partial_chunks():
    cw = torch.zeros((1, 64, 4), dtype=torch.int32)
    last = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="whole"):
        sharded.eval_leaf_range_local(
            cw, cw, last, torch.zeros((96, 2), dtype=torch.int32), 32,
            prf_method=0, chunk_leaves=64, n_total=256)


# ------------------------------------------------------------- reduction

def test_mesh_sum_wraps_mod_2_32():
    """Partials of 2^31 - 1 (+ the group) from the two table shards of
    each (batch, byte) block sum mod 2^32, grouped or not."""
    mesh = sharded.make_mesh_2d(2, 2, 2, devices=CPU)

    def partial(idx, k):
        return torch.full((2, 2), 2 ** 31 - 1, dtype=torch.int32) + k

    for groups in (1, 3):
        got = sharded.mesh_sum(mesh, 4, 4, partial, groups).numpy()
        want = 2 * sum(2 ** 31 - 1 + k for k in range(groups)) % (1 << 32)
        want = np.array(want, np.uint32).view(np.int32)
        assert (got == want).all(), (groups, got)


def test_wrap_i32_folds_residues():
    v = torch.tensor([2 ** 32 + 5, -1, 2 ** 31, 3 * 2 ** 31 + 7])
    assert sharded._wrap_i32(v).tolist() == [5, -1, -2 ** 31, -2 ** 31 + 7]


# ------------------------------------------------------------- mesh rules

def test_make_mesh_validation(monkeypatch):
    with pytest.raises(ValueError, match="cover"):
        sharded.make_mesh(3, 2, devices=CPU)
    m = sharded.make_mesh(4, 2, devices=CPU)
    assert m.shape == {"batch": 2, "table": 4}
    assert m.output_device == torch.device("cpu")
    assert len(m.local_entries()) == 8 and m.local_devices() == CPU[:1]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sharded.make_mesh()


def test_block_prg_sqrt_split_raises_like_dpf_tpu():
    """A block-PRG split whose R / shards is not a multiple of 4 cannot
    run on K4; both packages raise ValueError (the port has no scan to
    fall back to on the card)."""
    n = 4096
    table = _table(n, 4)
    jd = _jdpf(5, "sqrtn", 2, table)
    from dpf_tpu.core import sqrtn as jsqrtn
    ka = [np.asarray(jsqrtn.generate_sqrt_keys(7, n, b"s", 5, n_keys=512)[0]
                     .serialize())]   # R = 8 rows over 4 shards: 2 each
    srv = sharded.ShardedDPFServer(table, _mesh((1, 4, 1), CPU),
                                   prf_method=5, scheme="sqrtn")
    with pytest.raises(ValueError, match="multiple of 4"):
        srv.eval(ka)
    jsrv = jsharded.ShardedDPFServer(table, _jmesh((1, 4, 1)), prf_method=5,
                                     scheme="sqrtn")
    with pytest.raises(ValueError):
        jsrv.eval(ka)
    assert jd.scheme == "sqrtn"


@pytest.mark.parametrize("scheme,radix,shape,batch", [
    ("logn", 2, (1, 4, 1), 512), ("logn", 4, (2, 2, 1), 64),
    ("sqrtn", 2, (2, 2, 1), 512), ("logn", 2, (1, 2, 2), 8)])
def test_resolved_knobs_follow_dpf_tpu(scheme, radix, shape, batch):
    n = 4096
    table = _table(n, 4)
    srv = sharded.ShardedDPFServer(table, _mesh(shape, CPU), prf_method=3,
                                   radix=radix, scheme=scheme)
    jsrv = jsharded.ShardedDPFServer(table, _jmesh(shape), prf_method=3,
                                     radix=radix, scheme=scheme)
    got, want = srv.resolved_eval_knobs(batch), jsrv.resolved_eval_knobs(
        batch)
    for k in ("chunk_leaves", "row_chunk", "psum_group", "dot_impl"):
        assert got.get(k) == want.get(k), k
    srv.chunk, jsrv.chunk = 1 << 20, 1 << 20     # an explicit pin clamps
    srv.psum_group = jsrv.psum_group = 2
    got, want = srv.resolved_eval_knobs(batch), jsrv.resolved_eval_knobs(
        batch)
    assert (got.get("chunk_leaves"), got["psum_group"]) == \
        (want.get("chunk_leaves"), want["psum_group"])


# ---------------------------------------------------------- server surface

def test_engine_over_mesh_and_dpf_sharded_server():
    """``DPF.sharded_server`` inherits the construction; its engine's
    ragged batches (padded to the batch axis) equal ``eval``."""
    from dpf_tpu_torch import DPF
    from dpf_tpu_torch.utils.config import EvalConfig
    n = 1024
    table = _table(n, 4)
    d = DPF(config=EvalConfig(prf_method=0, radix=4), device="cpu")
    d.eval_init(table)
    srv = d.sharded_server(_mesh((2, 2, 1), CPU), chunk_leaves=64)
    assert (srv.scheme, srv.radix, srv.prf_method) == ("logn", 4, 0)
    ka, kb = d.gen_batch([1, 2, 3, 500, 1023], n)
    eng = srv.serving_engine(buckets=(1, 4), max_in_flight=2)
    futs = [eng.submit(ka[i:j]) for i, j in ((0, 3), (3, 4), (4, 5))]
    eng.drain()
    got = np.concatenate([f.result() for f in futs])
    np.testing.assert_array_equal(got, d.eval_gpu(ka).numpy())
    rec = (got.astype(np.int64) - srv.eval(kb).numpy()).astype(np.int32)
    np.testing.assert_array_equal(rec, table[[1, 2, 3, 500, 1023]])


def test_scheme_auto_resolves_like_dpf(monkeypatch):
    table = _table(1024, 4)
    srv = sharded.ShardedDPFServer(table, _mesh((1, 2, 1), CPU),
                                   prf_method=0, scheme="auto")
    assert (srv.scheme, srv.radix, srv.scheme_resolved_from) == \
        ("logn", 2, "heuristic")
    with pytest.raises(ValueError, match="radix"):
        sharded.ShardedDPFServer(table, _mesh((1, 2, 1), CPU), radix=4,
                                 scheme="auto")
