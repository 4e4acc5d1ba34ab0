"""The port's sqrt-N path against dpf_tpu's, on the CPU.

Every comparison is bit for bit: wire words, packed arrays, PRF values
(mod 2^128) and server shares (mod 2^32).  Inputs come from numpy seeds
and are handed to both packages; the JAX Pallas kernels run in interpret
mode, as ``tests/test_pallas_sqrt.py`` runs them here.  ``dpf_tpu``'s
sqrt-N server runs its XLA scan; one server per (PRF, N) and batches of
5 keys (padded to 8) keep its jitted shapes few.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import dpf_tpu
import dpf_tpu_torch
from dpf_tpu.core import prf as jprf
from dpf_tpu.core import sqrtn as jsq
from dpf_tpu.core import u128 as ju128
from dpf_tpu.ops import pallas_level, pallas_sqrt
from dpf_tpu.utils.config import EvalConfig as JaxEvalConfig
from dpf_tpu_torch import interop
from dpf_tpu_torch.core import prf, sqrtn, u128
from dpf_tpu_torch.core.u32 import from_u32, to_u32
from dpf_tpu_torch.ops import sqrt_grid, subtree
from dpf_tpu_torch.utils.bench import test_dpf_perf as torch_dpf_perf
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


def _jax_batch(n, method, count=3, n_keys=None, seed=b"sq"):
    """dpf_tpu's sqrt-N keys, alternating servers: (SqrtKey list, [B, W]
    wire words)."""
    keys = [jsq.generate_sqrt_keys((i * 71 + 3) % n, n, seed + b"%d" % i,
                                   method, n_keys=n_keys)[i % 2]
            for i in range(count)]
    return keys, np.stack([k.serialize() for k in keys])


def _device(pk):
    return [from_u32(a) for a in (pk.seeds, pk.cw1, pk.cw2)]


# ------------------------------------------------------- codec and keys

@pytest.mark.parametrize("method", range(6))
@pytest.mark.parametrize("n,n_keys", [(1 << 9, None), (1 << 10, None),
                                      (1 << 10, 64)])
def test_generate_sqrt_keys_matches_dpf_tpu(method, n, n_keys):
    for alpha in (0, n - 1, (n * 5) // 7):
        seed = b"sq-%d-%d" % (method, alpha)
        ours = sqrtn.generate_sqrt_keys(alpha, n, seed, method,
                                        n_keys=n_keys)
        theirs = jsq.generate_sqrt_keys(alpha, n, seed, method,
                                        n_keys=n_keys)
        for o, t in zip(ours, theirs):
            assert (o.serialize() == t.serialize()).all()
        assert ours[0].n_keys == (n_keys or jsq.default_split(n)[0])


def test_default_split_matches_dpf_tpu():
    for d in range(1, 33):
        assert sqrtn.default_split(1 << d) == jsq.default_split(1 << d)


def test_decode_sqrt_keys_batched_and_rejections():
    n = 1 << 9
    keys, wire = _jax_batch(n, 2, count=5)
    pk = sqrtn.decode_sqrt_keys_batched(wire)
    want = jsq.decode_sqrt_keys_batched(wire)
    for f in ("seeds", "cw1", "cw2"):
        assert (getattr(pk, f) == getattr(want, f)).all()
    assert (pk.n, pk.n_keys, pk.n_codewords, pk.batch) == (n, 32, 16, 5)
    assert (pk.slice(1, 3).cw2 == want.slice(1, 3).cw2).all()
    for k, w in zip(keys, wire):
        ours = sqrtn.deserialize_sqrt_key(torch.from_numpy(w))
        assert (ours.keys == k.keys).all() and (ours.cw1 == k.cw1).all()
    seeds, cw1, cw2 = sqrtn.pack_sqrt_keys(
        [sqrtn.deserialize_sqrt_key(w) for w in wire])
    assert (seeds == pk.seeds).all() and (cw2 == pk.cw2).all()
    assert (sqrtn.sqrt_wire_ns(wire) == jsq.sqrt_wire_ns(wire)).all()

    other_split = jsq.generate_sqrt_keys(1, n, b"o", 2, n_keys=64)[0]
    other_n = jsq.generate_sqrt_keys(1, 1 << 10, b"o", 2,
                                     n_keys=32)[0].serialize()
    logn = dpf_tpu.DPF(prf=2).gen(3, n, seed=b"l")[0]
    bad = wire[0].copy()
    bad[8] = 7                                    # n != K * R
    cases = [([wire[0], other_split.serialize()], "mixed sqrt-N splits"),
             ([wire[0], other_n], "mixed sqrt-N splits"),
             ([np.asarray(logn)], "malformed sqrt-N key"),
             ([wire[0][:6]], "malformed sqrt-N key"),
             ([bad], "malformed sqrt-N key")]
    for batch, msg in cases:
        for decode in (sqrtn.decode_sqrt_keys_batched,
                       jsq.decode_sqrt_keys_batched):
            with pytest.raises(ValueError, match=msg):
                decode(batch)
    # equal splits, different n: the same width, caught on the header
    same_k = jsq.generate_sqrt_keys(1, 1 << 10, b"o", 2, n_keys=32)
    twice = np.stack([wire[0], wire[0]])
    slots = twice.view(np.uint32).reshape(2, -1, 4)
    slots[1, 2, 0] = 1 << 10
    for decode in (sqrtn.decode_sqrt_keys_batched,
                   jsq.decode_sqrt_keys_batched):
        with pytest.raises(ValueError, match="mixed table sizes"):
            decode(twice)
    for w in (np.asarray(logn), bad, wire[0][:6], same_k[0].serialize()[:8]):
        with pytest.raises(ValueError) as ours:
            sqrtn.deserialize_sqrt_key(w)
        with pytest.raises(ValueError) as theirs:
            jsq.deserialize_sqrt_key(w)
        assert str(ours.value) == str(theirs.value)


def test_row_chunk_rules_match_dpf_tpu():
    for r in (1, 2, 4, 8, 16, 64, 1024):
        for k in (1, 4, 32, 1024):
            for b in (1, 3, 8, 512):
                assert sqrtn.choose_row_chunk(r, k, b) == \
                    jsq.choose_row_chunk(r, k, b)
                assert sqrtn.row_chunk_within_bound(r, k, b) == \
                    jsq.row_chunk_within_bound(r, k, b)
                for rc in (None, 0, 2, 3, 4, 8, 16, r):
                    assert sqrtn.clamp_row_chunk(rc, r, k, b) == \
                        jsq.clamp_row_chunk(rc, r, k, b)
                    try:
                        want = jsq._resolve_row_chunk(r, k, b, rc)
                    except ValueError as exc:
                        with pytest.raises(ValueError, match="row_chunk"):
                            sqrtn._resolve_row_chunk(r, k, b, rc)
                        with pytest.raises(ValueError, match="row_chunk"):
                            sqrt_grid.sqrt_row_chunk(r, k, rc)
                        assert "row_chunk" in str(exc)
                        continue
                    assert sqrtn._resolve_row_chunk(r, k, b, rc) == want
                    assert sqrt_grid.sqrt_row_chunk(r, k, rc) == \
                        pallas_sqrt.pallas_sqrt_row_chunk(r, k, rc)


# -------------------------------------------------------- grid values

@pytest.mark.parametrize("method", range(6))
def test_prf_v_tensor_positions_match_dpf_tpu(method):
    rng = np.random.default_rng(40 + method)
    seeds = _rand_u32(rng, 3, 1, 5, 4)
    pos = np.array([0, 1, 2, 3, 4, 7, 1 << 20, (1 << 31) + 5,
                    (1 << 32) - 4243], dtype=np.uint32)[:, None]
    want = jprf.prf_v(method, np.broadcast_to(seeds, (3, 9, 5, 4)).copy(),
                      pos)
    got = prf.prf_v(method, from_u32(seeds), from_u32(pos))
    assert (to_u32(got) == want).all()
    # a scalar position still takes the static path
    assert (to_u32(prf.prf_v(method, from_u32(seeds), 6))
            == jprf.prf_v(method, seeds, 6)).all()


def test_mul128_small_tensor_multiplier_matches_dpf_tpu():
    rng = np.random.default_rng(5)
    a = _rand_u32(rng, 4, 6, 4)
    c = _rand_u32(rng, 6)
    want = ju128.mul128_small(a, c)
    assert (to_u32(u128.mul128_small(from_u32(a), from_u32(c))) == want).all()


@pytest.mark.parametrize("method", range(6))
@pytest.mark.parametrize("r,row0", [(16, 0), (6, 8), (5, 1 << 20)])
def test_grid_vals_match_dpf_tpu(method, r, row0):
    rng = np.random.default_rng(r + method)
    seeds = _rand_u32(rng, 2, 1, 8, 4)
    want = jsq._grid_vals(
        method, lambda nr: np.broadcast_to(seeds, (2, nr, 8, 4)).copy(), r,
        np, row0=np.uint32(row0))
    ts = from_u32(seeds)
    got = sqrtn._grid_vals(method, lambda nr: ts.expand(2, nr, 8, 4), r,
                           row0=row0)
    assert (to_u32(got) == want).all()


@pytest.mark.parametrize("method", range(6))
def test_eval_grid_and_points_match_dpf_tpu(method):
    n = 1 << 9
    keys, _ = _jax_batch(n, method, count=2)
    for k in keys:
        assert (sqrtn.eval_grid(k, method).numpy()
                == jsq.eval_grid(k, method)).all()
    idx = [0, 5, 31, 32, 100, n - 1]
    assert (sqrtn.eval_points_sqrt(keys, idx, method).numpy()
            == jsq.eval_points_sqrt(keys, idx, method)).all()


# -------------------------------------------------- the kernel's module

def _grid_case(n, method, n_keys=None, e=5, count=3):
    keys, wire = _jax_batch(n, method, count=count, n_keys=n_keys,
                            seed=b"pg")
    pk = jsq.decode_sqrt_keys_batched(wire)
    table = _table(n, e, seed=7)
    return pk, table


@pytest.mark.parametrize("method", [1, 2, 4, 5])
def test_sqrt_grid_matches_pallas_interpret(method):
    pk, table = _grid_case(64, method)
    seeds, cw1, cw2 = _device(pk)
    tbl = torch.from_numpy(table)
    for rc in (None, 4):
        want = np.asarray(pallas_sqrt.sqrt_grid_contract_pallas(
            pk.seeds, pk.cw1, pk.cw2, jnp.asarray(table), prf_method=method,
            row_chunk=rc, interpret=True))
        for fn in (sqrt_grid.sqrt_grid_contract_plain,
                   sqrt_grid.sqrt_grid_contract):
            got = fn(seeds, cw1, cw2, tbl, prf_method=method, row_chunk=rc)
            assert (got.numpy() == want).all(), (fn.__name__, rc)


@pytest.mark.parametrize("method", range(6))
def test_sqrt_grid_matches_xla_scan(method):
    """All six ids against dpf_tpu's scan at the API's shape (8 keys at
    N = 2^9), the row0 halves, and an R = 2 split whose last quad of
    rows is cut for the block-PRG ids."""
    pk, table = _grid_case(1 << 9, method, e=16, count=8)
    want = np.asarray(jsq.eval_contract_batched(
        pk.seeds, pk.cw1, pk.cw2, jnp.asarray(table), prf_method=method,
        kernel_impl="xla"))
    seeds, cw1, cw2 = _device(pk)
    tbl = torch.from_numpy(table)
    for rc in (None, 4, 8):
        got = sqrt_grid.sqrt_grid_contract(seeds, cw1, cw2, tbl,
                                           prf_method=method, row_chunk=rc)
        assert (got.numpy() == want).all(), rc
    assert (sqrtn.eval_contract_batched(seeds, cw1, cw2, tbl,
                                        prf_method=method).numpy()
            == want).all()
    k, half = seeds.shape[1], cw1.shape[1] // 2
    lo = sqrt_grid.sqrt_grid_contract(
        seeds, cw1[:, :half], cw2[:, :half], tbl[:half * k],
        prf_method=method)
    hi = sqrt_grid.sqrt_grid_contract(
        seeds, cw1[:, half:], cw2[:, half:], tbl[half * k:],
        prf_method=method, row0=half)
    assert ((lo + hi).numpy() == want).all()
    pk2, table2 = _grid_case(128, method, n_keys=64)
    want2 = np.asarray(jsq.eval_contract_batched(
        pk2.seeds, pk2.cw1, pk2.cw2, jnp.asarray(table2),
        prf_method=method, kernel_impl="xla"))
    got2 = sqrt_grid.sqrt_grid_contract(*_device(pk2),
                                        torch.from_numpy(table2),
                                        prf_method=method)
    assert (got2.numpy() == want2).all()


def test_sqrt_grid_rejections():
    pk, table = _grid_case(64, 5)
    seeds, cw1, cw2 = _device(pk)
    tbl = torch.from_numpy(table)
    with pytest.raises(ValueError, match="multiple of 4"):
        sqrt_grid.sqrt_grid_contract(seeds, cw1, cw2, tbl, prf_method=5,
                                     row0=2)
    assert sqrt_grid.sqrt_grid_unsupported(5, 2) is None
    assert "unknown PRF" in sqrt_grid.sqrt_grid_unsupported(9, 8)
    with pytest.raises(ValueError, match="must divide R"):
        sqrt_grid.sqrt_grid_contract(seeds, cw1, cw2, tbl, prf_method=2,
                                     row_chunk=3)
    with pytest.raises(ValueError, match="table must be"):
        sqrt_grid.sqrt_grid_contract(seeds, cw1, cw2, tbl[:8], prf_method=2)
    with pytest.raises(TypeError):
        sqrt_grid.sqrt_grid_contract(seeds.long(), cw1, cw2, tbl,
                                     prf_method=2)
    with pytest.raises(ValueError, match="contiguous"):
        sqrt_grid.sqrt_grid_contract(seeds, cw1, cw2, tbl.t().contiguous().t(),
                                     prf_method=2)


@pytest.mark.parametrize("bsz,w", [(3, 5), (1, 1)])
def test_chacha_level_step_matches_pallas_interpret(bsz, w):
    rng = np.random.default_rng(bsz * 10 + w)
    seeds = _rand_u32(rng, bsz, w, 4)
    c1, c2 = _rand_u32(rng, bsz, 2, 4), _rand_u32(rng, bsz, 2, 4)
    want = np.asarray(pallas_level.chacha_level_step_pallas(
        jnp.asarray(seeds), jnp.asarray(c1), jnp.asarray(c2),
        interpret=True))
    got = subtree.chacha_level_step(from_u32(seeds), from_u32(c1),
                                    from_u32(c2))
    assert (to_u32(got) == want).all()
    assert subtree.chacha_level_step.launches == 0   # CPU: plain version


# ------------------------------------------------------ the slice whole

@pytest.mark.parametrize("n,method", [(1 << 9, m) for m in range(6)]
                         + [(1 << 10, 2), (1 << 10, 3)])
def test_sqrtn_server_matches_dpf_tpu(n, method):
    table = _table(n, 16, seed=n + method)
    ours = dpf_tpu_torch.DPF(prf=method, scheme="sqrtn", device="cpu")
    theirs = dpf_tpu.DPF(config=JaxEvalConfig(prf_method=method,
                                              scheme="sqrtn"))
    ours.eval_init(table)
    theirs.eval_init(table)
    idx = [3, n - 1, 77, 200, 5]
    pairs = [ours.gen(i, n, seed=b"s%d" % i) for i in idx]
    for i, (a, b) in zip(idx, pairs):
        ja, jb = theirs.gen(i, n, seed=b"s%d" % i)
        assert (a.numpy() == np.asarray(ja)).all()
        assert (b.numpy() == np.asarray(jb)).all()
    ka, kb = [p[0] for p in pairs], [p[1] for p in pairs]
    sa, sb = ours.eval_gpu(ka), ours.eval_tpu(kb)
    want = np.asarray(theirs.eval_tpu([k.numpy() for k in ka]))
    assert sa.shape == (5, 16) and (sa.numpy() == want).all()
    assert ((sa - sb).numpy() == table[idx]).all()
    cpu = ours.eval_cpu(ka)
    assert (cpu.numpy() == sa.numpy()).all()
    assert (cpu.numpy()
            == np.asarray(theirs.eval_cpu([k.numpy() for k in ka]))).all()
    hot = ours.eval_one_hot(ka).numpy()
    assert (hot == np.asarray(theirs.eval_one_hot(
        [k.numpy() for k in ka]))).all()
    assert (hot == ours.eval_cpu(ka, one_hot_only=True).numpy()).all()
    q = [0, 1, n // 2 + 3, n - 1]
    assert (ours.eval_points(ka, q).numpy() == np.asarray(
        theirs.eval_points([k.numpy() for k in ka], q))).all()
    knobs = ours.resolved_eval_knobs(8)
    assert knobs["kernel"] == "sqrt_grid_contract"
    assert knobs["row_chunk"] is None
    assert knobs["kernel_resolved_from"] == "heuristic"


def test_sqrtn_server_batches_and_row_chunk_pin():
    n, method = 1 << 9, 5
    table = _table(n, 3, seed=1)
    keys, wire = _jax_batch(n, method, count=7)
    want = np.asarray(jsq.eval_contract_batched(
        *jsq.pack_sqrt_keys(keys), jnp.asarray(table), prf_method=method,
        kernel_impl="xla"))
    for cfg in (EvalConfig(prf_method=method, scheme="sqrtn", batch_size=4),
                EvalConfig(prf_method=method, scheme="sqrtn", row_chunk=4)):
        d = dpf_tpu_torch.DPF(config=cfg, device="cpu")
        d.eval_init(table)
        assert (d.eval_gpu(wire).numpy() == want).all()
    d = dpf_tpu_torch.DPF(config=EvalConfig(prf_method=method,
                                            scheme="sqrtn", row_chunk=3),
                          device="cpu")
    d.eval_init(table)
    for call in (lambda: d.resolved_eval_knobs(8), lambda: d.eval_gpu(wire)):
        with pytest.raises(ValueError, match="must divide R"):
            call()


def test_sqrtn_api_errors_match_dpf_tpu():
    with pytest.raises(ValueError, match="no radix"):
        dpf_tpu_torch.DPF(config=EvalConfig(radix=4, scheme="sqrtn"),
                          device="cpu")
    with pytest.raises(ValueError, match="no radix"):
        dpf_tpu.DPF(config=JaxEvalConfig(radix=4, scheme="sqrtn"))
    with pytest.raises(ValueError, match="leave radix at 2"):
        dpf_tpu_torch.DPF(scheme="auto", config=EvalConfig(radix=4),
                          device="cpu")
    with pytest.raises(ValueError, match="leave radix at 2"):
        dpf_tpu.DPF(scheme="auto", config=JaxEvalConfig(radix=4))
    with pytest.raises(ValueError, match="entry_size only"):
        dpf_tpu_torch.DPF(scheme="sqrtn", entry_size=4, device="cpu")
    with pytest.raises(ValueError, match="entry_size only"):
        dpf_tpu.DPF(scheme="sqrtn", entry_size=4)
    n = 1 << 9
    table = _table(n, 4)
    sq = dpf_tpu_torch.DPF(prf=2, scheme="sqrtn", device="cpu")
    logn = dpf_tpu_torch.DPF(prf=2, device="cpu")
    jsqs = dpf_tpu.DPF(config=JaxEvalConfig(prf_method=2, scheme="sqrtn"))
    jlogn = dpf_tpu.DPF(prf=2)
    for d in (sq, logn, jsqs, jlogn):
        d.eval_init(table)
    sq_key = sq.gen(5, n, seed=b"e")[0]
    logn_key = logn.gen(5, n, seed=b"e")[0]
    for server, key, msg in ((sq, logn_key, "malformed sqrt-N key"),
                             (jsqs, logn_key, "malformed sqrt-N key"),
                             (logn, sq_key, "524"), (jlogn, sq_key, "524")):
        with pytest.raises(ValueError, match=msg):
            server.eval_tpu([key.numpy()])
    wrong_n = sq.gen(5, n // 2, seed=b"w")[0].numpy()
    for server in (sq, jsqs):
        with pytest.raises(ValueError, match="key generated for n=256"):
            server.eval_tpu([wrong_n])
    with pytest.raises(ValueError, match="mixed sqrt-N splits"):
        sq.eval_gpu([sq_key, wrong_n])
    with pytest.raises(ValueError, match="indices"):
        sq.eval_points([sq_key], [n])


def test_interop_sqrt_state_from_dpf_tpu_keys():
    n, method = 1 << 10, 4
    keys, wire = _jax_batch(n, method, count=3)
    table = _table(n, 16, seed=3)
    want = np.asarray(jsq.eval_contract_batched(
        *jsq.pack_sqrt_keys(keys), jnp.asarray(table), prf_method=method,
        kernel_impl="xla"))
    for scheme in (None, "sqrtn"):
        st = interop.state_from_numpy(table, wire, device="cpu",
                                      scheme=scheme)
        assert isinstance(st, interop.SqrtDeviceState)
        assert (st.table.numpy() == table).all()
        got = sqrtn.eval_contract_batched(st.seeds, st.cw1, st.cw2, st.table,
                                          prf_method=method)
        assert (got.numpy() == want).all()
    logn_wire = np.stack([np.asarray(dpf_tpu.DPF(prf=2).gen(
        3, n, seed=b"i")[0])])
    assert interop.detect_scheme(logn_wire) == "logn"
    assert isinstance(interop.state_from_numpy(table, logn_wire,
                                               device="cpu"),
                      interop.DeviceState)
    with pytest.raises(ValueError, match="malformed sqrt-N key"):
        interop.state_from_numpy(table, logn_wire, device="cpu",
                                 scheme="sqrtn")
    with pytest.raises(ValueError, match="524"):
        interop.state_from_numpy(table, wire, device="cpu", scheme="logn")
    with pytest.raises(ValueError, match="keys for n="):
        interop.state_from_numpy(table[:512], wire, device="cpu")
    # a 524-word batch whose header also reads as a sqrt-N key (K = 1,
    # R = 63, n = 63) is refused rather than guessed
    odd = np.zeros((1, 524), np.int32)
    odd[0, 0], odd[0, 4], odd[0, 8] = 1, 63, 63
    with pytest.raises(ValueError, match="ambiguous"):
        interop.state_from_numpy(table, odd, device="cpu")


def test_dpf_perf_names_the_scheme():
    r = torch_dpf_perf(N=256, batch=4, entrysize=4, prf=5, reps=1,
                       keys_distinct=2, quiet=True, check=True,
                       config=EvalConfig(scheme="sqrtn"), device="cpu")
    assert r["scheme"] == "sqrtn" and r["checked"]
    assert r["key_size_bytes"] == 4 * 4 * (4 + 16 + 2 * 16)
