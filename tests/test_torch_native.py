"""The port's native host library against the pure-Python path and
against ``dpf_tpu.native``: the same wire keys byte for byte, the same
one-hot shares, and ``DPF.eval_cpu``'s native route equal to its plain
route.  Exact: integers mod 2^32 and 2^128."""

import numpy as np
import pytest
import torch

import dpf_tpu_torch
from dpf_tpu import native as jnative
from dpf_tpu_torch import api, native
from dpf_tpu_torch.core import evalref, keygen


@pytest.fixture(scope="module")
def built():
    """The port's library, built into dpf_tpu_torch/_build/ (g++ is part
    of the tests' toolchain, as for tests/test_torch_cuda_host.py)."""
    if not native.available():
        raise AssertionError("native build failed:\n%s"
                             % native.build_error())
    assert native.library_path().parent.name == "_build"
    assert native.library_path().parent.parent.name == "dpf_tpu_torch"


@pytest.fixture(scope="module")
def jax_native():
    if not jnative.available():
        pytest.skip("dpf_tpu.native did not build")


@pytest.mark.parametrize("method", range(6))
def test_native_gen_matches_python_and_dpf_tpu(built, jax_native, method):
    for n, alpha in ((2, 1), (128, 0), (1024, 1023), (8192, 1234)):
        seed = b"nat-%d-%d" % (method, alpha)
        ka, kb = native.gen(alpha, n, seed, method)
        pa, pb = keygen.generate_keys(alpha, n, seed, method)
        ja, jb = jnative.gen(alpha, n, seed, method)
        assert (ka == pa.serialize()).all() and (kb == pb.serialize()).all()
        assert (ka == ja).all() and (kb == jb).all()


@pytest.mark.parametrize("method", range(6))
def test_native_expand_matches_python_and_dpf_tpu(built, jax_native, method):
    n, alpha = 512, 499
    ka, kb = native.gen(alpha, n, bytearray(b"exp"), method)
    ha, hb = native.eval_expand(ka, method), native.eval_expand(
        torch.from_numpy(kb), method)
    assert (ha == evalref.eval_one_hot_i32(keygen.deserialize_key(ka),
                                           method)).all()
    assert (ha == jnative.eval_expand(ka, method)).all()
    d = ha.view(np.uint32) - hb.view(np.uint32)
    assert (d == (np.arange(n) == alpha)).all()


@pytest.mark.parametrize("method", [0, 3])
def test_native_eval_contract_matches_eval_cpu(built, method):
    n = 256
    table = np.random.default_rng(5).integers(
        -2 ** 31, 2 ** 31, (n, 5), dtype=np.int64).astype(np.int32)
    d = dpf_tpu_torch.DPF(prf=method, device="cpu", strict=False)
    d.eval_init(table)
    wa, wb = d.gen_batch([3, 200, 17], n)
    want = d.eval_cpu(wa).numpy()
    for threads in (1, 2):
        assert (native.eval_contract(wa, method, table, threads)
                == want).all()
    rec = (native.eval_contract(wa, method, table)
           - native.eval_contract(list(wb), method, table))
    assert (rec == table[[3, 200, 17]]).all()
    with pytest.raises(ValueError, match="table has 128 rows"):
        native.eval_contract(wa, method, table[:128])
    with pytest.raises(ValueError, match="524"):
        native.eval_contract([wa[0, :-1]], method, table)


def test_native_rejects_bad_input(built):
    with pytest.raises(ValueError, match="native keygen failed"):
        native.gen(5, 100, b"x", 0)
    with pytest.raises(ValueError, match="native keygen failed"):
        native.gen(8, 8, b"x", 0)
    with pytest.raises(ValueError, match="524"):
        native.eval_expand(np.zeros(523, np.int32), 0)


@pytest.mark.parametrize("method", [2, 3])
def test_api_native_route_equals_plain_route(built, monkeypatch, method):
    """``gen``, ``gen_batch`` and ``eval_cpu`` give the same bytes with
    the native library and without it."""
    n = 256
    d = dpf_tpu_torch.DPF(prf=method, device="cpu")
    d.eval_init(np.random.default_rng(2).integers(
        -2 ** 31, 2 ** 31, (n, 3), dtype=np.int64).astype(np.int32))
    seeds = [b"r%d" % i for i in range(4)]
    nat_one = d.gen(99, n, seed=b"one")
    nat_batch = d.gen_batch([1, 2, 3, 99], n, seeds=seeds)
    nat_cpu = d.eval_cpu(nat_batch[0])
    nat_hot = d.eval_cpu(list(nat_batch[1]), one_hot_only=True)
    monkeypatch.setattr(native, "available", lambda: False)
    assert api._native_gen(99, n, b"one", method) is None
    assert api._native_expand_batch(nat_batch[0], method) is None
    for a, b in zip(nat_one, d.gen(99, n, seed=b"one")):
        assert torch.equal(a, b)
    for a, b in zip(nat_batch, d.gen_batch([1, 2, 3, 99], n, seeds=seeds)):
        assert torch.equal(a, b)
    assert torch.equal(nat_cpu, d.eval_cpu(nat_batch[0]))
    assert torch.equal(nat_hot, d.eval_cpu(list(nat_batch[1]),
                                           one_hot_only=True))


def test_eval_cpu_rejects_radix4_key_before_native(built):
    r4 = dpf_tpu_torch.DPF(config=dpf_tpu_torch.EvalConfig(radix=4),
                           device="cpu")
    key = r4.gen(5, 256, seed=b"r4")[0]
    with pytest.raises(ValueError, match="mixed-radix"):
        dpf_tpu_torch.DPF(device="cpu").eval_cpu([key], one_hot_only=True)


def test_build_failure_is_reported(monkeypatch, tmp_path):
    """A failed build leaves ``available()`` False and keeps the
    compiler's output; the API then takes the Python generators."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "FLAGS", native.FLAGS + ("-DNO_SUCH",
                                                         "--no-such-flag"))
    native._load.cache_clear()
    try:
        assert not native.available()
        err = native.build_error()
        assert "--no-such-flag" in err and "g++" in err
        with pytest.raises(RuntimeError, match="did not build"):
            native.gen(1, 8, b"x", 0)
        k = dpf_tpu_torch.DPF(device="cpu").gen(3, 64, seed=b"py")[0]
        assert torch.equal(k, torch.from_numpy(
            keygen.generate_keys(3, 64, b"py", 3)[0].serialize()))
    finally:
        native._load.cache_clear()
