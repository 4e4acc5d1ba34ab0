"""The port's bitsliced AES (``core/aes_bitsliced.py`` and the S-box
circuits) and the ``aes_impl`` knob, against ``dpf_tpu`` on the CPU.

Every formulation is bit-exact: the bitsliced AES at n_pts 1, 2, 4 with
each S-box circuit equals ``dpf_tpu``'s numpy path, the port's gather
AES and the scalar ``prf_ref``; both circuits equal the S-box table on
all 256 bytes; a ``DPF`` whose config names any ``aes_impl`` gives the
same shares.
"""

import numpy as np
import pytest
import torch

from dpf_tpu.core import aes_bitsliced as jab
from dpf_tpu_torch import DPF, EvalConfig
from dpf_tpu_torch.core import aes_bitsliced as ab
from dpf_tpu_torch.core import aes_sbox_bp, aes_sbox_circuit, prf, prf_ref
from dpf_tpu_torch.core.u32 import from_u32, to_u32

SBOXES = ("bp", "tower", "chain")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _seeds(n, seed=0):
    rng = np.random.default_rng(seed)
    s = rng.integers(0, 2 ** 32, (n, 4), dtype=np.uint32)
    s[0] = 0
    s[-1] = 0xFFFFFFFF
    return s


def test_pack_unpack_roundtrip_with_top_bits():
    vals = _seeds(24).reshape(-1)            # 96 words, top bits set
    t = from_u32(vals)
    planes = ab.pack_planes(t)
    assert to_u32(ab.unpack_planes(planes)).tolist() == vals.tolist()
    want = jab.pack_planes(vals)
    assert all((to_u32(p) == w).all() for p, w in zip(planes, want))


@pytest.mark.parametrize("impl", SBOXES)
def test_sbox_circuit_vs_table_all_256(impl):
    vals = torch.arange(256, dtype=torch.int32)
    bits = [-((vals >> b) & 1) for b in range(8)]
    ones = torch.full_like(vals, -1)
    out = ab._sbox_bits(bits, ones, impl)
    got = sum(((o & 1) << b) for b, o in enumerate(out))
    assert got.tolist() == list(prf_ref.SBOX)


def test_circuit_modules_are_dpf_tpus():
    from dpf_tpu.core import aes_sbox_bp as jbp
    assert aes_sbox_bp._BOTTOM_OPS == jbp._BOTTOM_OPS
    assert aes_sbox_bp.N_OPS == jbp.N_OPS
    from dpf_tpu.core import aes_sbox_circuit as jasc
    assert (aes_sbox_circuit._OUT_MAT == jasc._OUT_MAT).all()


@pytest.mark.parametrize("sbox", SBOXES)
@pytest.mark.parametrize("n_pts", [1, 2, 4])
def test_bitsliced_equals_dpf_tpu_and_prf_ref(n_pts, sbox):
    s = _seeds(45, seed=n_pts)               # not a multiple of 32
    got = ab.aes128_multi_bitsliced(from_u32(s), n_pts, sbox)
    want = jab.aes128_multi_bitsliced(s, n_pts, sbox=sbox)
    gather = prf.aes128_multi(from_u32(s), range(n_pts))
    assert len(got) == n_pts
    for b in range(n_pts):
        assert (to_u32(got[b]) == np.asarray(want[b])).all()
        assert torch.equal(got[b], gather[b])
    for i in (0, 7, 44):
        seed = sum(int(s[i, k]) << (32 * k) for k in range(4))
        for b in range(n_pts):
            out = to_u32(got[b][i]).astype(np.uint64)
            val = sum(int(out[k]) << (32 * k) for k in range(4))
            assert val == prf_ref.prf_aes128(seed, b)


def test_leading_dims_and_pair():
    s = from_u32(_seeds(3 * 11)).reshape(3, 11, 4)
    a0, a1 = ab.aes128_pair_bitsliced(s)
    g0, g1 = prf.aes128_multi(s, range(2))
    assert a0.shape == (3, 11, 4)
    assert torch.equal(a0, g0) and torch.equal(a1, g1)


@pytest.mark.parametrize("impl", ["gather", "bitsliced", "bitsliced:tower",
                                  "bitsliced:chain"])
def test_prf_multi_takes_aes_impl(impl):
    s = from_u32(_seeds(40))
    for arity in (2, 4):
        got = prf.prf_multi(prf.PRF_AES128, s, arity, aes_impl=impl)
        want = prf.aes128_multi(s, range(arity))
        assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("radix,scheme", [(2, "logn"), (4, "logn"),
                                          (2, "sqrtn")])
def test_dpf_shares_equal_for_every_aes_impl(radix, scheme, monkeypatch):
    """The server's plain AES on CPU tensors takes the config's
    formulation (counted) and gives the same shares for every value."""
    calls = []
    real = ab.aes128_multi_bitsliced

    def counted(*args, **kwargs):
        calls.append(args[1])
        return real(*args, **kwargs)
    monkeypatch.setattr(ab, "aes128_multi_bitsliced", counted)
    n = 1024
    table = np.random.default_rng(5).integers(
        0, 2 ** 31, (n, 4)).astype(np.int32)
    shares = {}
    for impl in ("auto", "gather", "bitsliced", "bitsliced:bp",
                 "bitsliced:tower", "bitsliced:chain"):
        cfg = EvalConfig(radix=radix, scheme=scheme, aes_impl=impl)
        d = DPF(config=cfg, device="cpu")
        d.eval_init(table)
        k1, k2 = d.gen(77, n, seed=b"aes-impl")
        before = len(calls)
        shares[impl] = (d.eval_gpu([k1]), d.eval_gpu([k2]))
        used = len(calls) > before
        assert used == (impl.startswith("bitsliced") and scheme == "logn")
        rec = to_u32(shares[impl][0]) - to_u32(shares[impl][1])
        assert (rec.view(np.int32) == table[77]).all()
    for v in shares.values():
        assert torch.equal(v[0], shares["auto"][0])
        assert torch.equal(v[1], shares["auto"][1])


def test_bad_aes_impl_raises():
    with pytest.raises(ValueError, match="aes_impl"):
        EvalConfig(aes_impl="bitsliced:magic")
    with pytest.raises(ValueError, match="aes_impl"):
        EvalConfig(aes_impl="table")
    s = from_u32(_seeds(4))
    with pytest.raises(ValueError, match="aes_impl"):
        prf.prf_multi(prf.PRF_AES128, s, 2, aes_impl="bitslice")
    with pytest.raises(ValueError, match="aes_impl"):
        prf.prf_pair(prf.PRF_AES128, s, aes_impl="fast")
    with pytest.raises(ValueError, match="sbox"):
        ab.aes128_multi_bitsliced(s, 2, sbox="magic")


@pytest.mark.parametrize("radix", [2, 4])
def test_one_hot_and_points_take_aes_impl(radix, monkeypatch):
    """A CPU server passes its ``aes_impl`` to the one-hot expansion and
    the point walks (counted); a server on the card passes none."""
    calls = []
    real = ab.aes128_multi_bitsliced

    def counted(*args, **kwargs):
        calls.append(args[1])
        return real(*args, **kwargs)
    monkeypatch.setattr(ab, "aes128_multi_bitsliced", counted)
    n, idx = 256, np.array([0, 5, 77, 255])
    outs = {}
    for impl in ("gather", "bitsliced:bp"):
        d = DPF(config=EvalConfig(radix=radix, aes_impl=impl), device="cpu")
        keys = list(d.gen(77, n, seed=b"aes-impl-points"))
        before = len(calls)
        outs[impl] = (d.eval_one_hot(keys), d.eval_points(keys, idx))
        assert (len(calls) > before) == impl.startswith("bitsliced")
        assert d._plain_aes_impl() == impl
        d.device = torch.device("cuda", 0)       # what a card server holds
        assert d._plain_aes_impl() is None
    for a, b in zip(outs["gather"], outs["bitsliced:bp"]):
        assert torch.equal(a, b)
    hot = to_u32(outs["gather"][0][0]) - to_u32(outs["gather"][0][1])
    assert hot.view(np.int32).tolist() == [int(i == 77) for i in range(n)]
