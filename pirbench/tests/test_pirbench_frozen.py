"""The frozen copies held to their sources at small sizes: the ciphers,
the key generator and wire codec, the plain reference, the trace
arithmetic, the quantile, the size draw and the work functions."""

import random

import numpy as np
import pytest
import torch

from pirbench.harness import devtrace, loadgen, spec, stats
from pirbench.harness.peaks import PEAK_BYTES_PER_S, PEAK_INSTR_PER_S

CIPHERS = (("aes128", 3), ("chacha20", 2))


def _limbs(xs):
    return torch.tensor([[(x >> (32 * i)) & 0xFFFFFFFF for i in range(4)]
                         for x in xs], dtype=torch.int64)


@pytest.mark.parametrize("name,pid", CIPHERS)
def test_cipher_matches_program_prf(name, pid):
    from dpf_tpu_torch.core.prf_ref import PRF_FUNCS
    rng = random.Random(pid)
    seeds = [rng.getrandbits(128) for _ in range(40)] + [0, (1 << 128) - 1]
    pair = spec.cipher(name).prf_pair(_limbs(seeds))
    for pos in (0, 1):
        assert torch.equal(pair[pos], _limbs([PRF_FUNCS[pid](s, pos)
                                              for s in seeds]))


def test_aes_fips197_vector():
    aes = spec.cipher("aes128")
    key = torch.tensor([list(range(16))])
    pt = torch.tensor([list(bytes.fromhex(
        "00112233445566778899aabbccddeeff"))])
    assert bytes(aes.encrypt(key, pt)[0].tolist()).hex() == \
        "69c4e0d86a7b0430d8cdb78070b4c55a"


@pytest.mark.parametrize("name,pid", CIPHERS)
@pytest.mark.parametrize("n", [4, 1 << 9])
def test_keygen_is_the_programs(name, pid, n):
    from dpf_tpu_torch.core import keygen
    logn = spec.construction("logn")
    alphas = np.array([0, n - 1, n // 3, 1])
    seeds = [b"frozen-%d" % i for i in range(4)]
    a, b = logn.gen(alphas, n, seeds, spec.cipher(name))
    wa, wb = keygen.gen_batched(alphas, n, seeds, prf_method=pid)
    assert np.array_equal(a, wa.numpy()) and np.array_equal(b, wb.numpy())
    assert a.shape == (4, logn.WIRE_WORDS)


@pytest.mark.parametrize("name,pid", CIPHERS)
def test_reference_matches_program_and_recovers(name, pid):
    from dpf_tpu_torch.api import DPF
    logn = spec.construction("logn")
    c = spec.cipher(name)
    n = 1 << 9
    table = np.random.default_rng(pid).integers(
        -2 ** 31, 2 ** 31, (n, 16)).astype(np.int32)
    alphas = np.array([3, 500, 77])
    k0, k1 = logn.gen(alphas, n, [b"r%d" % i for i in range(3)], c)
    ref0 = logn.shares(k0, torch.from_numpy(table), c, keys_per_block=2)
    ref1 = logn.shares(k1, torch.from_numpy(table), c)
    d = DPF(prf=pid, device="cpu")
    d.eval_init(table)
    assert np.array_equal(ref0, d.eval_cpu(list(torch.from_numpy(k0)))
                          .numpy())
    rec = (ref0.astype(np.int64) - ref1) & 0xFFFFFFFF
    assert np.array_equal(rec, table[alphas].astype(np.int64) & 0xFFFFFFFF)
    ctl = logn.shares(k0, torch.from_numpy(table), c, control=True)
    assert (ctl != ref0).mean() > 0.9


def test_bit_reverse_is_the_programs():
    from dpf_tpu_torch.core import u128
    logn = spec.construction("logn")
    for n in (4, 1 << 10):
        assert np.array_equal(logn.bit_reverse(n).numpy(),
                              u128.bit_reverse_indices(n).astype(np.int64))


def test_quantile_is_the_programs():
    from dpf_tpu_torch.utils.profiling import quantile
    rng = np.random.default_rng(0)
    for size in (1, 2, 7, 100, 1001):
        xs = list(rng.exponential(1.0, size))
        for q in (0.0, 0.5, 0.95, 0.99, 1.0):
            assert stats.quantile(xs, q) == quantile(xs, q)


def test_size_draw_is_the_programs():
    from dpf_tpu_torch.serve import loadgen as port
    a, b = np.random.default_rng(5), np.random.default_rng(5)
    ours = loadgen.log_uniform_sizes(a, 500, 1, 512)
    theirs = [port._draw_batch(b, 1, 512) for _ in range(500)]
    assert ours.tolist() == theirs


def test_schedule_is_the_traffic_files():
    traffic = {"rate_per_s": 50.0, "shape_seed": 9, "keys_min": 1,
               "keys_max": 512}
    t1, s1 = loadgen.poisson_schedule(traffic, 10.0)
    t2, s2 = loadgen.poisson_schedule(traffic, 10.0)
    assert len(t1) == 500 and np.array_equal(t1, t2)
    assert np.array_equal(s1, s2)
    assert 0 < t1[0] and t1[-1] < 10.0 and (np.diff(t1) > 0).all()
    assert s1.min() >= 1 and s1.max() <= 512
    t3, s3 = loadgen.poisson_schedule(dict(traffic, shape_seed=10), 10.0)
    assert not np.array_equal(s1, s3)


def test_trace_categories_are_the_programs():
    from dpf_tpu_torch.utils.profiling import DEVICE_CATEGORIES
    assert tuple(devtrace.DEVICE_CATEGORIES) == tuple(DEVICE_CATEGORIES)


def test_trace_reduction():
    events = [("kernel", "k1", 10.0, 5.0), ("kernel", "k1", 14.0, 4.0),
              ("gpu_memcpy", "copy", 30.0, 2.0), ("kernel", "k2", 95.0, 10.0)]
    prog = [("submit", 18.0, 29.0), ("pack", 19.0, 25.0)]
    cli = [("client.sleep", 40.0, 90.0)]
    r = devtrace.reduce(events, 0.0, 100.0, prog, cli)
    assert r["busy_s"] == pytest.approx((8 + 2 + 5) / 1e6)
    assert r["kernel_s"] == pytest.approx(14 / 1e6)
    assert r["window_s"] == pytest.approx(100 / 1e6)
    assert r["device_ops"][0] == ["k1", pytest.approx(9 / 1e6)]
    idle = {k.split(" (")[0]: v for k, v in r["idle_gaps"]}
    assert idle["none"] == pytest.approx(10 / 1e6)        # [0, 10)
    assert idle["pack"] == pytest.approx(12 / 1e6)        # [18, 30)
    assert idle["client.sleep"] == pytest.approx(63 / 1e6)  # [32, 95)


def _chip_smoke():
    import importlib.util
    from pirbench.harness.spec import ROOT
    sp = importlib.util.spec_from_file_location("chip_smoke_consts",
                                                ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(sp)
    sp.loader.exec_module(mod)
    return mod


def test_work_against_the_programs_bounds():
    """B = 512, N = 2^20, E = 16, one request: the frozen work beside the
    counts ``chip_smoke.py`` prices K1, K2 and K3 with.  The frozen work
    counts no intermediate bytes (K1's seeds between levels, K3's
    low-limb plane), one instruction a multiply-add (K3 and K2 count
    two), and at the leaves of ChaCha20 12 instructions fewer."""
    cs = _chip_smoke()
    assert cs.PEAK_INSTR_PER_S == PEAK_INSTR_PER_S
    assert cs.PEAK_BYTES_PER_S == PEAK_BYTES_PER_S
    b, n, e = 512, 1 << 20, 16
    aes = spec.work("logn_aes128").work(n, e, b, 1)
    k1_ops = b * (n - 1) * cs.OPS_AES_NODE - b * n * cs.OPS_AES_LOW_SAVED
    k3_ops = 2 * b * n * e
    assert aes["ops"] == k1_ops + k3_ops // 2
    k3_bytes = b * n * 4 + n * e * 4 + 4 * b * e * 4
    assert aes["bytes"] < k3_bytes
    assert aes["bytes"] == n * e * 4 + b * ((4 * 20 + 1) * 16 + e * 4)
    cha = spec.work("logn_chacha20").work(n, e, b, 1)
    k2_ops = b * ((n - 1) * (2 * cs.OPS_CORE_BLOCK + 2 * cs.OPS_CHILD_ADD)
                  + n * e * 2)
    assert cha["ops"] == k2_ops - b * n * (12 + e)
    assert 0.97 < cha["ops"] / k2_ops < 1.0
