"""The port's batched keygen against dpf_tpu's, byte for byte.

``keygen.gen_batched``, ``radix4.gen_batched_r4`` and
``sqrtn.gen_sqrt_batched`` must give the same wire keys as the JAX
package's generators for the same indices, seeds and knobs; each row
must equal the port's scalar generator for its seed; ``DPF.gen`` with
a list of indices and ``DPF.gen_batch`` must equal ``dpf_tpu``'s
``DPF.gen_batch``, and the keys must recover table rows.  Exact: all
values are integers mod 2^128.
"""

import numpy as np
import pytest
import torch

import dpf_tpu
import dpf_tpu_torch
from dpf_tpu.core import keygen as jkeygen
from dpf_tpu.core import radix4 as jradix4
from dpf_tpu.core import sqrtn as jsqrtn
from dpf_tpu.core import u128 as ju128
from dpf_tpu.utils.config import EvalConfig as JEvalConfig
from dpf_tpu_torch.core import keygen, radix4, sqrtn, u128
from dpf_tpu_torch.core.u32 import from_u32, to_u32
from dpf_tpu_torch.utils.config import EvalConfig

GENERATORS = {
    "binary": (keygen.gen_batched, jkeygen.gen_batched,
               lambda a, n, s, m: keygen.generate_keys(a, n, s, m)),
    "radix4": (radix4.gen_batched_r4, jradix4.gen_batched_r4,
               lambda a, n, s, m: radix4.generate_keys_r4(a, n, s, m)),
    "sqrtn": (sqrtn.gen_sqrt_batched, jsqrtn.gen_sqrt_batched,
              lambda a, n, s, m: sqrtn.generate_sqrt_keys(a, n, s, m)),
}
KNOBS = (None, {"prf_group": "stacked"}, {"path_reuse": "reuse"},
         {"squeeze_draws": 1}, {"squeeze_draws": 3},
         {"prf_group": "stacked", "path_reuse": "reuse", "squeeze_draws": 2})


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the suite runs several worker processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batch(n, bsz, tag):
    alphas = [(i * 0x9E3779B1 + 5) % n for i in range(bsz)]
    return alphas, [b"%s-%d-%d" % (tag, n, i) for i in range(bsz)]


@pytest.mark.parametrize("method", range(6))
@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_batched_wire_keys_identical(name, method):
    ours, theirs, scalar = GENERATORS[name]
    for n in (2, 8, 256, 4096, 8192):
        for bsz in (1, 4, 9):
            alphas, seeds = _batch(n, bsz, b"g%d" % method)
            wa, wb = ours(alphas, n, seeds, prf_method=method)
            ja, jb = theirs(alphas, n, seeds, prf_method=method)
            assert wa.dtype == torch.int32 and wa.shape == ja.shape
            assert (wa.numpy() == ja).all() and (wb.numpy() == jb).all(), \
                (name, n, bsz)
            # each row is the scalar generator's key for its seed
            for i in range(bsz):
                ka, kb = scalar(alphas[i], n, seeds[i], method)
                assert (wa[i].numpy() == ka.serialize()).all()
                assert (wb[i].numpy() == kb.serialize()).all()


@pytest.mark.parametrize("method", [0, 3, 5])
@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_batched_knobs_identical(name, method):
    """Every knob setting gives dpf_tpu's bytes with the same knobs, and
    the default's (N = 8192, odd depth; B = 4)."""
    ours, theirs, _ = GENERATORS[name]
    alphas, seeds = _batch(8192, 4, b"k")
    base = ours(alphas, 8192, seeds, prf_method=method)[0]
    for kn in KNOBS:
        wa, wb = ours(alphas, 8192, seeds, prf_method=method, knobs=kn)
        ja, jb = theirs(alphas, 8192, seeds, prf_method=method, knobs=kn)
        assert (wa.numpy() == ja).all() and (wb.numpy() == jb).all(), kn
        assert torch.equal(wa, base)


@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_batched_depths_and_beta(name):
    """Depth 1 (4 draws), odd depth 15 (radix-4's binary base level) and
    a beta other than 1."""
    ours, theirs, _ = GENERATORS[name]
    for n, beta in ((2, 1), (8, 7), (1 << 15, 1), (1 << 15, (1 << 100) + 3)):
        alphas, seeds = _batch(n, 4, b"d")
        wa, wb = ours(alphas, n, seeds, prf_method=2, beta=beta)
        ja, jb = theirs(alphas, n, seeds, prf_method=2, beta=beta)
        assert (wa.numpy() == ja).all() and (wb.numpy() == jb).all(), n


def test_drbg_batch_identical():
    seeds = [b"a", b"bb" * 40, bytes(range(128))]
    for sq in (None, 1, 5):
        got = keygen.drbg_u128_batch(seeds, 70, squeeze_draws=sq)
        want = jkeygen.drbg_u128_batch(seeds, 70, squeeze_draws=sq)
        assert got.shape == (3, 70, 4) and (to_u32(got) == want).all()


@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_batched_validation_errors_match(name):
    ours, theirs, _ = GENERATORS[name]
    bad = (([], 16, None, ValueError), ([1], 12, [b"s"], ValueError),
           ([16], 16, [b"s"], ValueError), ([-1], 16, [b"s"], ValueError),
           ([1, 2], 16, b"ss", TypeError), ([1, 2], 16, [b"s"], ValueError),
           ([1], 16, ["s"], TypeError))
    for alphas, n, seeds, exc in bad:
        with pytest.raises(exc) as got:
            ours(alphas, n, seeds, prf_method=0)
        with pytest.raises(exc) as want:
            theirs(alphas, n, seeds, prf_method=0)
        assert str(got.value) == str(want.value), (alphas, n, seeds)


def test_fresh_seeds_differ():
    wa, _ = keygen.gen_batched([3, 3], 64, prf_method=0)
    assert not torch.equal(wa[0], wa[1])


def test_u128_ops_match_dpf_tpu():
    rng = np.random.default_rng(7)
    edge = [0, 1, 2 ** 32 - 1, 2 ** 32, 2 ** 127, 2 ** 128 - 1, 2 ** 96 - 1]
    vals = edge + [int.from_bytes(rng.bytes(16), "little")
                   for _ in range(25)]
    a_np = ju128.ints_to_limbs([x for x in vals for _ in vals])
    b_np = ju128.ints_to_limbs([y for _ in vals for y in vals])
    a, b = from_u32(a_np), from_u32(b_np)
    for ours, theirs in ((u128.sub128, ju128.sub128),
                         (u128.mul128, ju128.mul128),
                         (u128.add128, ju128.add128)):
        assert (to_u32(ours(a, b)) == theirs(a_np, b_np)).all()
    assert (to_u32(u128.neg128(a)) == ju128.neg128(a_np)).all()
    assert (to_u32(u128.lsb(a)) == ju128.lsb(a_np)).all()
    assert (to_u32(u128.low32(a)) == ju128.low32(a_np)).all()
    m = (1 << 128) - 1
    got = u128.limbs_to_ints(to_u32(u128.mul128(a, b)))
    assert got == [(x * y) & m for x in vals for y in vals]


def test_packed_keys_slice():
    wa, _ = keygen.gen_batched(list(range(5)), 64, [b"%d" % i for i in
                                                    range(5)], prf_method=0)
    pk = keygen.decode_keys_batched(wa.numpy())
    part = pk.slice(1, 4)
    assert part.batch == 3 and (part.last == pk.last[1:4]).all()
    assert (part.cw1 == pk.cw1[1:4]).all() and part.n == 64


@pytest.mark.parametrize("config", [{}, {"radix": 4}, {"scheme": "sqrtn"}],
                         ids=["binary", "radix4", "sqrtn"])
def test_dpf_gen_batch_matches_dpf_tpu(config):
    """``gen([...])`` and ``gen_batch`` against dpf_tpu's ``gen_batch``,
    strict=False at N = 300 (keys over 512), then recovery through
    ``eval_gpu`` on the CPU."""
    n, idx = 300, [0, 7, 299, 150, 42]
    seeds = [b"gb%d" % i for i in idx]
    ours = dpf_tpu_torch.DPF(prf=2, strict=False, device="cpu",
                             config=EvalConfig(**config))
    theirs = dpf_tpu.DPF(prf=2, strict=False,
                         config=JEvalConfig(**config))
    ja, jb = theirs.gen_batch(idx, n, seeds=seeds)
    for got in (ours.gen(idx, n, seed=seeds),
                ours.gen_batch(np.array(idx), n, seeds=seeds),
                ours.gen_batch(torch.tensor(idx), n, seeds=seeds)):
        assert (got[0].numpy() == np.asarray(ja)).all()
        assert (got[1].numpy() == np.asarray(jb)).all()
    for i, (k, s) in enumerate(zip(idx, seeds)):
        assert torch.equal(ours.gen(k, n, seed=s)[0], got[0][i])
    table = np.random.default_rng(3).integers(
        -2 ** 31, 2 ** 31, (n, 16), dtype=np.int64).astype(np.int32)
    ours.eval_init(table)
    rec = (ours.eval_gpu(got[0]) - ours.eval_gpu(got[1])).numpy()
    assert (rec == table[idx]).all()
    with pytest.raises(ValueError, match="less than n"):
        ours.gen_batch([300], n)
