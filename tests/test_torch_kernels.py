"""The port's kernel modules against dpf_tpu, on the CPU.

Each module that holds a CUDA kernel keeps a plain PyTorch version; on
CPU tensors the kernel's wrapper takes it.  Here the plain versions are
held against the JAX functions they port, bit for bit.  The tests that
launch the CUDA kernels need a card and skip without one.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dpf_tpu.core import evalref as jevalref
from dpf_tpu.core import expand as jexpand
from dpf_tpu.core import keygen as jkeygen
from dpf_tpu.ops import aes_planes
from dpf_tpu.ops import matmul128 as jmatmul
from dpf_tpu.utils.compat import has_tpu_interpret_mode
from dpf_tpu_torch.core import expand
from dpf_tpu_torch.core.u32 import from_u32, to_u32
from dpf_tpu_torch.ops import aes_level, cuda_build, matmul128, subtree


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


def _keys(n, count, method, seed=b"kern"):
    flat = [jkeygen.generate_keys((i * 131 + 7) % n, n, seed + b"%d" % i,
                                  method)[i % 2] for i in range(count)]
    return flat, jexpand.pack_keys(flat)


def _oracle(flat, table, method):
    """dpf_tpu's numpy one-hot oracle times the table, mod 2^32."""
    hots = np.stack([jevalref.eval_one_hot_i32(k, method) for k in flat])
    return (hots.view(np.uint32) @ table.view(np.uint32)).view(np.int32)


def test_plain_aes_level_matches_aes_level_step_ref():
    rng = np.random.default_rng(3)
    seeds = _rand_u32(rng, 32, 2, 4)
    cw1, cw2 = _rand_u32(rng, 32, 2, 4), _rand_u32(rng, 32, 2, 4)
    want = np.asarray(aes_planes.aes_level_step_ref(
        jnp.asarray(seeds), jnp.asarray(cw1), jnp.asarray(cw2), arity=2))
    args = [from_u32(x) for x in (seeds, cw1, cw2)]
    assert (to_u32(aes_level.aes_level_step_plain(*args)) == want).all()
    # the wrapper takes the plain version for CPU tensors
    assert (to_u32(aes_level.aes_level_step(*args)) == want).all()


@pytest.mark.parametrize("arity", [2, 4])
def test_aes_level_low32_matches_aes_level_step_ref(arity):
    """K1's low-limb form on the CPU: limb 0 of dpf_tpu's level step, as
    one contiguous [B, a*w] plane."""
    rng = np.random.default_rng(30 + arity)
    seeds = _rand_u32(rng, 32, 3, 4)
    cw1, cw2 = _rand_u32(rng, 32, arity, 4), _rand_u32(rng, 32, arity, 4)
    want = np.asarray(aes_planes.aes_level_step_ref(
        jnp.asarray(seeds), jnp.asarray(cw1), jnp.asarray(cw2),
        arity=arity))[..., 0]
    args = [from_u32(x) for x in (seeds, cw1, cw2)]
    got = aes_level.aes_level_step(*args, arity=arity, low32=True)
    assert tuple(got.shape) == (32, 3 * arity) and got.is_contiguous()
    assert (to_u32(got) == want).all()
    assert torch.equal(got, aes_level.aes_level_step_plain(*args, arity,
                                                           low32=True))


@pytest.mark.parametrize("method", [0, 2, 3])
def test_level_step_low32_matches_dpf_tpu(method):
    """The port's level step in its low-limb form (K1 for AES, the plain
    step otherwise): limb 0 of dpf_tpu's level step, contiguous."""
    rng = np.random.default_rng(40 + method)
    seeds = _rand_u32(rng, 3, 5, 4)
    cw1, cw2 = _rand_u32(rng, 3, 64, 4), _rand_u32(rng, 3, 64, 4)
    want = np.asarray(jexpand._level_step(
        jnp.asarray(seeds), jnp.asarray(cw1), jnp.asarray(cw2), 9,
        method))[..., 0]
    got = expand.level_step(*(from_u32(x) for x in (seeds, cw1, cw2)), 9,
                            method, low32=True)
    assert tuple(got.shape) == (3, 10) and got.is_contiguous()
    assert (to_u32(got) == want).all()


def test_aes_level_wrapper_checks_layout():
    seeds = torch.zeros(2, 4, 4, dtype=torch.int32)
    cw = torch.zeros(2, 64, 4, dtype=torch.int32)
    with pytest.raises(ValueError, match="contiguous"):
        aes_level.aes_level_step(seeds[:, ::2], cw[:, 0:2], cw[:, 0:2])
    with pytest.raises(ValueError, match=r"\[B, 2, 4\]"):
        aes_level.aes_level_step(seeds, cw[:, 0:3], cw[:, 0:3])
    with pytest.raises(TypeError):
        aes_level.aes_level_step(seeds.long(), cw[:, 0:2], cw[:, 0:2])


@pytest.mark.parametrize("method", subtree.SUBTREE_PRFS)
def test_plain_subtree_matches_xla_expand_and_contract(method):
    """Frontier from dpf_tpu's phase 1 (f_levels = 1), the port's plain
    subtree contraction over it, against the JAX XLA path end to end."""
    n, chunk, depth = 128, 64, 7
    flat, (cw1, cw2, last) = _keys(n, 3, method)
    table = np.random.default_rng(method).integers(
        -2 ** 31, 2 ** 31, (n, 5), dtype=np.int64).astype(np.int32)
    tperm = jexpand.permute_table(table)
    want = np.asarray(jexpand.expand_and_contract(
        cw1, cw2, last, jnp.asarray(tperm), depth=depth, prf_method=method,
        chunk_leaves=chunk, kernel_impl="xla"))
    frontier = jexpand._level_step(jnp.asarray(last)[:, None, :],
                                   jnp.asarray(cw1), jnp.asarray(cw2),
                                   depth - 1, method)
    args = [from_u32(np.asarray(x)) for x in (frontier, cw1, cw2)]
    tp = torch.from_numpy(tperm)
    for block in (None, 16, 64):
        got = subtree.subtree_contract_plain(
            *args, tp, depth=depth, f_levels=1, prf_method=method,
            block_leaves=block)
        assert (got.numpy() == want).all(), block
    got = subtree.subtree_contract(*args, tp, depth=depth, f_levels=1,
                                   prf_method=method)
    assert (got.numpy() == want).all()
    assert (want == _oracle(flat, table, method)).all()


@pytest.mark.skipif(not has_tpu_interpret_mode(),
                    reason="pltpu.force_tpu_interpret_mode unavailable "
                           "(jax >= 0.4.38)")
@pytest.mark.parametrize("method", [1, 2])
def test_plain_subtree_matches_pallas_interpret(method):
    from jax.experimental.pallas import tpu as pltpu

    from dpf_tpu.ops import pallas_level
    n, chunk, depth = 128, 64, 7
    _, (cw1, cw2, last) = _keys(n, 2, method, seed=b"pal")
    table = np.random.default_rng(5).integers(
        -2 ** 31, 2 ** 31, (n, 16), dtype=np.int64).astype(np.int32)
    tperm = jexpand.permute_table(table)
    frontier = jexpand._level_step(jnp.asarray(last)[:, None, :],
                                   jnp.asarray(cw1), jnp.asarray(cw2),
                                   depth - 1, method)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(pallas_level.subtree_contract_pallas(
            frontier, jnp.asarray(cw1), jnp.asarray(cw2), jnp.asarray(tperm),
            depth=depth, f_levels=1, prf_method=method))
    got = subtree.subtree_contract_plain(
        *[from_u32(np.asarray(x)) for x in (frontier, cw1, cw2)],
        torch.from_numpy(tperm), depth=depth, f_levels=1, prf_method=method)
    assert (got.numpy() == want).all()


def test_subtree_wrapper_rejects_bad_input():
    z = torch.zeros
    fr, cw, tb = z(2, 1, 4, dtype=torch.int32), z(2, 64, 4, dtype=torch.int32), \
        z(128, 4, dtype=torch.int32)
    with pytest.raises(ValueError, match="PRF"):
        subtree.subtree_contract(fr, cw, cw, tb, depth=7, f_levels=0,
                                 prf_method=3)
    with pytest.raises(ValueError, match="depth"):
        subtree.subtree_contract(fr, cw, cw, tb, depth=6, f_levels=0,
                                 prf_method=2)
    with pytest.raises(ValueError, match="contiguous"):
        subtree.subtree_contract(fr, cw, cw, z(4, 128, dtype=torch.int32).t(),
                                 depth=7, f_levels=0, prf_method=2)
    assert subtree.subtree_chunk_leaves(1 << 20) == 4096
    assert subtree.subtree_chunk_leaves(128) == 128


@pytest.mark.parametrize("method", [0, 3])
def test_expand_and_contract_grouped_routes(method, monkeypatch):
    """AES (level steps over frontier groups) and DUMMY (one frontier
    subtree at a time), with several groups forced, against dpf_tpu's
    numpy oracle."""
    n, depth = 256, 8
    flat, packed = _keys(n, 3, method, seed=b"grp")
    table = np.random.default_rng(8).integers(
        -2 ** 31, 2 ** 31, (n, 3), dtype=np.int64).astype(np.int32)
    cw1, cw2, last = (from_u32(x) for x in packed)
    tp = torch.from_numpy(expand.permute_table(table))
    want = _oracle(flat, table, method)
    for groups in (1, 2):
        monkeypatch.setattr(expand, "choose_group", lambda f, c, g=groups: g)
        got = expand.expand_and_contract(cw1, cw2, last, tp, depth=depth,
                                         prf_method=method, chunk_leaves=64)
        assert (got.numpy() == want).all(), groups
    with pytest.raises(ValueError, match="chunk_leaves"):
        expand.expand_and_contract(cw1, cw2, last, tp, depth=depth,
                                   prf_method=method, chunk_leaves=48)


def test_dot_i32_plain_wraps_exactly():
    rng = np.random.default_rng(4)
    a = _rand_u32(rng, 5, 300).view(np.int32)
    b = _rand_u32(rng, 300, 7).view(np.int32)
    a[0, :2], b[:2, 0] = [2 ** 31 - 1, -5], [3, 2 ** 30]
    want = (a.view(np.uint32) @ b.view(np.uint32)).view(np.int32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    assert (matmul128.dot_i32_plain(ta, tb).numpy() == want).all()
    assert (matmul128._dot_i32_sliced(ta, tb).numpy() == want).all()
    assert (matmul128.dot_i32(ta, tb).numpy() == want).all()
    assert (np.asarray(jmatmul.dot_i32(jnp.asarray(a), jnp.asarray(b)))
            == want).all()
    assert int(matmul128.dot_i32_plain(
        torch.tensor([[2 ** 31 - 1, -5]], dtype=torch.int32),
        torch.tensor([[3], [2 ** 30]], dtype=torch.int32))) == 1073741821
    # strided left operand: the low limbs of [B, K, 4] leaves
    leaves = torch.from_numpy(_rand_u32(rng, 5, 300, 4).view(np.int32))
    lo = leaves[..., 0]
    assert torch.equal(matmul128.dot_i32(lo, tb),
                       matmul128.dot_i32_plain(lo.contiguous(), tb))
    with pytest.raises(ValueError, match="contiguous"):
        matmul128.dot_i32(ta, tb.t().contiguous().t())
    with pytest.raises(ValueError, match="contract"):
        matmul128.dot_i32(ta, tb[:299])


def test_cuda_build_names_and_missing_nvcc(monkeypatch, tmp_path):
    names = {n: cuda_build.library_path(n) for n in cuda_build.SOURCES}
    for n, p in names.items():
        assert p.name.startswith(n + "-") and p.suffix == ".so"
        assert (cuda_build.CSRC_DIR / (n + ".cu")).exists()
    assert cuda_build.build(()) == {}
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        cuda_build.nvcc_path()


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")


def test_cuda_kernels_match_plain_versions():
    """On a card: each kernel bit-equal to its plain version, and each
    wrapper's launch counter moved."""
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(1)

    def rnd(*shape):
        return torch.randint(-2 ** 31, 2 ** 31, shape, dtype=torch.int64,
                             device="cuda", generator=g).to(torch.int32)

    before = (aes_level.aes_level_step.launches,
              subtree.subtree_contract.launches, matmul128.dot_i32.launches)
    seeds, cw1, cw2 = rnd(33, 70, 4), rnd(33, 64, 4), rnd(33, 64, 4)
    assert torch.equal(
        aes_level.aes_level_step(seeds, cw1[:, 4:6], cw2[:, 4:6]),
        aes_level.aes_level_step_plain(seeds, cw1[:, 4:6], cw2[:, 4:6]))
    a, t = rnd(33, 1000), rnd(1000, 5)
    assert torch.equal(matmul128.dot_i32(a, t), matmul128.dot_i32_plain(a, t))
    for method in subtree.SUBTREE_PRFS:
        fr, tbl = rnd(3, 2, 4), rnd(1 << 12, 16)
        kw = dict(depth=12, f_levels=1, prf_method=method, block_leaves=512)
        assert torch.equal(
            subtree.subtree_contract(fr, cw1[:3], cw2[:3], tbl, **kw),
            subtree.subtree_contract_plain(fr, cw1[:3], cw2[:3], tbl, **kw))
    after = (aes_level.aes_level_step.launches,
             subtree.subtree_contract.launches, matmul128.dot_i32.launches)
    assert [x - y for x, y in zip(after, before)] == [1, 4, 1]
