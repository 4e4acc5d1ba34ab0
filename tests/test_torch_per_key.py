"""The port's per-key-table evaluations against dpf_tpu's, on the CPU.

Batch-PIR gives every key its own table (one bin of a binned table), so
the three constructions each have a per-key-table form: the binary tree
(``expand.expand_and_contract_per_key_tables``), the radix-4 tree
(``radix4.expand_and_contract_per_key_tables_mixed``) and the sqrt-N
grid (``sqrtn.eval_contract_per_key_tables``).  Every comparison is bit
for bit (integers mod 2^32 get no tolerance).  Inputs come from numpy
seeds and are handed to both packages.  Few distinct shapes reach JAX:
each is a compile on the one-core XLA CPU backend.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dpf_tpu.core import expand as jexpand
from dpf_tpu.core import radix4 as jr4
from dpf_tpu.core import sqrtn as jsqrtn
from dpf_tpu_torch.core import expand, keygen, radix4, sqrtn
from dpf_tpu_torch.core.u32 import from_u32
from dpf_tpu_torch.ops import matmul128, sqrt_grid, subtree


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch's CPU ops on one thread here: the suite runs several worker
    processes side by side."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _i32(rng, *shape):
    return rng.integers(-2 ** 31, 2 ** 31, shape,
                        dtype=np.int64).astype(np.int32)


def _wire(construction, n, g, prf, seed):
    """g distinct keys of one server, as the batched generators mint them
    (byte-equal to dpf_tpu's, tests/test_torch_gen_batch.py)."""
    alphas = [(i * 37 + seed) % n for i in range(g)]
    seeds = [b"pkt-%d-%d" % (seed, i) for i in range(g)]
    if construction == "sqrtn":
        wa, _ = sqrtn.gen_sqrt_batched(alphas, n, seeds, prf_method=prf)
    elif construction == "radix4":
        wa, _ = radix4.gen_batched_r4(alphas, n, seeds, prf_method=prf)
    else:
        wa, _ = keygen.gen_batched(alphas, n, seeds, prf_method=prf)
    return wa.numpy()


def _permuted(construction, tables):
    """Each key's table in its construction's leaf order."""
    n = tables.shape[1]
    if construction == "sqrtn":
        return tables
    if construction == "radix4":
        perm = radix4.mixed_reverse_indices(radix4.arities(n))
    else:
        from dpf_tpu_torch.core import u128
        perm = u128.bit_reverse_indices(n)
    return np.ascontiguousarray(tables[:, perm])


def _both(construction, n, g, prf, seed, e=4, chunk=None):
    """(dpf_tpu's shares, the port's shares) of one per-key batch."""
    rng = np.random.default_rng(seed)
    tables = _permuted(construction, _i32(rng, g, n, e))
    wire = _wire(construction, n, g, prf, seed)
    tt = torch.from_numpy(tables)
    if construction == "sqrtn":
        pk = sqrtn.decode_sqrt_keys_batched(wire)
        want = jsqrtn.eval_contract_per_key_tables(
            jnp.asarray(pk.seeds), jnp.asarray(pk.cw1), jnp.asarray(pk.cw2),
            jnp.asarray(tables), prf_method=prf, dot_impl="i32")
        got = sqrtn.eval_contract_per_key_tables(
            from_u32(pk.seeds), from_u32(pk.cw1), from_u32(pk.cw2), tt,
            prf_method=prf)
        return np.asarray(want), got.numpy()
    chunk = chunk or expand.choose_chunk(n, g)
    decode = (radix4.decode_mixed_keys_batched if construction == "radix4"
              else keygen.decode_keys_batched)
    pk = decode(wire)
    jargs = [jnp.asarray(a) for a in (pk.cw1, pk.cw2, pk.last)]
    targs = [from_u32(a) for a in (pk.cw1, pk.cw2, pk.last)]
    knobs = dict(dot_impl="i32", aes_impl="gather", round_unroll=False)
    if construction == "radix4":
        want = jr4.expand_and_contract_per_key_tables_mixed(
            *jargs, jnp.asarray(tables), n=n, prf_method=prf,
            chunk_leaves=chunk, **knobs)
        got = radix4.expand_and_contract_per_key_tables_mixed(
            *targs, tt, n=n, prf_method=prf, chunk_leaves=chunk)
    else:
        depth = n.bit_length() - 1
        want = jexpand.expand_and_contract_per_key_tables(
            *jargs, jnp.asarray(tables), depth=depth, prf_method=prf,
            chunk_leaves=chunk, **knobs)
        got = expand.expand_and_contract_per_key_tables(
            *targs, tt, depth=depth, prf_method=prf, chunk_leaves=chunk)
    return np.asarray(want), got.numpy()


# each PRF id once a construction, at n in {128, 256, 512} (depths 7 and
# 9 are odd: the radix-4 tree takes a binary level) and G in 1..5
CASES = [(0, 128, 3), (1, 256, 5), (2, 512, 1), (3, 128, 5), (4, 512, 3),
         (5, 256, 2)]


@pytest.mark.parametrize("construction", ["binary", "radix4", "sqrtn"])
@pytest.mark.parametrize("prf,n,g", CASES)
def test_per_key_tables_match_dpf_tpu(construction, prf, n, g):
    want, got = _both(construction, n, g, prf, seed=prf * 10 + g)
    assert got.shape == (g, 4) and got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("construction", ["binary", "radix4"])
def test_per_key_tables_aes_groups_match_dpf_tpu(construction):
    """AES over 8 frontier groups of 64 leaves: K1 per level and one K6
    contraction per group, each against its group's rows of every
    key's table."""
    want, got = _both(construction, 512, 3, 3, seed=77, chunk=64)
    np.testing.assert_array_equal(got, want)


def _dot_ref(a, t):
    return (a.astype(np.int64)[:, :, None] * t.astype(np.int64)).sum(
        axis=1).astype(np.uint64).astype(np.uint32).view(np.int32)


@pytest.mark.parametrize("bsz,k,e", [(1, 7, 1), (3, 300, 16), (5, 64, 3),
                                     (2, 1000, 20)])
def test_dot_i32_per_key_plain_wraps_like_numpy(bsz, k, e):
    rng = np.random.default_rng(bsz * 100 + k + e)
    a, t = _i32(rng, bsz, k), _i32(rng, bsz, k, e)
    a[0, 0], t[0, 0, 0] = 2 ** 31 - 1, -2 ** 31    # wrap-around values
    want = _dot_ref(a, t)
    at, tt = torch.from_numpy(a), torch.from_numpy(t)
    np.testing.assert_array_equal(matmul128.dot_i32_per_key(at, tt).numpy(),
                                  want)
    # the form the plain version takes on the card (int64 slices)
    np.testing.assert_array_equal(
        matmul128._dot_i32_sliced(at, tt).numpy(), want)


def test_dot_i32_per_key_takes_strided_leaves_and_row_chunks():
    """Leaves at element stride 4 (the low limbs of [B, C, 4] leaves) and
    a chunk of rows of [B, N, E] tables (keys N E words apart)."""
    rng = np.random.default_rng(5)
    leaves = torch.from_numpy(_i32(rng, 3, 64, 4))[..., 0]
    tables = torch.from_numpy(_i32(rng, 3, 256, 8))
    chunk = tables[:, 128:192]
    assert leaves.stride(1) == 4 and not chunk.is_contiguous()
    np.testing.assert_array_equal(
        matmul128.dot_i32_per_key(leaves, chunk).numpy(),
        _dot_ref(leaves.numpy(), chunk.numpy()))


def test_dot_i32_per_key_rejects_what_the_kernel_does_not_take():
    a = torch.zeros(2, 8, dtype=torch.int32)
    with pytest.raises(ValueError, match="do not contract"):
        matmul128.dot_i32_per_key(a, torch.zeros(3, 8, 4, dtype=torch.int32))
    with pytest.raises(ValueError, match="contiguous"):
        matmul128.dot_i32_per_key(
            a, torch.zeros(2, 4, 8, dtype=torch.int32).transpose(1, 2))
    with pytest.raises(TypeError):
        matmul128.dot_i32_per_key(a.long(),
                                  torch.zeros(2, 8, 4, dtype=torch.int32))


def _keys(rng, bsz, f_cnt):
    return (torch.from_numpy(_i32(rng, bsz, f_cnt, 4)),
            torch.from_numpy(_i32(rng, bsz, 64, 4)),
            torch.from_numpy(_i32(rng, bsz, 64, 4)))


@pytest.mark.parametrize("prf", subtree.SUBTREE_PRFS)
@pytest.mark.parametrize("bsz,depth,f_levels,cb", [
    (1, 7, 0, 128), (3, 8, 1, 32), (5, 7, 0, 2), (11, 9, 0, 64)])
def test_subtree_per_key_plain_is_each_keys_shared_answer(prf, bsz, depth,
                                                          f_levels, cb):
    """K2's plain per-key mode: key b's share is its share against
    table b alone, for 3, 5 and 11 keys and a block of 2 leaves."""
    rng = np.random.default_rng(prf * 100 + bsz)
    n = 1 << depth
    fr, cw1, cw2 = _keys(rng, bsz, 1 << f_levels)
    tables = torch.from_numpy(_i32(rng, bsz, n, 3))
    kw = dict(depth=depth, f_levels=f_levels, prf_method=prf,
              block_leaves=cb)
    got = subtree.subtree_contract(fr, cw1, cw2, tables, **kw)
    for b in range(bsz):
        assert torch.equal(got[b], subtree.subtree_contract_plain(
            fr[b:b + 1], cw1[b:b + 1], cw2[b:b + 1], tables[b], **kw)[0])


@pytest.mark.parametrize("prf", subtree.SUBTREE_PRFS)
@pytest.mark.parametrize("bsz,depth,f_lv,cb", [
    (3, 7, 0, 16), (5, 8, 1, 16), (2, 9, 0, 512)])
def test_subtree_mixed_per_key_plain_is_each_keys_shared_answer(
        prf, bsz, depth, f_lv, cb):
    rng = np.random.default_rng(prf * 100 + bsz + 7)
    n = 1 << depth
    ars = radix4.arities(n)
    fr, cw1, cw2 = _keys(rng, bsz, int(np.prod(ars[:f_lv])))
    tables = torch.from_numpy(_i32(rng, bsz, n, 5))
    kw = dict(ars=ars, f_lv=f_lv, prf_method=prf, block_leaves=cb)
    got = subtree.subtree_contract_mixed(fr, cw1, cw2, tables, **kw)
    for b in range(bsz):
        assert torch.equal(got[b], subtree.subtree_contract_mixed_plain(
            fr[b:b + 1], cw1[b:b + 1], cw2[b:b + 1], tables[b], **kw)[0])


@pytest.mark.parametrize("prf", range(6))
@pytest.mark.parametrize("bsz,k,r,rc,row0", [(1, 16, 8, 4, 0),
                                             (3, 32, 16, None, 0),
                                             (9, 16, 4, 4, 8)])
def test_sqrt_grid_per_key_plain_is_each_keys_shared_answer(prf, bsz, k, r,
                                                            rc, row0):
    """K4's plain per-key mode, for 1, 3 and 9 keys."""
    rng = np.random.default_rng(prf * 100 + bsz + k)
    seeds = torch.from_numpy(_i32(rng, bsz, k, 4))
    cw1 = torch.from_numpy(_i32(rng, bsz, r, 4))
    cw2 = torch.from_numpy(_i32(rng, bsz, r, 4))
    tables = torch.from_numpy(_i32(rng, bsz, r * k, 3))
    kw = dict(prf_method=prf, row_chunk=rc, row0=row0)
    got = sqrt_grid.sqrt_grid_contract(seeds, cw1, cw2, tables, **kw)
    for b in range(bsz):
        assert torch.equal(got[b], sqrt_grid.sqrt_grid_contract_plain(
            seeds[b:b + 1], cw1[b:b + 1], cw2[b:b + 1], tables[b],
            **kw)[0])


def test_per_key_entry_points_reject_mismatched_tables():
    z = torch.zeros(2, 64, 4, dtype=torch.int32)
    with pytest.raises(ValueError, match="per-key tables"):
        expand.expand_and_contract_per_key_tables(
            z, z, z[:, 0], torch.zeros(3, 128, 4, dtype=torch.int32),
            depth=7, prf_method=2, chunk_leaves=128)
    with pytest.raises(ValueError, match="per-key tables"):
        radix4.expand_and_contract_per_key_tables_mixed(
            z, z, z[:, 0], torch.zeros(128, 4, dtype=torch.int32), n=128,
            prf_method=3, chunk_leaves=None)
    with pytest.raises(ValueError, match="per-key tables"):
        sqrtn.eval_contract_per_key_tables(
            z[:, :16], z[:, :8], z[:, :8],
            torch.zeros(3, 128, 4, dtype=torch.int32), prf_method=1)
    with pytest.raises(ValueError, match="per-key tables"):
        subtree.subtree_contract(
            z[:, :1], z, z, torch.zeros(3, 128, 4, dtype=torch.int32),
            depth=7, f_levels=0, prf_method=2)
