"""The per-key kernels' geometry: K2's block subtrees
(``subtree.pkt_block_leaves``) and K4's row chunks
(``sqrt_grid.pkt_row_chunk``), on the CPU.

Each choice must be a split the kernel takes, reach the grid its rule
names wherever the shape allows it, and change no bit: the per-key
evaluations run their plain versions at the geometry the functions pick
and are held bit for bit against ``dpf_tpu``'s.  A geometry named by
the caller is obeyed or refused with ``ValueError``, never replaced.
"""

import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dpf_tpu.core import expand as jexpand
from dpf_tpu.core import radix4 as jr4
from dpf_tpu.core import sqrtn as jsqrtn
from dpf_tpu_torch.apps.batch_pir import PrivateLookupServer
from dpf_tpu_torch.core import expand, keygen, radix4, sqrtn, u128
from dpf_tpu_torch.core.u32 import from_u32
from dpf_tpu_torch.ops import sqrt_grid, subtree


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch's CPU ops on one thread here: the suite runs several worker
    processes side by side."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _trailing_products(ars):
    out, c = [], 1
    for a in reversed(tuple(ars)):
        c *= a
        out.append(c)
    return out


def _ars(n, radix):
    return radix4.arities(n) if radix == 4 else (2,) * (n.bit_length() - 1)


# ------------------------------------------------------------------ K2

@pytest.mark.parametrize("radix", [2, 4])
@pytest.mark.parametrize("g", [1, 3, 5, 9, 16, 256, 1024])
def test_pkt_block_leaves_is_a_legal_split(radix, g):
    """For every n up to 2^20: a product of trailing arities (a power of
    two in the binary tree), dividing n, at most 4096, at least 256 where
    n allows it; the largest such whose grid reaches the target, or the
    smallest when none does."""
    for d in range(1, 21):
        n = 1 << d
        ars = _ars(n, radix)
        cb = subtree.pkt_block_leaves(g, ars)
        legal = [c for c in _trailing_products(ars)
                 if c <= subtree.MAX_BLOCK_LEAVES]
        assert cb in legal and n % cb == 0
        floor = min(subtree.PKT_MIN_BLOCK_LEAVES, max(legal))
        assert cb >= floor
        fill = [c for c in legal
                if c >= floor and g * n // c >= subtree.PKT_TARGET_BLOCKS]
        if fill:
            assert cb == max(fill)
            assert g * n // cb >= subtree.PKT_TARGET_BLOCKS
        else:
            assert cb == min(c for c in legal if c >= floor)


@pytest.mark.parametrize("g,n,binary,mixed", [
    (256, 4096, 2048, 1024),     # phase 9's group
    (16, 65536, 2048, 1024),     # a few large bins
    (1024, 1024, 1024, 1024),    # many small bins: one block a key
])
def test_pkt_block_leaves_at_the_sweep(g, n, binary, mixed):
    """The sweep's 2^20-row table in bins: at least three blocks for each
    of the H100's 132 SMs in both trees."""
    assert subtree.pkt_block_leaves(g, _ars(n, 2)) == binary
    assert subtree.pkt_block_leaves(g, _ars(n, 4)) == mixed
    for cb in (binary, mixed):
        assert g * n // cb >= subtree.PKT_TARGET_BLOCKS == 3 * 132


def test_pkt_block_leaves_counts_the_frontier():
    """Below a frontier of F nodes the grid has F blocks more a key."""
    ars = (2,) * 10
    assert subtree.pkt_block_leaves(1, ars, 1) == 256
    assert subtree.pkt_block_leaves(99, ars, 4) == 1024
    assert subtree.pkt_block_leaves(100, ars, 4) == 1024
    assert subtree.pkt_block_leaves(1, (), 1) == 1


# ------------------------------------------------------------------ K4

@pytest.mark.parametrize("k", [1, 8, 16, 32, 64, 100, 256, 300, 1024])
def test_pkt_row_chunk_is_a_legal_split(k):
    """For every R up to 64: a divisor of R, a multiple of 4 below R, the
    smallest whose item fills a sub-tile of 1024 cells, else R."""
    for r in range(1, 65):
        rc = sqrt_grid.pkt_row_chunk(r, k)
        assert r % rc == 0 and (rc == r or rc % 4 == 0)
        assert sqrtn._resolve_row_chunk(r, k, 1, rc) == rc
        legal = [c for c in range(1, r + 1)
                 if r % c == 0 and (c == r or c % 4 == 0)]
        full = [c for c in legal
                if c == r or c * k >= sqrt_grid.PKT_TILE_CELLS]
        assert rc == min(full)


@pytest.mark.parametrize("g,n,rc", [(256, 4096, 16), (16, 65536, 4),
                                    (1024, 1024, 32)])
def test_pkt_row_chunk_at_the_sweep(g, n, rc):
    """One full sub-tile an item, 1024 items at every point of the sweep:
    more than four for each of the H100's 132 SMs."""
    k, r = sqrtn.default_split(n)
    assert sqrt_grid.pkt_row_chunk(r, k) == rc
    assert rc * k == sqrt_grid.PKT_TILE_CELLS
    assert g * (r // rc) == 1024 > 4 * 132


# ------------------------------------------------- the callers' geometry

def _keys(rng, bsz, n):
    return tuple(torch.from_numpy(rng.integers(
        -2 ** 31, 2 ** 31, shape, dtype=np.int64).astype(np.int32))
        for shape in ((bsz, 1, 4), (bsz, 64, 4), (bsz, 64, 4), (bsz, n, 3)))


def test_k2_per_key_obeys_the_callers_block(monkeypatch):
    """None takes ``pkt_block_leaves``; a legal block is used as given."""
    seen = []
    plain = subtree._contract_plain
    monkeypatch.setattr(subtree, "_contract_plain",
                        lambda *a: seen.append(a[7]) or plain(*a))
    fr, cw1, cw2, tbl = _keys(np.random.default_rng(1), 3, 1024)
    kw = dict(depth=10, f_levels=0, prf_method=2)
    want = subtree.subtree_contract(fr, cw1, cw2, tbl, **kw)
    got = subtree.subtree_contract(fr, cw1, cw2, tbl, block_leaves=64, **kw)
    mixed = dict(ars=radix4.arities(1024), f_lv=0, prf_method=5)
    subtree.subtree_contract_mixed(fr, cw1, cw2, tbl, **mixed)
    subtree.subtree_contract_mixed(fr, cw1, cw2, tbl, block_leaves=16,
                                   **mixed)
    assert seen == [256, 64, 256, 16]
    assert torch.equal(got, want)


@pytest.mark.parametrize("call,match", [
    (lambda t: expand.expand_and_contract_per_key_tables(
        t[1], t[2], t[0][:, 0], t[3], depth=10, prf_method=2,
        chunk_leaves=96), "power of two"),
    (lambda t: subtree.subtree_contract(
        t[0], t[1], t[2], torch.zeros(3, 1 << 13, 1, dtype=torch.int32),
        depth=13, f_levels=0, prf_method=1, block_leaves=8192),
     "at most"),
    (lambda t: radix4.expand_and_contract_per_key_tables_mixed(
        t[1], t[2], t[0][:, 0], t[3], n=1024, prf_method=4,
        chunk_leaves=128), "trailing arities"),
    (lambda t: subtree.subtree_contract_mixed(
        t[0], t[1], t[2], torch.zeros(3, 1 << 14, 1, dtype=torch.int32),
        ars=radix4.arities(1 << 14), f_lv=0, prf_method=5,
        block_leaves=16384), "trailing arities"),
])
def test_k2_per_key_refuses_a_block_it_cannot_take(call, match):
    with pytest.raises(ValueError, match=match):
        call(_keys(np.random.default_rng(2), 3, 1024))


@pytest.mark.parametrize("rc,match", [(3, "divide"), (6, "divide"),
                                      (2, "multiple of 4"), (32, "divide")])
def test_k4_per_key_refuses_a_row_chunk_it_cannot_take(rc, match):
    rng = np.random.default_rng(3)
    seeds, cw1, cw2 = (torch.from_numpy(rng.integers(
        0, 2 ** 31, (2, w, 4), dtype=np.int64).astype(np.int32))
        for w in (8, 16, 16))
    tables = torch.zeros(2, 128, 3, dtype=torch.int32)
    with pytest.raises(ValueError, match=match):
        sqrtn.eval_contract_per_key_tables(seeds, cw1, cw2, tables,
                                           prf_method=1, row_chunk=rc)


def test_k4_per_key_obeys_the_callers_row_chunk(monkeypatch):
    seen = []
    plain = sqrt_grid.sqrt_grid_contract_plain
    monkeypatch.setattr(sqrt_grid, "sqrt_grid_contract_plain",
                        lambda *a, **kw: seen.append(kw["row_chunk"])
                        or plain(*a, **kw))
    rng = np.random.default_rng(4)
    seeds, cw1, cw2 = (torch.from_numpy(rng.integers(
        0, 2 ** 31, (3, w, 4), dtype=np.int64).astype(np.int32))
        for w in (64, 64, 64))
    tables = torch.from_numpy(rng.integers(0, 2 ** 31, (3, 4096, 2),
                                           dtype=np.int64).astype(np.int32))
    want = sqrt_grid.sqrt_grid_contract(seeds, cw1, cw2, tables,
                                        prf_method=3)
    got = sqrt_grid.sqrt_grid_contract(seeds, cw1, cw2, tables,
                                       prf_method=3, row_chunk=8)
    assert seen == [16, 8] and torch.equal(got, want)


@pytest.mark.parametrize("prf,sch,rad,n,g,want", [
    (2, "logn", 2, 4096, 256, {"chunk_leaves": 2048}),
    (5, "logn", 4, 4096, 256, {"chunk_leaves": 1024}),
    (3, "logn", 2, 4096, 256, {"chunk_leaves": 4096}),
    (1, "sqrtn", 2, 4096, 256, {"row_chunk": None}),
])
def test_batch_pir_group_knobs_are_the_per_key_geometry(prf, sch, rad, n, g,
                                                        want):
    """The lookup server's knobs: K2's block for the stream ciphers, the
    live-seed chunk for AES, None for sqrt-N (K4's wrapper resolves it
    from the keys' rows)."""
    srv = types.SimpleNamespace(prf_method=prf, entry_size=16,
                                device=torch.device("cpu"), _knobs={})
    assert PrivateLookupServer._group_knobs(srv, n, g, sch, rad) == want


# ------------------------------------- parity with dpf_tpu at the geometry

def _wire(construction, n, g, prf, seed):
    alphas = [(i * 37 + seed) % n for i in range(g)]
    seeds = [b"geom-%d-%d" % (seed, i) for i in range(g)]
    if construction == "sqrtn":
        wa, _ = sqrtn.gen_sqrt_batched(alphas, n, seeds, prf_method=prf)
    elif construction == "radix4":
        wa, _ = radix4.gen_batched_r4(alphas, n, seeds, prf_method=prf)
    else:
        wa, _ = keygen.gen_batched(alphas, n, seeds, prf_method=prf)
    return wa.numpy()


# (construction, prf, n, G, E): n in 2^6 .. 2^10 (7 and 9 odd: the
# radix-4 tree takes a binary level), G ragged, E of 1, 3 and 16; the
# stream ciphers run K2's plain per-key version, sqrt-N every id K4's
PARITY = [
    ("binary", 2, 1 << 10, 9, 16), ("binary", 5, 1 << 7, 3, 1),
    ("binary", 1, 1 << 6, 5, 3), ("binary", 3, 1 << 9, 1, 16),
    ("radix4", 2, 1 << 9, 5, 16), ("radix4", 4, 1 << 10, 1, 3),
    ("radix4", 5, 1 << 8, 9, 1),
    ("sqrtn", 3, 1 << 10, 9, 16), ("sqrtn", 5, 1 << 8, 3, 3),
    ("sqrtn", 0, 1 << 6, 1, 1), ("sqrtn", 2, 1 << 9, 5, 16),
]


@pytest.mark.parametrize("construction,prf,n,g,e", PARITY)
def test_per_key_geometry_matches_dpf_tpu(construction, prf, n, g, e):
    """The port's per-key evaluation with no chunk named (its plain
    version at the geometry ``pkt_block_leaves`` / ``pkt_row_chunk``
    picks) equals ``dpf_tpu``'s, bit for bit."""
    rng = np.random.default_rng(n + g + e + prf)
    tables = rng.integers(-2 ** 31, 2 ** 31, (g, n, e),
                          dtype=np.int64).astype(np.int32)
    if construction == "radix4":
        tables = tables[:, radix4.mixed_reverse_indices(radix4.arities(n))]
    elif construction == "binary":
        tables = tables[:, u128.bit_reverse_indices(n)]
    tables = np.ascontiguousarray(tables)
    tt = torch.from_numpy(tables)
    wire = _wire(construction, n, g, prf, n + g)
    if construction == "sqrtn":
        pk = sqrtn.decode_sqrt_keys_batched(wire)
        want = jsqrtn.eval_contract_per_key_tables(
            jnp.asarray(pk.seeds), jnp.asarray(pk.cw1), jnp.asarray(pk.cw2),
            jnp.asarray(tables), prf_method=prf, dot_impl="i32")
        got = sqrtn.eval_contract_per_key_tables(
            from_u32(pk.seeds), from_u32(pk.cw1), from_u32(pk.cw2), tt,
            prf_method=prf)
    else:
        decode = (radix4.decode_mixed_keys_batched
                  if construction == "radix4" else keygen.decode_keys_batched)
        pk = decode(wire)
        jargs = [jnp.asarray(a) for a in (pk.cw1, pk.cw2, pk.last)]
        targs = [from_u32(a) for a in (pk.cw1, pk.cw2, pk.last)]
        knobs = dict(dot_impl="i32", aes_impl="gather", round_unroll=False)
        if construction == "radix4":
            want = jr4.expand_and_contract_per_key_tables_mixed(
                *jargs, jnp.asarray(tables), n=n, prf_method=prf,
                chunk_leaves=n, **knobs)
            got = radix4.expand_and_contract_per_key_tables_mixed(
                *targs, tt, n=n, prf_method=prf)
        else:
            depth = n.bit_length() - 1
            want = jexpand.expand_and_contract_per_key_tables(
                *jargs, jnp.asarray(tables), depth=depth, prf_method=prf,
                chunk_leaves=n, **knobs)
            got = expand.expand_and_contract_per_key_tables(
                *targs, tt, depth=depth, prf_method=prf)
    assert got.shape == (g, e) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
