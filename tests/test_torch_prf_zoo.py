"""The port's PRF zoo (``core/prf_zoo.py``, ``core/prf_zoo_hash.py``,
``ops/prf_zoo.py``) against ``dpf_tpu``'s, on the CPU.

Every candidate equals ``dpf_tpu``'s ``ZOO[name](seeds, pos)`` bit for
bit; the hash cores and scalar references pass the same known-answer
tests as ``tests/test_prf_zoo_hash.py``; K7's wrapper takes the plain
cores on CPU tensors (the kernel itself runs under the host shim in
``tests/test_torch_cuda_host.py`` and on the card in ``chip_smoke.py``).
"""

import hashlib
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpf_tpu.core import prf_zoo as jzoo
from dpf_tpu_torch.core import prf, prf_zoo, prf_zoo_hash as zh
from dpf_tpu_torch.core.prf_ref import PRF_CHACHA20_BLK, PRF_SALSA20_BLK
from dpf_tpu_torch.core.u32 import from_u32, to_u32
from dpf_tpu_torch.ops import prf_zoo as ops_zoo


def _seeds(n=32, seed=3):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2 ** 32, (n, 4), dtype=np.uint32)


def _ints(t):
    a = to_u32(t).astype(np.uint64)
    return [int(r[0]) | int(r[1]) << 32 | int(r[2]) << 64 | int(r[3]) << 96
            for r in a]


def _seed_bytes(limbs):
    return b"".join(int(x).to_bytes(4, "little") for x in limbs)


def test_zoo_has_the_fifteen_candidates_in_order():
    assert tuple(prf_zoo.ZOO) == tuple(jzoo.ZOO)
    assert len(prf_zoo.ZOO) == 15
    assert prf_zoo.CHILDREN_PER_CALL == jzoo.CHILDREN_PER_CALL
    assert ops_zoo.CANDIDATES == tuple(jzoo.ZOO)


@pytest.mark.parametrize("pos", [0, 1])
@pytest.mark.parametrize("name", list(jzoo.ZOO))
def test_candidate_equals_dpf_tpu(name, pos):
    s = _seeds(33, seed=pos + 7)
    want = np.asarray(jzoo.ZOO[name](jnp.asarray(s), pos))
    got = to_u32(prf_zoo.ZOO[name](from_u32(s), pos))
    assert (got == want).all()


@pytest.mark.parametrize("name", ["siphash24", "blake2s", "keccakf800",
                                  "highway_proxy", "md5", "sha256"])
def test_hash_candidate_at_a_position_above_2_32(name):
    s = _seeds(5)
    pos = (1 << 40) + 3
    want = np.asarray(jzoo.ZOO[name](s, pos))
    assert (to_u32(prf_zoo.ZOO[name](from_u32(s), pos)) == want).all()


@pytest.mark.parametrize("name,method", [("chacha12_blk", PRF_CHACHA20_BLK),
                                         ("salsa20_12_blk", PRF_SALSA20_BLK)])
def test_block_candidates_serve_prf_multi_children(name, method):
    s = from_u32(_seeds(9))
    kids = prf_zoo.all_children(name, s)
    for b, want in enumerate(prf.prf_multi(method, s, 4)):
        assert torch.equal(kids[b], want)
        assert torch.equal(prf_zoo.ZOO[name](s, b), want)


# ------------------------------------------------ known-answer tests

def test_siphash_scalar_reference_paper_vectors():
    key = bytes(range(16))
    assert zh.siphash24_ref(key, b"") == 0x726FDB47DD0E0E31
    assert zh.siphash24_ref(key, bytes(range(1))) == 0x74F839C593DC67FD
    assert zh.siphash24_ref(key, bytes(range(8))) == 0x93F5F5799A932462


def test_keccak_derived_constants_vs_hashlib_sha3():
    for msg in (b"", b"tpu-dpf", bytes(100)):
        assert zh.sha3_256_ref(msg) == hashlib.sha3_256(msg).digest()


@pytest.mark.parametrize("core,oracle", [
    ("blake2s", lambda k, pos: hashlib.blake2s(
        pos.to_bytes(8, "little"), key=k, digest_size=16).digest()),
    ("md5", lambda k, pos: hashlib.md5(
        k + pos.to_bytes(4, "little")).digest()),
    ("sha256", lambda k, pos: hashlib.sha256(
        k + pos.to_bytes(4, "little")).digest()[:16]),
])
def test_hash_core_vs_hashlib(core, oracle):
    s = _seeds(8)
    for pos in (0, 1, 42):
        got = _ints(prf_zoo.ZOO[core](from_u32(s), pos))
        for i, limbs in enumerate(s):
            want = oracle(_seed_bytes(limbs), pos)
            assert got[i] == int.from_bytes(want, "little"), (pos, i)


def test_siphash_vectorized_matches_scalar():
    s = _seeds(8)
    for (c, d), name in (((2, 4), "siphash24"), ((1, 3), "siphash13")):
        got = _ints(prf_zoo.ZOO[name](from_u32(s), 7))
        for i, limbs in enumerate(s):
            key = _seed_bytes(limbs)
            lo = zh.siphash24_ref(key, (14).to_bytes(8, "little"), c, d)
            hi = zh.siphash24_ref(key, (15).to_bytes(8, "little"), c, d)
            assert got[i] == lo | (hi << 64), (name, i)


def test_keccakf800_vectorized_matches_scalar():
    s = _seeds(6)
    got = _ints(zh.keccakf800_core(from_u32(s), 9))
    for i, limbs in enumerate(s):
        st = [[0] * 5 for _ in range(5)]
        for j in range(4):
            st[j][0] = int(limbs[j])
        st[4][0] = 9
        st[0][1] = 0x1F
        st[4][4] = 0x80000000
        out = zh.keccakf_ref(st, 32, 22)
        assert got[i] == sum(out[j][0] << (32 * j) for j in range(4)), i


# ------------------------------------------------------ K7's wrapper

@pytest.mark.parametrize("name", list(jzoo.ZOO))
def test_wrapper_takes_the_plain_core_on_the_cpu(name):
    s = from_u32(_seeds(17))
    before = ops_zoo.zoo_eval.launches
    pos = 0 if name in prf_zoo.CHILDREN_PER_CALL else 1
    assert torch.equal(ops_zoo.zoo_eval(name, s, pos),
                       ops_zoo.zoo_plain(name, s, pos))
    assert ops_zoo.zoo_eval.launches == before


def test_wrapper_refuses_bad_input():
    s = from_u32(_seeds(4))
    with pytest.raises(ValueError, match="unknown PRF-zoo candidate"):
        ops_zoo.zoo_eval("rot13", s)
    with pytest.raises(ValueError):
        ops_zoo.zoo_eval("md5", s[:, :3])
    with pytest.raises(ValueError):
        ops_zoo.zoo_eval("md5", s.long())
    with pytest.raises(ValueError):
        ops_zoo.zoo_eval("md5", s, 1 << 64)


def test_instruction_counts_from_the_function():
    """ChaCha<R>: 4 R quarter rounds of 12 operations, plus the 4 output
    words' adds (16 for a block-PRG candidate's four children); an
    output add takes in the rotate of its word's last update, and the
    last round's ``c + d`` the rotated ``d`` nothing else reads
    (``LEA.HI``): 4 + 4 fewer (4 for the block, whose ``d`` row is
    output)."""
    for r in (8, 12, 20):
        assert ops_zoo.ops_per_call("chacha%d" % r) == 48 * r + 4 - 8
    assert ops_zoo.ops_per_call("chacha12_blk") == 48 * 12 + 16 - 4
    # a 64-bit add, rotate or product costs two, on seed data only
    assert ops_zoo.ops_per_call("siphash13") < \
        ops_zoo.ops_per_call("siphash24")
    assert all(ops_zoo.ops_per_call(n) > 0 for n in ops_zoo.CANDIDATES)


def _word(s, i):
    return s[..., i]


@pytest.mark.parametrize("fn,want", [
    # MD5's F and Keccak's chi: one LOP3 each
    (lambda s: (_word(s, 0) & _word(s, 1)) | (~_word(s, 0) & _word(s, 2)),
     1),
    (lambda s: _word(s, 0) ^ (~_word(s, 1) & _word(s, 2)), 1),
    # SHA-256's Maj: three operands however many ands and xors
    (lambda s: (_word(s, 0) & _word(s, 1)) ^ (_word(s, 0) & _word(s, 2))
     ^ (_word(s, 1) & _word(s, 2)), 1),
    # Keccak's theta column: five operands, two LOP3
    (lambda s: _word(s, 0) ^ _word(s, 1) ^ _word(s, 2) ^ _word(s, 3)
     ^ (_word(s, 0) + _word(s, 1)), 3),
    # a constant takes an operand: four operands, two LOP3
    (lambda s: (_word(s, 0) ^ _word(s, 1) ^ _word(s, 2)) & 0x0F0F, 2),
    # sums: ceil((k - 1) / 2) IADD3, constants folded into one addend
    (lambda s: _word(s, 0) + _word(s, 1) + _word(s, 2), 1),
    (lambda s: _word(s, 0) + _word(s, 1) + 7 + _word(s, 2) + 9, 2),
    (lambda s: _word(s, 0) + _word(s, 1) + _word(s, 2) + _word(s, 3), 2),
    (lambda s: _word(s, 0) - _word(s, 1), 1),
    # a rotate read only by a sum goes into it (LEA.HI)
    (lambda s: prf.rotl(_word(s, 0), 7) + _word(s, 1), 1),
    (lambda s: prf.rotl(_word(s, 0), 7) + _word(s, 1) + _word(s, 2)
     + _word(s, 3), 2),
    (lambda s: prf.rotl(_word(s, 0), 7) ^ _word(s, 1), 2),
    # an operation the output does not need, or on constants only, is free
    (lambda s: (torch.zeros_like(_word(s, 0)) + 5) * 3 + _word(s, 1), 1),
])
def test_instructions_fuse_as_the_card_does(fn, want):
    assert ops_zoo.instructions_of(fn) == want


def test_shared_values_are_not_merged():
    """A value with two consumers is computed once: (a ^ b) feeds both
    the and and the add, so it stays an instruction of its own; so does
    a rotate read twice."""
    def fn(s):
        t = _word(s, 0) ^ _word(s, 1)
        return torch.stack([t & _word(s, 2), t + _word(s, 3)], -1)
    assert ops_zoo.instructions_of(fn) == 3

    def rot(s):
        r = prf.rotl(_word(s, 0), 7)
        return torch.stack([r + _word(s, 1), r + _word(s, 2)], -1)
    assert ops_zoo.instructions_of(rot) == 3


@pytest.mark.parametrize("name,most", [
    # a step: F (LOP3), the sum f + a + K + m (two IADD3), the rotate
    # and the add b + rotl (one LEA.HI)
    ("md5", 64 * 4),
    # a round: Sigma1 and Sigma0 (three rotates and a LOP3 each), Ch and
    # Maj (a LOP3 each), t1 (two IADD3), e and a (an IADD3 each); a
    # schedule word: sigma0 and sigma1 (four each), the sum (two IADD3)
    ("sha256", 64 * 15 + 48 * 10),
    # a round: theta (two LOP3 a column, a rotate and a LOP3 a column, a
    # LOP3 a lane), rho (24 rotates), chi (a LOP3 a lane), iota
    ("keccakf800", 22 * (10 + 10 + 25 + 24 + 25 + 1)),
    # two compressions (the key block, the message block) of 10 rounds
    # of 8 G: two sums of three (IADD3), two adds, four xors, four
    # rotates; the finalization's xors
    ("blake2s", 2 * (10 * 8 * 12 + 8)),
])
def test_hash_candidates_count_fused_work(name, most):
    """The four hash candidates whose bitwise functions and sums the card
    fuses: at most the per-step count of LOP3, IADD3 and rotates."""
    assert 0.6 * most < ops_zoo.ops_per_call(name) <= most


def test_benchmark_zoo_on_the_cpu(capsys):
    res = prf_zoo.benchmark_zoo(n_calls=64, reps=1, device="cpu")
    assert set(res) == set(jzoo.ZOO) and all(v > 0 for v in res.values())
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [ln["prf_candidate"] for ln in lines] == list(jzoo.ZOO)
    assert set(lines[0]) == {"prf_candidate", "calls", "reps",
                             "children_per_call",
                             "timed_children_materialized",
                             "prf_calls_per_sec", "ggm_children_per_sec"}
    blk = [ln for ln in lines if ln["prf_candidate"] == "chacha12_blk"][0]
    assert blk["children_per_call"] == 4


def test_benchmark_zoo_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        prf_zoo.benchmark_zoo(n_calls=8, reps=1)


def test_k7_matches_the_plain_cores_on_a_card():
    """On a card: each of the 15 instances bit-equal to its plain core at
    ragged n, and the launch counter moved once a launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K7 runs only there")
    g = torch.Generator(device="cuda").manual_seed(2)
    before = ops_zoo.zoo_eval.launches
    for name in ops_zoo.CANDIDATES:
        s = torch.randint(-2 ** 31, 2 ** 31, (257, 4), dtype=torch.int64,
                          device="cuda", generator=g).to(torch.int32)
        pos = 0 if name in prf_zoo.CHILDREN_PER_CALL else (1 << 33) + 1
        assert torch.equal(ops_zoo.zoo_eval(name, s, pos),
                           ops_zoo.zoo_plain(name, s, pos)), name
    assert ops_zoo.zoo_eval.launches == before + len(ops_zoo.CANDIDATES)
