"""The port's limb arithmetic and PRFs against dpf_tpu's, bit for bit.

Inputs are made from a seed with numpy and go through both packages;
every quantity is an integer mod 2^32 or 2^128, so equality is exact.
"""

import numpy as np
import pytest

from dpf_tpu.core import prf as jprf
from dpf_tpu.core import prf_ref as jprf_ref
from dpf_tpu.core import u128 as ju128
from dpf_tpu_torch.core import prf, prf_ref, u128, u32

PRF_IDS = range(6)


def _seeds(n, seed=7):
    rng = np.random.default_rng(seed)
    ints = [int.from_bytes(rng.bytes(16), "little") for _ in range(n)]
    return ints + [0, 1, (1 << 128) - 1, 1 << 127]


def _limbs(ints):
    return u128.ints_to_limbs(ints)          # numpy uint32 [n, 4]


def test_u32_helpers_match_uint32():
    rng = np.random.default_rng(1)
    a = rng.integers(0, 2 ** 32, 4096, dtype=np.uint64).astype(np.uint32)
    b = rng.integers(0, 2 ** 32, 4096, dtype=np.uint64).astype(np.uint32)
    a[:4] = [0, 1, 0x7FFFFFFF, 0xFFFFFFFF]
    b[:4] = [0xFFFFFFFF, 0x80000000, 0x80000000, 0]
    ta, tb = u32.from_u32(a), u32.from_u32(b)
    for s in range(32):
        assert (u32.to_u32(u32.shr(ta, s)) == a >> np.uint32(s)).all()
    for r in range(1, 32):
        want = (a << np.uint32(r)) | (a >> np.uint32(32 - r))
        assert (u32.to_u32(u32.rotl(ta, r)) == want).all()
    assert (u32.ult(ta, tb).numpy() == (a < b)).all()
    assert (u32.to_u32(ta + tb) == a + b).all()
    assert (u32.to_u32(ta * tb) == a * b).all()
    assert u32.i32(0xFFFFFFFF) == -1 and u32.i32(5) == 5


def test_u128_add_mul_and_conversions():
    xs, ys = _seeds(64, 2), _seeds(64, 3)
    tx, ty = u32.from_u32(_limbs(xs)), u32.from_u32(_limbs(ys))
    got = u128.limbs_to_ints(u32.to_u32(u128.add128(tx, ty)))
    assert got == [(x + y) % 2 ** 128 for x, y in zip(xs, ys)]
    for c in (0, 1, 4242, 4243, 0xFFFFFFFF):
        got = u128.limbs_to_ints(u32.to_u32(u128.mul128_small(tx, c)))
        assert got == [(x * c) % 2 ** 128 for x in xs]
    for x in xs:
        assert (u128.int_to_limbs(x) == ju128.int_to_limbs(x)).all()
        assert u128.limbs_to_int(ju128.int_to_limbs(x)) == x


def test_known_answers():
    """dpf_tpu's KATs (tests/test_prf.py) replayed on the port, scalar
    and vectorized: FIPS-197 AES-128, the S-box, DUMMY's formula."""
    key, pt = bytes(range(16)), bytes.fromhex(
        "00112233445566778899aabbccddeeff")
    want = "69c4e0d86a7b0430d8cdb78070b4c55a"
    assert prf_ref._aes128_encrypt_block(key, pt).hex() == want
    seed = u32.from_u32(u128.int_to_limbs(int.from_bytes(key, "little"))
                        [None, :])
    ct = prf.prf_aes128_v(seed, int.from_bytes(pt, "little"))
    assert u32.to_u32(ct)[0].tobytes().hex() == want
    assert (prf_ref.SBOX[0x00], prf_ref.SBOX[0x53], prf_ref.SBOX[0xFF]) == \
        (0x63, 0xED, 0x16)
    assert sorted(prf_ref.SBOX) == list(range(256))
    s = 0xDEADBEEF_00000001_FFFFFFFF_12345678
    assert prf_ref.prf_dummy(s, 1) == (s * 4243 + 4243) & prf_ref.MASK128


@pytest.mark.parametrize("n", [2, 8, 128, 1024])
def test_bit_reverse_and_next_pow2(n):
    assert (u128.bit_reverse_indices(n) == ju128.bit_reverse_indices(n)).all()
    assert u128.next_pow2(n - 1) == ju128.next_pow2(n - 1)


@pytest.mark.parametrize("method", PRF_IDS)
def test_scalar_prf_matches_dpf_tpu(method):
    for s in _seeds(6, 11 + method):
        for pos in (0, 1, 2, 7):
            assert prf_ref.prf(method, s, pos) == jprf_ref.prf(method, s, pos)


@pytest.mark.parametrize("method", PRF_IDS)
def test_vectorized_prf_matches_dpf_tpu(method):
    ints = _seeds(29, 20 + method)
    seeds_np = _limbs(ints).reshape(3, 11, 4)
    seeds_t = u32.from_u32(seeds_np)
    for pos in (0, 1, 3, 5):
        want = jprf.prf_v(method, seeds_np, pos)
        got = u32.to_u32(prf.prf_v(method, seeds_t, pos))
        assert (got == want).all(), (method, pos)
    pair = prf.prf_pair(method, seeds_t)
    want_pair = jprf.prf_pair(method, seeds_np)
    for b in (0, 1):
        assert (u32.to_u32(pair[b]) == np.asarray(want_pair[b])).all()
        assert u128.limbs_to_ints(u32.to_u32(pair[b])) == [
            prf_ref.prf(method, s, b) for s in ints]
