"""The port's key generation and wire codec against dpf_tpu's."""

import numpy as np
import pytest
import torch

from dpf_tpu.core import keygen as jkeygen
from dpf_tpu_torch.core import evalref, keygen


@pytest.mark.parametrize("method", range(6))
def test_wire_keys_identical(method):
    for alpha, n, seed in ((0, 2, b"a"), (5, 16, b"bb"), (1000, 1024, b"c"),
                           (77, 128, bytes(range(40)))):
        ours = keygen.generate_keys(alpha, n, seed, method)
        theirs = jkeygen.generate_keys(alpha, n, seed, method)
        for o, t in zip(ours, theirs):
            assert (o.serialize() == t.serialize()).all()
            assert o.last_key == t.last_key and o.depth == t.depth


@pytest.mark.parametrize("method", range(6))
def test_evaluate_flat_full_domain(method):
    n = 16
    ka, kb = keygen.generate_keys(9, n, b"flat%d" % method, method)
    ja, _ = jkeygen.generate_keys(9, n, b"flat%d" % method, method)
    for x in range(n):
        assert keygen.evaluate_flat(ka, x, method) == \
            jkeygen.evaluate_flat(ja, x, method)
        diff = (keygen.evaluate_flat(ka, x, method)
                - keygen.evaluate_flat(kb, x, method)) % 2 ** 128
        assert diff == (1 if x == 9 else 0)
    hot = evalref.eval_one_hot_i32(ka, method) - \
        evalref.eval_one_hot_i32(kb, method)
    assert (hot == (np.arange(n) == 9)).all()


def test_decode_keys_batched_identical():
    wires = [keygen.generate_keys(i * 37 % 256, 256, b"k%d" % i, 2)[i % 2]
             .serialize() for i in range(5)]
    ours = keygen.decode_keys_batched([torch.from_numpy(w) for w in wires])
    theirs = jkeygen.decode_keys_batched(wires)
    for f in ("cw1", "cw2", "last"):
        assert (getattr(ours, f) == getattr(theirs, f)).all()
    assert (ours.depth, ours.n) == (theirs.depth, theirs.n)
    padded = ours.pad_to(8)
    assert padded.batch == 8 and (padded.last[5:] == ours.last[-1]).all()
    flat = keygen.deserialize_key(wires[3])
    jflat = jkeygen.deserialize_key(wires[3])
    assert flat.last_key == jflat.last_key and flat.n == jflat.n
    assert (flat.cw1 == jflat.cw1).all() and (flat.cw2 == jflat.cw2).all()


def test_codec_rejects_bad_keys():
    good = keygen.generate_keys(3, 128, b"x", 0)[0].serialize()
    with pytest.raises(ValueError, match="524"):
        keygen.decode_keys_batched([good[:523]])
    with pytest.raises(ValueError, match="524"):
        keygen.deserialize_key(good[:-1])
    other = keygen.generate_keys(3, 256, b"x", 0)[0].serialize()
    with pytest.raises(ValueError, match="mixed table sizes"):
        keygen.decode_keys_batched([good, other])
    with pytest.raises(ValueError, match="empty"):
        keygen.stack_wire_keys([])
    marked = good.copy().view(np.uint32)
    marked[1] = 4                      # the radix-4 marker limb
    with pytest.raises(ValueError, match="radix"):
        keygen.decode_keys_batched([marked.view(np.int32)])
    with pytest.raises(ValueError):
        keygen.generate_keys(5, 100, b"x", 0)
