"""K1 on the card against its plain version, bit for bit (``chip``
marker; skipped without CUDA).

This file imports nothing of JAX, so on a card it runs on its own:
``python -m pytest --noconftest tests/test_torch_kernels_card.py``.
"""

import pytest
import torch

from dpf_tpu_torch.ops import aes_level

pytestmark = pytest.mark.chip


@pytest.fixture
def chip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")


@pytest.mark.parametrize("low32", [False, True])
@pytest.mark.parametrize("arity", [2, 4])
@pytest.mark.parametrize("bsz,w", [
    (5, 40013),   # past one stride of the persistent grid, ragged tail
    (3, 257),     # two blocks, the second holding one node a key
])
def test_aes_level_matches_plain_over_every_key_byte0(chip, bsz, w, arity,
                                                      low32):
    """K1 at each arity and store form.  Byte 0 of the seeds takes all
    256 values across the batch, so K1's shared rounds read every
    round-1 index (byte 0 of the key xor the plaintext b) under both
    values of the seed's LSB (the codeword select); no width is a
    multiple of the 256-thread block."""
    g = torch.Generator(device="cuda").manual_seed(20 + arity)
    seeds = torch.randint(-2 ** 31, 2 ** 31, (bsz, w, 4), dtype=torch.int64,
                          device="cuda", generator=g)
    byte0 = torch.arange(bsz * w, device="cuda").view(bsz, w) % 256
    seeds[..., 0] = (seeds[..., 0] & ~0xff) | byte0
    seeds = seeds.to(torch.int32)
    cw = torch.randint(-2 ** 31, 2 ** 31, (2, bsz, 8, 4), dtype=torch.int64,
                       device="cuda", generator=g).to(torch.int32)
    c1, c2 = cw[0, :, 2:2 + arity], cw[1, :, 2:2 + arity]
    got = aes_level.aes_level_step(seeds, c1, c2, arity=arity, low32=low32)
    want = aes_level.aes_level_step_plain(seeds, c1, c2, arity, low32=low32)
    assert torch.equal(got, want)
