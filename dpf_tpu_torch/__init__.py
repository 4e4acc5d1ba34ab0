"""dpf_tpu_torch -- the DPF / two-server PIR server on PyTorch and CUDA.

The PyTorch port of ``dpf_tpu`` (which stays the reference): client-side
key generation -- O(log N) GGM keys, the reference's 524-int32 binary
keys or radix-4 keys (``EvalConfig(radix=4)``), or O(sqrt N) grid keys
(``DPF(scheme="sqrtn")``) -- and server-side batched expansion + table
contraction on an NVIDIA H100 through hand-written CUDA kernels
(``csrc/``): AES-128 level expansion at arity 2 or 4, Salsa20/ChaCha20
subtree expansion + contraction over a binary or radix-4 schedule, the
sqrt-N PRF grid fused with its contraction, the exact int32
contraction, and a ChaCha20 level step.  Shares are bit-identical to
``dpf_tpu``'s.  This package imports neither JAX nor ``dpf_tpu``.
"""

from .api import DPF  # noqa: F401
from .core.prf_ref import (  # noqa: F401
    PRF_AES128, PRF_CHACHA20, PRF_CHACHA20_BLK, PRF_DUMMY, PRF_SALSA20,
    PRF_SALSA20_BLK)
from .utils.config import EvalConfig  # noqa: F401

__version__ = "0.1.0"
