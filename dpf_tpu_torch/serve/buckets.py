"""Shape-bucketed batching (port of ``dpf_tpu/serve/buckets.py``).

The engine pads each incoming batch up to the smallest member of a small
fixed set of power-of-two bucket sizes, so a ragged stream dispatches a
bounded set of batch shapes, each of which ``ServingEngine.warmup`` runs
once.  On the TPU every shape is a compiled program; the card's kernels
take any batch, so here the buckets bound the shapes whose first launch
happens under traffic and keep the engine's accounting (``padded_queries``,
``pad_waste``) the JAX package's.  Pad rows are evaluated and discarded:
with the default /2 ladder a batch lands at most 2x above its real size.
"""

from __future__ import annotations


class Buckets:
    """A sorted set of power-of-two batch-shape buckets."""

    def __init__(self, sizes):
        sizes = sorted({int(s) for s in sizes})
        if not sizes:
            raise ValueError("need at least one bucket size")
        for s in sizes:
            if s < 1 or (s & (s - 1)) != 0:
                raise ValueError(
                    "bucket sizes must be powers of two >= 1 (got %r)"
                    % (s,))
        self.sizes = tuple(sizes)
        self.max = sizes[-1]

    @staticmethod
    def default_sizes(cap: int, fanout: int = 2, count: int = 4) -> tuple:
        """A geometric ladder below ``cap``: cap, cap/fanout, ... (powers
        of two; a non-power-of-two cap rounds down).  cap=512 -> (64,
        128, 256, 512)."""
        s = 1
        while s * 2 <= max(1, cap):
            s *= 2
        out = []
        while s >= 1 and len(out) < count:
            out.append(s)
            s //= fanout
        return tuple(reversed(out))

    def bucket_for(self, b: int) -> int:
        """Smallest bucket >= b (b must be in (0, max])."""
        if b < 1:
            raise ValueError("batch must be >= 1 (got %d)" % b)
        for s in self.sizes:
            if s >= b:
                return s
        raise ValueError("batch %d exceeds the largest bucket %d "
                         "(split with chunks())" % (b, self.max))

    def chunks(self, b: int) -> list:
        """Split a batch of ``b`` keys into (lo, hi) spans, each at most
        one max bucket wide: full max-sized spans then one remainder."""
        if b < 1:
            raise ValueError("batch must be >= 1 (got %d)" % b)
        spans = []
        lo = 0
        while b - lo > self.max:
            spans.append((lo, lo + self.max))
            lo += self.max
        spans.append((lo, b))
        return spans
