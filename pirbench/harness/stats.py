"""Quantiles: the nearest-rank rule of the program's
``utils/profiling.quantile``, so a tail reads the same sample the
program's own counters would."""

from __future__ import annotations


def quantile(samples, q: float) -> float:
    """Nearest-rank quantile of a non-empty sequence (q in [0, 1])."""
    if not samples:
        raise ValueError("quantile of an empty sample set")
    if not 0.0 <= q <= 1.0:
        raise ValueError("q must be in [0, 1] (got %r)" % (q,))
    s = sorted(samples)
    return s[min(len(s) - 1, max(0, int(q * len(s) + 0.5) - 1))]
