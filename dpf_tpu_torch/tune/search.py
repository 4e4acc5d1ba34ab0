"""The construction heuristic of ``dpf_tpu/tune/search.py``.

Only ``heuristic_scheme`` is ported: the scheme router's sticky fallback
(``serve/router.resolve_sticky``) reads it.  The staged search and the
tuning cache come with ROADMAP Queue 1 item 8.
"""

from __future__ import annotations


def heuristic_scheme(n: int) -> dict:
    """Cold-cache construction default: the reference-wire-compatible
    binary GGM tree (deliberately conservative; the measured winner per
    shape comes from a scheme sweep, not ported yet)."""
    return {"scheme": "logn", "radix": 2}
