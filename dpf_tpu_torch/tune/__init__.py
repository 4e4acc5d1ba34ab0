"""Tuning (port of ``dpf_tpu/tune``, started): the construction the
scheme router falls back to when no measurement has seeded it
(``search.heuristic_scheme``).  The tuning cache, the searches and the
kernel-variant search are not ported yet (ROADMAP Queue 1 item 8)."""

from .search import heuristic_scheme  # noqa: F401
