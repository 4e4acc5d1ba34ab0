"""Shared readers for the measurement results JSONL (port of
``dpf_tpu/utils/results.py``: the same functions, standard library only).

``experiments/tpu_all.py`` appends one record per measurement point to
``tpu_results.jsonl`` across rounds and retries; every record carries a
``sid`` (one per session process) and ``t`` (unix time).  Consumers
(``bench.py``, ``scripts/report.py``, ``experiments/
scaling_projection.py``) must not mix sessions or rounds: a stale fast
row from an earlier session/round would advertise numbers the current
code cannot reproduce and mask regressions.  The canonical scope is the
latest session that completed with data (``stage=="session"`` record
with ``done: true``) *within the current build round* (round boundary =
first PROGRESS.jsonl entry of the max round).
"""

from __future__ import annotations

import json
import os


def load_rows(path):
    """All well-formed dict records from a results JSONL (missing file
    or garbage lines -> skipped)."""
    rows = []
    try:
        with open(path) as f:
            for line in f:
                try:
                    r = json.loads(line)
                except ValueError:
                    continue
                if isinstance(r, dict):
                    rows.append(r)
    except OSError:
        pass
    return rows


def round_start_t(repo_dir=None):
    """Unix time the current build round started (first PROGRESS.jsonl
    entry of the max round), or None when the boundary is unknowable
    (no/unparsable PROGRESS.jsonl).  Callers FAIL CLOSED on None."""
    if repo_dir is None:
        repo_dir = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))
    starts = {}
    try:
        with open(os.path.join(repo_dir, "PROGRESS.jsonl")) as f:
            for line in f:
                try:
                    r = json.loads(line)
                    starts.setdefault(int(r["round"]), float(r["ts"]))
                except (ValueError, KeyError, TypeError):
                    continue
    except OSError:
        return None
    return starts[max(starts)] if starts else None


def _t(r):
    try:
        return float(r.get("t", 0))
    except (TypeError, ValueError):
        return 0.0


def latest_done_sid(rows, since=None):
    """sid of the newest completed session (``done: true``) at/after
    ``since``, else None."""
    sid = None
    for r in rows:
        if (r.get("stage") == "session" and r.get("done")
                and r.get("sid") is not None
                and (since is None or _t(r) >= since)):
            sid = r["sid"]
    return sid


def session_rows(rows, sid=None, since=None):
    """Rows of session ``sid`` (default: latest session completed
    at/after ``since``).  [] when none exists — consumers fail closed
    rather than mixing sessions or rounds.

    When ``since`` is given, rows timestamped before it are dropped even
    if they belong to the selected session: a session straddling the
    round boundary (started late in round N, completed in round N+1)
    must not leak pre-round measurements into "measured this round"
    consumers (bench.py's cache, report.py renderers)."""
    if sid is None:
        sid = latest_done_sid(rows, since=since)
    if sid is None:
        return []
    return [r for r in rows if r.get("sid") == sid
            and (since is None or _t(r) >= since)]
