"""The traced run's reduction of a ``torch.profiler`` trace of the card.

The arithmetic is that of the program's ``utils/profile_batch.py`` and
``utils/profiling.summarize_trace``, copied: the card's own work is the
events of category ``kernel``, ``gpu_memcpy`` and ``gpu_memset``; device
time by name is their summed durations.  Added here: the busy time is
the union of those intervals inside the window, and each idle gap in it
is named by what the host was doing at its midpoint, the innermost
program span open then (``submit``, ``admit``, ``pack``, ``dispatch``,
``wait``, ``decode``), else the client's own span, else ``none``.

Timestamps: the exported trace's ``ts`` plus its ``baseTimeNanoseconds``
is the wall clock in microseconds; spans are on ``time.perf_counter``,
mapped by one pair of readings of both clocks.
"""

from __future__ import annotations

import bisect
import json
import time

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10
#: how far back the search for an enclosing program span walks
SPAN_WALK = 64


def clock_pair() -> tuple:
    """(wall clock us, perf_counter s) read together (tightest of five)."""
    best = None
    for _ in range(5):
        a = time.perf_counter()
        u = time.time_ns() / 1e3
        b = time.perf_counter()
        if best is None or b - a < best[0]:
            best = (b - a, u, (a + b) / 2)
    return best[1], best[2]


def device_events(path: str) -> list:
    """(category, name, start us on the wall clock, duration us) of every
    device event of an exported trace."""
    with open(path) as f:
        doc = json.load(f)
    base = float(doc.get("baseTimeNanoseconds", 0)) / 1e3
    out = []
    for e in doc.get("traceEvents", []):
        if e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES:
            out.append((e["cat"], str(e.get("name", "?")),
                        float(e["ts"]) + base, float(e.get("dur", 0))))
    return out


def _label(t: float, prog, prog_starts, client, client_starts) -> str:
    i = bisect.bisect_right(prog_starts, t) - 1
    for j in range(i, max(-1, i - SPAN_WALK), -1):
        name, a, b = prog[j]
        if a <= t <= b:
            return name
    i = bisect.bisect_right(client_starts, t) - 1
    if i >= 0 and client[i][1] <= t <= client[i][2]:
        return client[i][0]
    return "none"


def reduce(events, w0: float, w1: float, prog_spans=(),
           client_spans=()) -> dict:
    """Busy and kernel seconds inside the window [w0, w1] (wall us), the
    top device ops by summed seconds, and the idle seconds by host
    state.  Spans are (name, start us, end us) on the same clock."""
    ivals = []
    kernel_us = 0.0
    by_name = {}
    for cat, name, a, d in events:
        lo, hi = max(a, w0), min(a + d, w1)
        if hi <= lo:
            continue
        ivals.append((lo, hi))
        if cat == "kernel":
            kernel_us += hi - lo
        key = name[:120]
        by_name[key] = by_name.get(key, 0.0) + (hi - lo)
    ivals.sort()
    busy = 0.0
    gaps = []
    cur = w0
    for lo, hi in ivals:
        if lo > cur:
            gaps.append((cur, lo))
        if hi > cur:
            busy += hi - max(lo, cur)
            cur = hi
    if w1 > cur:
        gaps.append((cur, w1))
    prog = sorted(prog_spans, key=lambda s: s[1])
    client = sorted(client_spans, key=lambda s: s[1])
    ps, cs = [s[1] for s in prog], [s[1] for s in client]
    idle = {}
    for a, b in gaps:
        lab = _label((a + b) / 2, prog, ps, client, cs)
        n, us = idle.get(lab, (0, 0.0))
        idle[lab] = (n + 1, us + (b - a))
    return {
        "busy_s": busy / 1e6,
        "window_s": (w1 - w0) / 1e6,
        "kernel_s": kernel_us / 1e6,
        "device_ops": [[k, v / 1e6] for k, v in sorted(
            by_name.items(), key=lambda kv: -kv[1])[:TOP]],
        "idle_gaps": [["%s (%d gaps)" % (k, n), us / 1e6] for k, (n, us)
                      in sorted(idle.items(), key=lambda kv: -kv[1][1])[:TOP]],
    }
