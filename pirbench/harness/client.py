"""The benchmark's clients: one closed loop that keeps the engine's
window full, and one open loop that submits each arrival when it is due.

The open loop is the method of the program's ``serve/bench_load.replay``:
one thread, arrivals released at their scheduled times (back to back
when behind), the oldest outstanding answer resolved while ahead of
schedule, and each latency counted from the scheduled arrival to the
answer on the host.  A request that raises counts as failed.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np

perf = time.perf_counter


@dataclass
class Request:
    """One client request: ``rows`` indices into the key pool."""
    rows: np.ndarray
    due: float                  # scheduled (open) or issued (closed), s
    sent: float = 0.0           # when submit() was called, s
    done: float | None = None   # when the answer reached the host, s
    shares: np.ndarray | None = None
    error: str | None = None
    future: object = field(default=None, repr=False)

    @property
    def keys(self) -> int:
        return int(self.rows.shape[0])


class Recorder:
    """The client's own spans (label, start, end; perf_counter seconds),
    kept only in a traced run."""

    def __init__(self, on: bool):
        self.on = on
        self.spans = []

    def add(self, label: str, t0: float, t1: float) -> None:
        if self.on:
            self.spans.append((label, t0, t1))


def _submit(engine, pool, req: Request, t0: float, rec: Recorder):
    a = perf()
    req.sent = a - t0
    try:
        req.future = engine.submit(pool[req.rows])
    except Exception as e:          # a refused or failed request
        req.error = repr(e)
    rec.add("client.submit", a, perf())


def _resolve(req: Request, t0: float, rec: Recorder):
    a = perf()
    try:
        req.shares = req.future.result()
    except Exception as e:
        req.error = repr(e)
    req.future = None
    b = perf()
    req.done = b - t0
    rec.add("client.result", a, b)


def closed_loop(engine, pool, batches, seconds: float, outstanding: int,
                rec: Recorder):
    """Submit batch after batch (cycling through ``batches``, arrays of
    pool rows) for ``seconds``, never more than ``outstanding``
    unanswered; then wait for every answer.  Returns (requests, the
    window's seconds: first submit to last answer)."""
    reqs, pend = [], deque()
    t0 = perf()
    i = 0
    while perf() - t0 < seconds:
        req = Request(batches[i % len(batches)], perf() - t0)
        i += 1
        _submit(engine, pool, req, t0, rec)
        reqs.append(req)
        if req.error is None:
            pend.append(req)
        while len(pend) >= outstanding:
            _resolve(pend.popleft(), t0, rec)
    while pend:
        _resolve(pend.popleft(), t0, rec)
    return reqs, perf() - t0


def open_loop(engine, pool, times, rows, outstanding: int, rec: Recorder):
    """Submit request j (pool rows ``rows[j]``) at ``times[j]`` seconds;
    while ahead of schedule, resolve the oldest outstanding answer, else
    sleep; hold at most ``outstanding`` unanswered.  Returns (requests,
    the window's seconds: start to last answer)."""
    reqs, pend = [], deque()
    t0 = perf()
    for due, r in zip(times, rows):
        req = Request(r, float(due))
        while True:
            now = perf() - t0
            if now >= due:
                break
            if pend:
                _resolve(pend.popleft(), t0, rec)
            else:
                a = perf()
                time.sleep(min(due - now, 0.02))
                rec.add("client.sleep", a, perf())
        while len(pend) >= outstanding:
            _resolve(pend.popleft(), t0, rec)
        _submit(engine, pool, req, t0, rec)
        reqs.append(req)
        if req.error is None:
            pend.append(req)
    while pend:
        _resolve(pend.popleft(), t0, rec)
    return reqs, perf() - t0
