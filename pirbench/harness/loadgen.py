"""Arrival schedules and request sizes, from a traffic file's parameters.

The arithmetic is a copy of the program's ``serve/loadgen.py``:
exponential gaps at a rate (``poisson_trace``) and request sizes drawn
log-uniform over [lo, hi] (``_draw_batch``).  One change: the schedule
(its gaps and sizes, in their order) comes from the traffic file's own
``shape_seed``; a run's ``--seed`` draws the table and the keys each
request asks for.  Near its knee a queue's tail depends on the order in
which large requests arrive, so a schedule reordered by each seed would
make the seed, and not the program, move the tail.
"""

from __future__ import annotations

import numpy as np


def log_uniform_sizes(rng, count: int, lo: int, hi: int) -> np.ndarray:
    """``count`` sizes, each ``round(exp(U(log lo, log(hi + 1))))``
    clipped to [lo, hi] (``serve/loadgen._draw_batch``)."""
    lo, hi = max(1, int(lo)), max(1, int(hi))
    out = np.empty(count, dtype=np.int64)
    for i in range(count):
        if lo >= hi:
            out[i] = hi
            continue
        b = np.exp(rng.uniform(np.log(lo), np.log(hi + 1)))
        out[i] = int(np.clip(np.round(b), lo, hi))
    return out


def poisson_schedule(traffic: dict, seconds: float):
    """An open-loop schedule: (arrival times in seconds from the window's
    start, keys per arrival).  ``rate_per_s * seconds`` arrivals with
    exponential gaps and log-uniform sizes from ``shape_seed``; the gaps
    are scaled so that the schedule fills the window."""
    rate = float(traffic["rate_per_s"])
    count = max(1, int(round(rate * seconds)))
    shape = np.random.default_rng(int(traffic["shape_seed"]))
    gaps = shape.exponential(1.0 / rate, count)
    sizes = log_uniform_sizes(shape, count, traffic["keys_min"],
                              traffic["keys_max"])
    times = np.cumsum(gaps)
    times *= seconds / (times[-1] + gaps.mean())
    return times, sizes
