"""Deterministic open-loop arrival traces for the serving stack.

Port of ``dpf_tpu/serve/loadgen.py`` (numpy only): the same (kind, seed,
params) give the identical trace as the JAX package's on every machine.

* ``poisson_trace``: memoryless arrivals at a constant rate.
* ``bursty_trace``: on/off (Markov-modulated) arrivals: ON windows at a
  high rate delivering near-cap batches, OFF windows a trickle of small
  stragglers; the regime where a sticky scheme choice loses.
* ``diurnal_trace``: a sinusoidal rate ramp (one "day" compressed to
  ``period_s``).
* ``replay_trace``: an explicit batch-size list as timestamped arrivals.

Every generator is open-loop: arrival times are scheduled ahead of time,
independent of service progress, so queues grow when the server falls
behind.  An arrival is ``Arrival(t, n, batch)``: seconds since trace
start, the table domain (None = the harness's single table), and the
number of queries arriving together.  ``squeeze`` replays a trace
faster; the planning helpers ``scale_rate`` (the same under the
planner's name), ``concat_traces`` (traces end to end) and
``bucket_rates`` (dispatches per second at each bucket, what
``serve.registry.GranulePrefetcher`` sizes its page-ins by) compose
and summarize traces.
"""

from __future__ import annotations

import dataclasses

import numpy as np

#: trace kinds ``make_trace`` accepts
KINDS = ("poisson", "bursty", "diurnal", "replay")


@dataclasses.dataclass(frozen=True)
class Arrival:
    """One open-loop arrival: a batch of ``batch`` queries against
    domain ``n`` scheduled at ``t`` seconds after trace start."""
    t: float
    n: int | None
    batch: int


def batch_sizes(trace) -> list:
    """The batch-size view of a trace (timestamps dropped); accepts a
    list of ``Arrival`` or a plain size list (returned as ints)."""
    out = []
    for a in trace:
        out.append(int(a.batch) if isinstance(a, Arrival) else int(a))
    return out


def total_queries(trace) -> int:
    return sum(batch_sizes(trace))


def squeeze(trace, factor: float) -> list:
    """The same arrival sequence compressed in time by ``factor`` (> 1
    = hotter: identical batches delivered ``factor``x faster); the load
    harness's shed leg replays the seeded trace squeezed, so only the
    offered rate changes, never the batch mix."""
    if factor <= 0:
        raise ValueError("factor must be > 0 (got %r)" % (factor,))
    return [Arrival(a.t / factor, a.n, a.batch) for a in trace]


def scale_rate(trace, factor: float) -> list:
    """``squeeze`` under the planner's name: scale the offered load by
    ``factor`` (> 1 = hotter) by compressing arrival times, batches
    untouched."""
    return squeeze(trace, factor)


def concat_traces(*traces, gap_s: float = 0.0) -> list:
    """Traces end to end: each trace's arrivals shifted to start
    ``gap_s`` seconds after the previous trace's last arrival (an empty
    trace adds nothing).  The batch mix is untouched."""
    if gap_s < 0:
        raise ValueError("gap_s must be >= 0 (got %r)" % (gap_s,))
    out = []
    offset = 0.0
    for tr in traces:
        if not tr:
            continue
        base = offset - tr[0].t
        out.extend(Arrival(base + a.t, a.n, a.batch) for a in tr)
        offset = out[-1].t + gap_s
    return out


def bucket_rates(trace, buckets, *, duration_s: float | None = None) -> dict:
    """``{bucket size: dispatches per second}`` of a trace, a zero entry
    for every rung of the ladder (``buckets``: a ``Buckets`` or a size
    list).  Each arrival counts as the engine dispatches it: a batch
    over the cap splits by ``Buckets.chunks``, each chunk in its own
    bucket.  ``duration_s`` defaults to the last arrival's time, at
    least 1 s.  The offline twin of ``SchemeRouter.arrival_rates``."""
    from .buckets import Buckets
    bk = buckets if isinstance(buckets, Buckets) else Buckets(buckets)
    counts = {s: 0 for s in bk.sizes}
    t_last = 0.0
    for a in trace:
        if isinstance(a, Arrival):
            t_last = max(t_last, a.t)
            b = a.batch
        else:
            b = int(a)
        for lo, hi in bk.chunks(b):
            counts[bk.bucket_for(hi - lo)] += 1
    if duration_s is None:
        duration_s = max(t_last, 1.0)
    if duration_s <= 0:
        raise ValueError("duration_s must be > 0 (got %r)" % (duration_s,))
    return {s: c / duration_s for s, c in counts.items()}


def _draw_batch(rng, lo: int, hi: int) -> int:
    """Log-uniform batch size in [lo, hi]: small batches must be common
    enough to exercise the lower ladder rungs, big ones common enough
    to load the device — a uniform draw would almost never produce a
    size-1 straggler at cap=512."""
    lo, hi = max(1, int(lo)), max(1, int(hi))
    if lo >= hi:
        return hi
    b = np.exp(rng.uniform(np.log(lo), np.log(hi + 1)))
    return int(np.clip(np.round(b), lo, hi))


def poisson_trace(*, rate: float, duration_s: float | None = None,
                  arrivals: int | None = None, cap: int = 512,
                  min_batch: int = 1, n: int | None = None,
                  seed: int = 0) -> list:
    """Memoryless arrivals: exponential inter-arrival gaps at ``rate``
    per second, batch sizes log-uniform in [min_batch, cap].  Stop
    after ``duration_s`` seconds or ``arrivals`` arrivals (exactly one
    must be given)."""
    if (duration_s is None) == (arrivals is None):
        raise ValueError("give exactly one of duration_s / arrivals")
    if rate <= 0:
        raise ValueError("rate must be > 0 (got %r)" % (rate,))
    rng = np.random.default_rng(seed)
    out, t = [], 0.0
    while True:
        t += rng.exponential(1.0 / rate)
        if duration_s is not None and t >= duration_s:
            break
        out.append(Arrival(t, n, _draw_batch(rng, min_batch, cap)))
        if arrivals is not None and len(out) >= arrivals:
            break
    return out


def bursty_trace(*, on_rate: float, off_rate: float, on_s: float,
                 off_s: float, duration_s: float, cap: int = 512,
                 n: int | None = None, seed: int = 0) -> list:
    """On/off (two-state Markov-modulated) Poisson arrivals.

    ON windows of ``on_s`` seconds fire at ``on_rate``/s with batch
    sizes concentrated near ``cap`` (the loaded-burst regime: cap or
    cap/2, occasionally smaller); OFF windows of ``off_s`` seconds
    trickle at ``off_rate``/s with small straggler batches (log-uniform
    in [1, cap/8]).  This is the mixed-shape traffic where the fastest
    construction per delivered batch size changes mid-trace — the
    router's target workload."""
    if on_rate <= 0 or off_rate <= 0:
        raise ValueError("rates must be > 0")
    if on_s <= 0 or off_s <= 0:
        raise ValueError("window lengths must be > 0")
    rng = np.random.default_rng(seed)
    out, t0, on = [], 0.0, True
    while t0 < duration_s:
        # simulate each window at its own rate: the inter-arrival clock
        # restarts at every state switch, so a long OFF gap cannot leap
        # over (and silence) the ON windows behind it
        window = on_s if on else off_s
        end = min(t0 + window, duration_s)
        rate = on_rate if on else off_rate
        t = t0
        while True:
            t += rng.exponential(1.0 / rate)
            if t >= end:
                break
            out.append(Arrival(t, n, _bursty_batch(rng, on, cap)))
        t0, on = t0 + window, not on
    return out


def _bursty_batch(rng, on: bool, cap: int) -> int:
    if on:
        r = rng.random()
        if r < 0.6:
            return cap
        if r < 0.9:
            return max(1, cap // 2)
        return _draw_batch(rng, max(1, cap // 4), cap)
    return _draw_batch(rng, 1, max(1, cap // 8))


def diurnal_trace(*, base_rate: float, peak_rate: float,
                  period_s: float, duration_s: float, cap: int = 512,
                  n: int | None = None, seed: int = 0) -> list:
    """A sinusoidal rate ramp — one traffic "day" compressed into
    ``period_s`` seconds, rate swinging base → peak → base.  Arrivals
    are drawn by thinning a Poisson stream at ``peak_rate`` (the exact
    inhomogeneous-Poisson recipe), so the realized rate tracks the
    ramp; batch sizes scale with the instantaneous load (near-cap at
    peak, small at trough)."""
    if not 0 < base_rate <= peak_rate:
        raise ValueError("need 0 < base_rate <= peak_rate")
    rng = np.random.default_rng(seed)
    out, t = [], 0.0
    while True:
        t += rng.exponential(1.0 / peak_rate)
        if t >= duration_s:
            break
        phase = (1 - np.cos(2 * np.pi * t / period_s)) / 2   # 0..1..0
        rate = base_rate + (peak_rate - base_rate) * phase
        if rng.random() > rate / peak_rate:
            continue                      # thinned out
        hi = max(1, int(round(cap * max(phase, 1.0 / cap))))
        out.append(Arrival(t, n, _draw_batch(rng, 1, hi)))
    return out


def replay_trace(sizes, *, rate: float | None = None,
                 n: int | None = None) -> list:
    """Lift an explicit batch-size list into arrivals: uniform gaps of
    ``1/rate`` seconds (``rate=None`` = all at t=0, a closed-loop
    back-to-back replay)."""
    gap = 0.0 if rate is None else 1.0 / rate
    return [Arrival(i * gap, n, int(b)) for i, b in enumerate(sizes)]


def make_trace(kind: str, **kw) -> list:
    """Dispatch by trace kind ("poisson" / "bursty" / "diurnal" /
    "replay")."""
    if kind == "poisson":
        return poisson_trace(**kw)
    if kind == "bursty":
        return bursty_trace(**kw)
    if kind == "diurnal":
        return diurnal_trace(**kw)
    if kind == "replay":
        return replay_trace(**kw)
    raise ValueError("unknown trace kind %r (one of %s)"
                     % (kind, ", ".join(KINDS)))


def default_trace(kind: str, cap: int, *, seed: int = 7,
                  duration_s: float = 4.0) -> list:
    """A canonical small trace per kind (a deterministic non-trivial
    trace without repeating rate math)."""
    if kind == "poisson":
        return poisson_trace(rate=30.0, duration_s=duration_s, cap=cap,
                             seed=seed)
    if kind == "bursty":
        return default_bursty(cap, seed=seed, duration_s=duration_s)
    if kind == "diurnal":
        return diurnal_trace(base_rate=4.0, peak_rate=40.0,
                             period_s=duration_s / 2,
                             duration_s=duration_s, cap=cap, seed=seed)
    raise ValueError("no default trace for kind %r (one of poisson, "
                     "bursty, diurnal)" % (kind,))


def default_bursty(cap: int, *, seed: int = 11,
                   duration_s: float = 8.0) -> list:
    """A canonical moderate bursty trace (1 s bursts at 40/s every
    3 s, a 2/s straggler trickle in between).  The load harness
    (``bench_load.load_bench``) takes its own rates, recorded in its
    record's ``trace`` field."""
    return bursty_trace(on_rate=40.0, off_rate=2.0, on_s=1.0, off_s=2.0,
                        duration_s=duration_s, cap=cap, seed=seed)
