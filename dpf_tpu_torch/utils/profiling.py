"""Serving counters, cache counters, the swallowed-error registry and
the profiler helpers.

Port of ``dpf_tpu/utils/profiling.py``: ``EngineCounters`` (per-engine
pack / dispatch / wait host time, the latency ring and histogram,
admission and recovery counts), ``CacheCounters`` / ``CACHE_COUNTERS``
(the tuning cache's hits, misses and stores; the build cache's
``compile_*``), ``note_swallowed`` / ``swallowed_snapshot``,
``quantile``, the latency constants, ``Timer`` and the trace helpers.
``jax.profiler`` becomes ``torch.profiler``: ``trace`` writes a Chrome
trace and ``summarize_trace`` reads the device ops' self times from it.

On the card the three host times split a served batch's host work:
``pack_time_s`` is the decode, the bucket pad and the copy into pinned
staging; ``dispatch_time_s`` the enqueue of the key upload, the kernels
and the result's download; ``wait_time_s`` the host blocking on a
part's CUDA event.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import tempfile
import threading
import time
import warnings

#: where ``trace`` writes when no directory is given
DEFAULT_TRACE_DIR = os.path.join(tempfile.gettempdir(),
                                 "dpf_tpu_torch_traces")


@contextlib.contextmanager
def trace(config_name: str, base_dir: str | None = None):
    """Capture a ``torch.profiler`` trace (host ops, and CUDA kernels and
    copies when a card is present) named after the benchmark config;
    yields the directory that receives ``<config_name>.pt.trace.json``."""
    import torch
    path = os.path.join(base_dir or DEFAULT_TRACE_DIR, config_name)
    os.makedirs(path, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        try:
            yield path
        finally:
            if torch.cuda.is_available() and torch.cuda.is_initialized():
                torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(path,
                                          config_name + ".pt.trace.json"))


def _self_times(track_events):
    """(name, self_us) per complete event of ONE track, with nested
    children's durations subtracted from their parents (host stacks
    nest; summing raw durations would count a frame once per
    ancestor)."""
    evs = sorted(track_events,
                 key=lambda e: (float(e.get("ts", 0)),
                                -float(e.get("dur", 0))))
    out = []
    stack = []  # (end, index into out); parents below children
    for e in evs:
        ts = float(e.get("ts", 0))
        dur = float(e.get("dur", 0))
        while stack and stack[-1][0] <= ts:
            stack.pop()
        if stack:
            out[stack[-1][1]][1] -= dur
        out.append([str(e.get("name", "?"))[:80], dur])
        stack.append((ts + dur, len(out) - 1))
    return out


#: Chrome-trace categories of the card's own work in a torch.profiler
#: export: kernels, copies and fills
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def summarize_trace(trace_dir: str, top: int = 12):
    """Digest a captured trace into {device_ms, top_ops} (or None).

    Reads the newest ``*.trace.json`` (or ``.json.gz``) under
    ``trace_dir``, picks the card's tracks (events of category
    ``kernel``, ``gpu_memcpy`` or ``gpu_memset``), else the host's
    ``cpu_op`` events (a CPU run: tagged ``cpu_ops``, so the digest is
    never read as device time), else every complete event, and sums
    SELF time per op name per (pid, tid) track."""
    import glob
    import gzip
    import json as _json

    paths = sorted(glob.glob(os.path.join(trace_dir, "**", "*.trace.json"),
                             recursive=True)
                   + glob.glob(os.path.join(trace_dir, "**",
                                            "*.trace.json.gz"),
                               recursive=True), key=os.path.getmtime)
    if not paths:
        return None
    opener = gzip.open if paths[-1].endswith(".gz") else open
    with opener(paths[-1], "rt") as f:
        events = _json.load(f).get("traceEvents", [])
    complete = [e for e in events if e.get("ph") == "X"]
    chosen = [e for e in complete if e.get("cat") in DEVICE_CATEGORIES]
    track_kind = "cuda_device"
    if not chosen:
        chosen = [e for e in complete if e.get("cat") == "cpu_op"]
        track_kind = "cpu_ops"
    if not chosen:
        chosen, track_kind = complete, "all_tracks_incl_host"
    tracks = {}
    for e in chosen:
        tracks.setdefault((e.get("pid"), e.get("tid")), []).append(e)
    by_op = {}
    total_us = 0.0
    for track in tracks.values():
        for name, self_us in _self_times(track):
            total_us += self_us
            by_op[name] = by_op.get(name, 0.0) + self_us
    ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
    return {"trace_file": os.path.basename(paths[-1]),
            "tracks": track_kind,
            "device_ms": round(total_us / 1e3, 3),
            "top_ops": [{"op": k, "ms": round(v / 1e3, 3)}
                        for k, v in ops]}


def quantile(samples, q: float, *, presorted: bool = False) -> float:
    """Nearest-rank quantile of a sequence of floats (q in [0, 1]).
    numpy-free: admission control reads it on every ``submit``."""
    if not samples:
        raise ValueError("quantile of an empty sample set")
    if not 0.0 <= q <= 1.0:
        raise ValueError("q must be in [0, 1] (got %r)" % (q,))
    s = samples if presorted else sorted(samples)
    return s[min(len(s) - 1, max(0, int(q * len(s) + 0.5) - 1))]


#: bounded size of the per-engine latency ring
LATENCY_RING = 2048

#: fixed upper bounds (seconds) of the per-engine latency histogram,
#: 1 ms .. 10 s, +Inf bucket implicit
LATENCY_HIST_BUCKETS_S = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                          0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


def _hist_zero() -> list:
    return [0] * (len(LATENCY_HIST_BUCKETS_S) + 1)


@dataclasses.dataclass
class EngineCounters:
    """Per-engine serving counters (``serve/engine.py``).

    Host pack time, dispatch time and wait time are split so the
    host/device overlap the engine buys is visible; per-batch
    submit→result latencies land in a bounded ring (p50/p95/p99) and a
    cumulative fixed-bucket histogram; ``deadline_misses`` and
    ``shed_*`` count deadline trips and admission rejections; the
    recovery counters count retries, failovers, breaker opens, engine
    rebuilds and suppressed errors.  ``reset()`` and ``merge()`` let a
    router aggregate engines.  The ``note_*`` recorders, ``inc()``,
    ``merge``/``reset`` and the readers hold the per-instance lock;
    single-owner writes inside an engine stay plain updates.
    """
    batches_submitted: int = 0
    queries_submitted: int = 0
    dispatches: int = 0
    padded_queries: int = 0       # pad rows dispatched (bucket waste)
    in_flight_hwm: int = 0        # high-water mark of the dispatch window
    pack_time_s: float = 0.0
    dispatch_time_s: float = 0.0
    wait_time_s: float = 0.0
    deadline_misses: int = 0      # cooperative-deadline trips
    shed_batches: int = 0         # batches rejected by admission control
    shed_queries: int = 0         # queries inside those batches
    retries: int = 0              # re-attempts after a failed submit
    failovers: int = 0            # batches moved to another construction
    breaker_opens: int = 0        # circuit-breaker closed->open trips
    engine_restarts: int = 0      # supervisor engine rebuilds
    swallowed_errors: int = 0     # caught-and-suppressed exceptions
    _latencies: list = dataclasses.field(default_factory=list, repr=False)
    _lat_pos: int = 0
    _lat_sorted: list | None = dataclasses.field(default=None,
                                                 repr=False)
    _lat_hist: list = dataclasses.field(default_factory=_hist_zero,
                                        repr=False)
    _lat_hist_sum: float = dataclasses.field(default=0.0, repr=False)
    _lat_hist_count: int = dataclasses.field(default=0, repr=False)
    _lock: object = dataclasses.field(
        default_factory=threading.RLock, repr=False, compare=False)

    def inc(self, name: str, delta=1):
        """Thread-safe ``self.<name> += delta``."""
        with self._lock:
            setattr(self, name, getattr(self, name) + delta)

    def note_dispatch(self, padded: int, in_flight: int):
        with self._lock:
            self.dispatches += 1
            self.padded_queries += padded
            self.in_flight_hwm = max(self.in_flight_hwm, in_flight)

    def note_latency(self, seconds: float):
        """Record one batch's submit→result latency in the ring and the
        histogram."""
        s = float(seconds)
        with self._lock:
            if len(self._latencies) < LATENCY_RING:
                self._latencies.append(s)
            else:
                self._latencies[self._lat_pos] = s
                self._lat_pos = (self._lat_pos + 1) % LATENCY_RING
            self._lat_sorted = None
            i = 0
            while (i < len(LATENCY_HIST_BUCKETS_S)
                   and s > LATENCY_HIST_BUCKETS_S[i]):
                i += 1
            self._lat_hist[i] += 1
            self._lat_hist_sum += s
            self._lat_hist_count += 1

    def quantile(self, q: float) -> float | None:
        """Latency quantile over the ring (seconds), None when empty."""
        with self._lock:
            if not self._latencies:
                return None
            if self._lat_sorted is None:
                self._lat_sorted = sorted(self._latencies)
            return quantile(self._lat_sorted, q, presorted=True)

    def latency_histogram(self) -> dict:
        with self._lock:
            return {"buckets": list(LATENCY_HIST_BUCKETS_S),
                    "counts": list(self._lat_hist),
                    "sum": round(self._lat_hist_sum, 6),
                    "count": self._lat_hist_count}

    @property
    def p50(self):
        return self.quantile(0.50)

    @property
    def p95(self):
        return self.quantile(0.95)

    @property
    def p99(self):
        return self.quantile(0.99)

    @property
    def pad_waste(self) -> float:
        """Fraction of dispatched query slots that were padding."""
        total = self.queries_submitted + self.padded_queries
        return self.padded_queries / total if total else 0.0

    def reset(self) -> "EngineCounters":
        """Zero every counter and drop the latency ring and histogram,
        in place (the lock survives)."""
        with self._lock:
            for f in dataclasses.fields(self):
                if f.name == "_lock":
                    continue
                setattr(
                    self, f.name,
                    f.default if f.default_factory is dataclasses.MISSING
                    else f.default_factory())
        return self

    def merge(self, other: "EngineCounters") -> "EngineCounters":
        """Fold ``other`` into self: sums for the additive counters, max
        for the high-water mark, the latency rings pooled (downsampled
        by a uniform stride past the ring bound) and the histograms
        added.  Locks both in id order; merging into itself is a
        no-op.  Returns self."""
        if other is self:
            return self
        first, second = ((self, other) if id(self) <= id(other)
                         else (other, self))
        with first._lock, second._lock:
            for f in dataclasses.fields(self):
                if f.name.startswith("_") or f.name == "in_flight_hwm":
                    continue
                setattr(self, f.name,
                        getattr(self, f.name) + getattr(other, f.name))
            self.in_flight_hwm = max(self.in_flight_hwm,
                                     other.in_flight_hwm)
            pooled = self._latencies + other._latencies
            if len(pooled) > LATENCY_RING:
                step = len(pooled) / LATENCY_RING
                pooled = [pooled[int(i * step)]
                          for i in range(LATENCY_RING)]
            self._latencies = pooled
            self._lat_pos = 0
            self._lat_sorted = None
            self._lat_hist = [a + b for a, b in
                              zip(self._lat_hist, other._lat_hist)]
            self._lat_hist_sum += other._lat_hist_sum
            self._lat_hist_count += other._lat_hist_count
        return self

    def as_dict(self) -> dict:
        with self._lock:
            d = {}
            for f in dataclasses.fields(self):
                if f.name.startswith("_"):
                    continue
                v = getattr(self, f.name)
                d[f.name] = round(v, 6) if isinstance(v, float) else v
            d["pad_waste"] = round(self.pad_waste, 4)
            if self._latencies:
                d["latency_ms"] = {
                    "count": len(self._latencies),
                    "p50": round(self.p50 * 1e3, 3),
                    "p95": round(self.p95 * 1e3, 3),
                    "p99": round(self.p99 * 1e3, 3),
                }
            return d


@dataclasses.dataclass
class CacheCounters:
    """Process-wide cache-effectiveness counters (``tune/``).

    ``tuning_*`` move on every tuning-cache lookup and store
    (``tune/cache.py``); ``compile_hits`` / ``compile_misses`` count the
    build cache (``ops/cuda_build.build``: a kernel library already
    present under its content digest is a hit, one compiled now a
    miss).  ``compile_time_saved_s`` keeps ``dpf_tpu``'s field and stays
    0: a hit's compile time is not known."""
    tuning_hits: int = 0
    tuning_misses: int = 0
    tuning_stores: int = 0
    compile_hits: int = 0
    compile_misses: int = 0
    compile_time_saved_s: float = 0.0

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["compile_time_saved_s"] = round(d["compile_time_saved_s"], 4)
        return d

    def reset(self) -> "CacheCounters":
        """Zero every counter in place."""
        for f in dataclasses.fields(self):
            setattr(self, f.name, f.default)
        return self


CACHE_COUNTERS = CacheCounters()


#: process-wide registry of caught-and-suppressed exceptions:
#: site -> {exception class name -> count}
SWALLOWED_ERRORS: dict = {}
_SWALLOWED_WARNED: set = set()
_SWALLOWED_LOCK = threading.Lock()


def note_swallowed(site: str, exc: BaseException, stats=None) -> None:
    """Record a deliberately suppressed exception: count it per (site,
    class), bump ``stats.swallowed_errors`` when given, and warn once
    per (site, class) per process.  Never raises."""
    try:
        cls = type(exc).__name__
        with _SWALLOWED_LOCK:
            by_cls = SWALLOWED_ERRORS.setdefault(site, {})
            by_cls[cls] = by_cls.get(cls, 0) + 1
            warn = (site, cls) not in _SWALLOWED_WARNED
            if warn:
                _SWALLOWED_WARNED.add((site, cls))
        if stats is not None:
            if hasattr(stats, "inc"):
                stats.inc("swallowed_errors")
            else:
                stats.swallowed_errors += 1
        if warn:
            warnings.warn(
                "suppressed %s at %s: %s (further occurrences counted "
                "in dpf_tpu_torch.utils.profiling.SWALLOWED_ERRORS, not "
                "re-warned)" % (cls, site, exc), RuntimeWarning,
                stacklevel=3)
    except Exception:
        pass


def swallowed_snapshot() -> dict:
    """A JSON-ready copy of the swallowed-error registry."""
    with _SWALLOWED_LOCK:
        return {site: dict(by_cls) for site, by_cls in
                sorted(SWALLOWED_ERRORS.items())}


class Timer:
    """Wall-clock block timer that waits for the card: ``__exit__``
    calls ``torch.cuda.synchronize()`` when CUDA is initialized in this
    process, so the asynchronous launches of the block are counted."""

    def __init__(self):
        self.elapsed = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        import torch
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        self.elapsed = time.perf_counter() - self._t0
        return False
