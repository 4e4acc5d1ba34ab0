"""Per-batch span tracing for the serving stack.

Port of ``dpf_tpu/obs/tracer.py``: a lightweight ``Tracer`` producing
nested host spans (``submit`` > ``admit`` / ``pack`` / ``dispatch``,
``wait``, ``decode``, the router's ``route`` / ``retry`` / ``failover``
and the supervisor's ``rebuild``) through the module-level ``span()``
helper.  Off by default: with no tracer installed ``span()`` returns
one shared no-op context manager (one global read on the serving hot
path).  Finished spans land in a bounded ring; ``export_chrome()``
writes Chrome trace-event JSON that Perfetto opens beside a
``torch.profiler`` trace of the same run.  Spans are thread-aware (one
nesting stack per thread).
"""

from __future__ import annotations

import itertools
import json
import threading
import time
from collections import deque

from .flight import _env_capacity

#: default bounded span-ring capacity per tracer
SPAN_RING = 8192


class NullSpan:
    """The shared no-op span: ``span()``'s answer when tracing is off.

    Stateless and reentrant — one instance serves every call site
    concurrently, so the off path costs a global read and nothing else.
    """

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        return self


NULL_SPAN = NullSpan()


class Span:
    """One live span; use as a context manager (``Tracer.span``).

    ``set(**attrs)`` attaches attributes any time before exit (e.g. the
    routed construction, the bucket size).  On exit the span computes
    its SELF time (duration minus direct children) and lands in the
    tracer's ring.
    """

    __slots__ = ("name", "attrs", "span_id", "parent_id", "tid",
                 "t0", "dur_s", "_children_s", "_tracer")

    def __init__(self, tracer, name, span_id, parent_id, tid, attrs):
        self._tracer = tracer
        self.name = name
        self.span_id = span_id
        self.parent_id = parent_id
        self.tid = tid
        self.attrs = attrs
        self.t0 = None
        self.dur_s = 0.0
        self._children_s = 0.0

    def set(self, **attrs):
        self.attrs.update(attrs)
        return self

    def __enter__(self):
        self._tracer._push(self)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        self.dur_s = time.perf_counter() - self.t0
        if exc_type is not None:
            self.attrs.setdefault("error", exc_type.__name__)
        self._tracer._pop(self)
        return False


class Tracer:
    """Bounded-ring span recorder; install process-wide via ``enable()``.

    All methods are thread-safe; each thread keeps its own nesting
    stack so concurrent submits/rebuilds produce correctly-parented
    spans on separate tracks.
    """

    def __init__(self, capacity: int | None = None):
        if capacity is None:
            capacity = _env_capacity("DPF_SPAN_RING", SPAN_RING)
        self._ring = deque(maxlen=int(capacity))
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        self._local = threading.local()
        self._epoch = time.perf_counter()
        self.dropped = 0          # spans evicted from the full ring
        self.recorded = 0

    # ------------------------------------------------------- recording

    def span(self, name: str, **attrs) -> Span:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        parent = stack[-1].span_id if stack else None
        return Span(self, name, next(self._ids), parent,
                    threading.get_ident(), attrs)

    def _push(self, sp: Span):
        self._local.stack.append(sp)

    def _pop(self, sp: Span):
        stack = self._local.stack
        # tolerate exotic unwinds: pop through to this span
        while stack and stack[-1] is not sp:
            stack.pop()
        if stack:
            stack.pop()
        if stack:
            stack[-1]._children_s += sp.dur_s
        row = {"name": sp.name, "span_id": sp.span_id,
               "parent_id": sp.parent_id, "tid": sp.tid,
               "ts_us": round((sp.t0 - self._epoch) * 1e6, 1),
               "dur_us": round(sp.dur_s * 1e6, 1),
               "self_us": round(max(0.0, sp.dur_s - sp._children_s)
                                * 1e6, 1)}
        if sp.attrs:
            row["attrs"] = sp.attrs
        with self._lock:
            if len(self._ring) == self._ring.maxlen:
                self.dropped += 1
            self._ring.append(row)
            self.recorded += 1

    # --------------------------------------------------------- reading

    def events(self) -> list:
        """Finished spans, oldest first (each a JSON-ready dict)."""
        with self._lock:
            return list(self._ring)

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self.dropped = 0
            self.recorded = 0

    def digest(self, top: int = 12) -> dict | None:
        """Aggregate SELF time per span name (small enough to embed
        in a benchmark record)."""
        events = self.events()
        if not events:
            return None
        by_name = {}
        total_us = 0.0
        for e in events:
            s = e["self_us"]
            total_us += s
            cnt, us = by_name.get(e["name"], (0, 0.0))
            by_name[e["name"]] = (cnt + 1, us + s)
        spans = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]
        return {"spans_recorded": self.recorded,
                "spans_dropped": self.dropped,
                "host_ms": round(total_us / 1e3, 3),
                "top_spans": [{"span": k, "count": c,
                               "ms": round(us / 1e3, 3)}
                              for k, (c, us) in spans]}

    # --------------------------------------------------------- exports

    def export_jsonl(self, path: str) -> int:
        """One span per line; returns the span count."""
        events = self.events()
        with open(path, "w") as f:
            for e in events:
                f.write(json.dumps(e) + "\n")
        return len(events)

    def chrome_trace(self) -> dict:
        """Chrome trace-event JSON (``ph="X"`` complete events, µs
        timestamps) for Perfetto."""
        events = [{"ph": "M", "pid": 1, "tid": 0, "name": "process_name",
                   "args": {"name": "dpf_tpu_torch host spans"}}]
        tids = {}
        for e in self.events():
            tid = tids.setdefault(e["tid"], len(tids))
            ev = {"ph": "X", "pid": 1, "tid": tid, "name": e["name"],
                  "ts": e["ts_us"], "dur": e["dur_us"]}
            if "attrs" in e:
                ev["args"] = {k: str(v) for k, v in e["attrs"].items()}
            events.append(ev)
        for raw, tid in tids.items():
            events.append({"ph": "M", "pid": 1, "tid": tid,
                           "name": "thread_name",
                           "args": {"name": "host thread %d" % raw}})
        return {"traceEvents": events,
                "displayTimeUnit": "ms"}

    def export_chrome(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)
        return path


# ------------------------------------------------- process-wide tracer

_TRACER: Tracer | None = None


def enable(capacity: int | None = None) -> Tracer:
    """Install (and return) the process tracer; idempotent unless a
    different capacity is requested.  ``capacity=None`` resolves the
    ``DPF_SPAN_RING`` environment knob (else ``SPAN_RING``)."""
    global _TRACER
    if capacity is None:
        capacity = _env_capacity("DPF_SPAN_RING", SPAN_RING)
    if _TRACER is None or _TRACER._ring.maxlen != int(capacity):
        _TRACER = Tracer(capacity)
    return _TRACER


def disable() -> None:
    """Remove the process tracer: ``span()`` reverts to the no-op fast
    path (already-captured spans are dropped with the tracer)."""
    global _TRACER
    _TRACER = None


def get_tracer() -> Tracer | None:
    return _TRACER


def tracing() -> bool:
    return _TRACER is not None


def span(name: str, **attrs):
    """THE hot-path entry point: a real span when tracing is enabled,
    the shared ``NULL_SPAN`` otherwise (one global read, no alloc)."""
    t = _TRACER
    if t is None:
        return NULL_SPAN
    return t.span(name, **attrs)
