"""Per-batch span tracing for the serving stack.

Port of ``dpf_tpu/obs/tracer.py``: a lightweight ``Tracer`` producing
nested host spans (``submit`` > ``admit`` / ``pack`` / ``dispatch``,
``wait``, ``decode``, the router's ``route`` / ``retry`` / ``failover``
and the supervisor's ``rebuild``) through the module-level ``span()``
helper.  Off by default: with no tracer installed ``span()`` returns
one shared no-op context manager (one global read on the serving hot
path).  Finished spans land in a bounded ring; ``export_chrome()``
writes Chrome trace-event JSON that Perfetto opens beside a
``torch.profiler`` trace of the same run, and ``joint_digest`` merges
the spans' self times with the device ops' of such a trace.  Spans are
thread-aware: each thread's spans nest on a track of their own.
"""

from __future__ import annotations

import functools
import hashlib
import itertools
import json
import os
import platform
import shlex
import subprocess
import sys
import sysconfig
import threading
import time
from collections import deque
from pathlib import Path

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
    """One span of the plain-Python recorder (the fallback when the C
    ring of ``spanring.c`` does not build); use as a context manager.

    ``set(**attrs)`` attaches attributes any time before exit (e.g. the
    routed construction, the bucket size).  On exit the span lands in its
    ring as a tuple (name, thread, start, end, attributes);
    ``Tracer.events`` derives ids, parents (the innermost span of the
    same thread whose interval holds it) and SELF times when the ring is
    read.
    """

    __slots__ = ("name", "attrs", "t0", "_ring")

    def set(self, **attrs):
        self.attrs.update(attrs)
        return self

    def __enter__(self):
        self.t0 = _now()
        return self

    def __exit__(self, exc_type, exc, tb):
        t1 = _now()
        if exc_type is not None:
            self.attrs.setdefault("error", exc_type.__name__)
        # deque.append and next() are atomic under the GIL: no lock on
        # the serving path
        ring = self._ring
        ring._rows.append((self.name, _get_ident(), self.t0, t1,
                           self.attrs))
        ring.recorded = next(ring._seq)
        return False


_now = time.perf_counter
_get_ident = threading.get_ident
_new_span = object.__new__


class _PyRing:
    """The plain-Python ring, with the C ring's interface (``span``,
    ``rows``, ``clear``, ``recorded``)."""

    def __init__(self, capacity: int):
        self._rows = deque(maxlen=capacity)
        self._seq = itertools.count(1)
        self.recorded = 0

    def span(self, name, attrs) -> Span:
        sp = _new_span(Span)            # no Python-level __init__ frame
        sp._ring = self
        sp.name = name
        sp.attrs = attrs
        return sp

    def rows(self) -> list:
        return list(self._rows)         # one C call: atomic under the GIL

    def clear(self) -> None:
        self._rows.clear()
        self._seq = itertools.count(1)
        self.recorded = 0


#: the C ring's source; built at the first ``Tracer`` that asks for it
SPANRING_SRC = Path(__file__).resolve().with_name("spanring.c")
_SPANRING_FLAGS = ("-O2", "-shared", "-fPIC")


def _spanring_path() -> Path:
    h = hashlib.sha256(SPANRING_SRC.read_bytes())
    h.update(" ".join(_SPANRING_FLAGS).encode() + sys.version.encode()
             + platform.machine().encode())
    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    return SPANRING_SRC.parent.parent / "_build" / (
        "spanring-%s%s" % (h.hexdigest()[:16], suffix))


@functools.lru_cache(maxsize=None)
def _spanring() -> tuple:
    """(the C ring's module or None, the build's error or None): compiled
    with the C compiler at first use into ``dpf_tpu_torch/_build/``
    (named by a digest of the source, the flags and the interpreter) and
    imported from there.  When there is no compiler or no Python
    headers, tracing records through ``_PyRing`` instead."""
    import importlib.util

    target = _spanring_path()
    if not target.exists():
        target.parent.mkdir(exist_ok=True)
        tmp = target.with_name("%s.%d.tmp" % (target.name, os.getpid()))
        cmd = [*shlex.split(os.environ.get("CC") or "cc"),
               *_SPANRING_FLAGS, "-I" + sysconfig.get_paths()["include"],
               "-o", str(tmp), str(SPANRING_SRC)]
        try:
            res = subprocess.run(cmd, capture_output=True, text=True)
        except OSError as exc:
            return None, "%s: %s" % (" ".join(cmd), exc)
        if res.returncode != 0:
            return None, "%s\n%s" % (" ".join(cmd), res.stderr)
        os.replace(tmp, target)
    spec = importlib.util.spec_from_file_location("spanring", target)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod, None


def spanring_error() -> str | None:
    """Why the C ring did not build (the compiler's output), else None."""
    return _spanring()[1]


class Tracer:
    """Bounded-ring span recorder; install process-wide via ``enable()``.

    All methods are thread-safe; spans of concurrent threads (submits,
    rebuilds) land on separate tracks and nest within their thread.
    Spans record into the C ring of ``spanring.c`` (``native=True``, the
    default, when it builds), else into the plain-Python ring.  A serving
    arrival opens eight spans; a Python span's object, frames and record
    cost a measurable share of an arrival's host time on the card's host
    (``obs/bench_trace.py``'s overhead leg), and the C ring's enter and
    exit run no Python frame.  ``native`` says which ring this tracer
    uses.
    """

    def __init__(self, capacity: int | None = None, native: bool = True):
        if capacity is None:
            capacity = _env_capacity("DPF_SPAN_RING", SPAN_RING)
        self.capacity = int(capacity)
        mod = _spanring()[0] if native else None
        self.native = mod is not None
        if mod is not None:
            self._ring = mod.Ring(self.capacity)
            self._now = mod.now
        else:
            self._ring = _PyRing(self.capacity)
            self._now = _now
        self._span = self._ring.span
        self._lock = threading.Lock()   # readers and clear()
        self._epoch = self._now()

    @property
    def recorded(self) -> int:
        """Spans finished since the tracer was made or cleared."""
        return self._ring.recorded

    @property
    def dropped(self) -> int:
        """Spans evicted from the full ring."""
        return self._ring.recorded - len(self._ring.rows())

    # ------------------------------------------------------- recording

    def span(self, name: str, **attrs):
        return self._span(name, attrs)

    # --------------------------------------------------------- reading

    def events(self) -> list:
        """Finished spans, oldest first (each a JSON-ready dict): ids in
        the order the spans started, each span's parent the span of its
        thread one level up that contains it (None when that one was
        evicted or is still open)."""
        with self._lock:
            rows = self._ring.rows()
        order = sorted(range(len(rows)),
                       key=lambda i: (rows[i][2], rows[i][2] - rows[i][3]))
        ids, parents = [0] * len(rows), [None] * len(rows)
        children, open_ = [0.0] * len(rows), {}
        for sid, i in enumerate(order, 1):
            _, tid, t0, end, _ = rows[i]
            dur = end - t0
            stack = open_.setdefault(tid, [])   # (end, row) holding t0
            while stack and stack[-1][0] < end:
                stack.pop()
            if stack:
                parents[i] = stack[-1][1]
                children[stack[-1][1]] += dur
            ids[i] = sid
            stack.append((end, i))
        out = []
        for i, (name, tid, t0, end, attrs) in enumerate(rows):
            dur = end - t0
            row = {"name": name, "span_id": ids[i],
                   "parent_id": None if parents[i] is None
                   else ids[parents[i]],
                   "tid": tid,
                   "ts_us": round((t0 - self._epoch) * 1e6, 1),
                   "dur_us": round(dur * 1e6, 1),
                   "self_us": round(max(0.0, dur - children[i]) * 1e6, 1)}
            if attrs:
                row["attrs"] = attrs
            out.append(row)
        return out

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()

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
    if _TRACER is None or _TRACER.capacity != int(capacity):
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
    return t._span(name, attrs)


# ---------------------------------------------------------- digesting

def joint_digest(tracer: Tracer | None = None,
                 trace_dir: str | None = None, top: int = 12) -> dict:
    """The one digest benchmark records embed: host span self times
    (this module) merged with the device op self times of a
    ``torch.profiler`` capture of the same run
    (``utils.profiling.summarize_trace``).  Either half may be absent;
    ``total_ms`` sums what is present."""
    host = None
    t = tracer if tracer is not None else _TRACER
    if t is not None:
        host = t.digest(top=top)
    device = None
    if trace_dir:
        from ..utils.profiling import summarize_trace
        device = summarize_trace(trace_dir, top=top)
    total = sum(d[k] for d, k in ((host, "host_ms"),
                                  (device, "device_ms")) if d)
    return {"host": host, "device": device, "total_ms": round(total, 3)}
