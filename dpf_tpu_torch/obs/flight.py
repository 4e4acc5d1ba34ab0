"""Flight recorder: a bounded ring of recent routing and fault decisions.

Port of ``dpf_tpu/obs/flight.py``.  Every decision point of the serving
stack (route, shed, deadline, breaker transition, retry, failover,
injected fault, rebuild, engine close) appends one small structured
event to a process-wide bounded ring, dumpable on demand
(``flight_dump()``) and embedded in benchmark records.  Events carry a
monotonic timestamp relative to recorder start and a global sequence
number, so interleavings across threads stay ordered.  Recording is
always on: one dict and one deque append per decision, no I/O.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque

#: default bounded flight-ring capacity (events, not queries)
FLIGHT_RING = 2048


def _env_capacity(name: str, default: int) -> int:
    """Positive-int ring capacity from the environment, else the
    default (a malformed value must never break recorder import)."""
    try:
        v = int(os.environ.get(name, ""))
        return v if v > 0 else default
    except (TypeError, ValueError):
        return default


class FlightRecorder:
    """Thread-safe bounded event ring; ``FLIGHT`` is the process one.

    ``capacity`` defaults to ``DPF_FLIGHT_RING`` from the environment
    (else ``FLIGHT_RING``); ``dropped`` counts events evicted from a
    full ring."""

    def __init__(self, capacity: int | None = None):
        if capacity is None:
            capacity = _env_capacity("DPF_FLIGHT_RING", FLIGHT_RING)
        self._ring = deque(maxlen=int(capacity))
        self._lock = threading.Lock()
        self._t0 = time.monotonic()
        self.recorded = 0           # total ever recorded (ring evicts)
        self.dropped = 0            # events evicted from the full ring

    @property
    def capacity(self) -> int:
        return self._ring.maxlen

    def record(self, kind: str, **attrs) -> None:
        """Append one event; never raises (decision paths call this)."""
        try:
            ev = {"seq": 0, "t": round(time.monotonic() - self._t0, 6),
                  "kind": kind}
            ev.update(attrs)
            with self._lock:
                self.recorded += 1
                ev["seq"] = self.recorded
                if len(self._ring) == self._ring.maxlen:
                    self.dropped += 1
                self._ring.append(ev)
        except Exception:
            pass

    def dump(self, last: int | None = None) -> list:
        """JSON-ready copy of the ring, oldest first (``last`` bounds
        the tail)."""
        with self._lock:
            out = list(self._ring)
        if last is not None:
            out = out[-int(last):]
        return out

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
        # `recorded` keeps counting: it is a monotonic metric

    def export_jsonl(self, path: str) -> int:
        events = self.dump()
        with open(path, "w") as f:
            for e in events:
                f.write(json.dumps(e) + "\n")
        return len(events)


#: the process flight recorder (serving code records into this)
FLIGHT = FlightRecorder()


def flight_dump(last: int | None = None) -> list:
    """Dump the process flight ring."""
    return FLIGHT.dump(last=last)
