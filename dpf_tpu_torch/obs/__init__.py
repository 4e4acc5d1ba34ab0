"""Serving observability: the span tracer and the flight recorder.

Port of the ``dpf_tpu/obs`` names serving imports: ``tracer`` (per-batch
host spans, off by default) and ``flight`` (a bounded ring of recent
routing and fault decisions).  ``record_sections()`` is what benchmark
records embed: the flight tail, the swallowed-error registry and, when
a tracer is installed, its span digest.  The metrics registry
(``dpf_tpu/obs/metrics.py``) is not ported yet.
"""

from .flight import FLIGHT, FlightRecorder, flight_dump  # noqa: F401
from .tracer import (NULL_SPAN, NullSpan, Span, Tracer,  # noqa: F401
                     disable, enable, get_tracer, span, tracing)


def record_sections(flight_last: int = 64) -> dict:
    """The observability sections a benchmark record embeds:
    ``flight`` (the tail of the decision ring), ``swallowed`` (the
    suppressed-error registry) and, when a tracer is installed,
    ``trace_digest`` (host span self-times)."""
    from ..utils.profiling import swallowed_snapshot
    out = {"flight": flight_dump(last=flight_last),
           "swallowed": swallowed_snapshot()}
    t = get_tracer()
    if t is not None:
        out["trace_digest"] = t.digest()
    return out
