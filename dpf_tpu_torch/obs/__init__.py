"""Serving observability: the span tracer, the flight recorder and the
metrics registry.

Port of ``dpf_tpu/obs``: ``tracer`` (per-batch host spans, off by
default), ``flight`` (a bounded ring of recent routing, residency and
fault decisions) and ``metrics`` (typed counters, gauges and histograms
with an OpenMetrics text export; engines, routers, the table registry
and the tenant router register their series when built).
``record_sections()`` is what benchmark records embed.  The JAX
package's ``bench_trace``, ``register_cluster`` and
``set_process_index`` wait for the port's multi-GPU item.
"""

from .flight import FLIGHT, FlightRecorder, flight_dump  # noqa: F401
from .metrics import (REGISTRY, Counter, Gauge, Histogram,  # noqa: F401
                      MetricsRegistry, default_registry, register_engine,
                      register_router)
from .tracer import (NULL_SPAN, NullSpan, Span, Tracer,  # noqa: F401
                     disable, enable, get_tracer, span, tracing)


def record_sections(flight_last: int = 64) -> dict:
    """The observability sections a benchmark record embeds:
    ``metrics`` (the registry's JSON snapshot), ``flight`` (the tail of
    the decision ring), ``swallowed`` (the suppressed-error registry)
    and, when a tracer is installed, ``trace_digest`` (host span
    self-times)."""
    from ..utils.profiling import swallowed_snapshot
    out = {"metrics": REGISTRY.snapshot(),
           "flight": flight_dump(last=flight_last),
           "swallowed": swallowed_snapshot()}
    t = get_tracer()
    if t is not None:
        out["trace_digest"] = t.digest()
    return out
