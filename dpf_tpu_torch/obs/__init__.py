"""Serving observability: the span tracer, the flight recorder and the
metrics registry.

Port of ``dpf_tpu/obs``: ``tracer`` (per-batch host spans, off by
default), ``flight`` (a bounded ring of recent routing, residency and
fault decisions) and ``metrics`` (typed counters, gauges and histograms
with an OpenMetrics text export; engines, routers, the table registry
and the tenant router register their series when built).
``record_sections()`` is what benchmark records embed;
``tracer.joint_digest`` merges host spans with a ``torch.profiler``
trace and ``bench_trace`` is the observability benchmark.
``set_process_index`` labels a process's flight events and series with
its rank (multi-host serving).  The JAX package's ``register_planner``
waits for the port's planning item.
"""

from .flight import FLIGHT, FlightRecorder, flight_dump  # noqa: F401
from .metrics import (REGISTRY, Counter, Gauge, Histogram,  # noqa: F401
                      MetricsRegistry, default_registry, register_cluster,
                      register_engine, register_router)
from .tracer import (NULL_SPAN, NullSpan, Span, Tracer,  # noqa: F401
                     disable, enable, get_tracer, joint_digest, span,
                     tracing)


def set_process_index(index: int | None) -> None:
    """Label this process's observability output with its rank
    (multi-host serving): flight events gain a ``process`` attribute and
    engine, router and cluster series a ``process`` label.
    ``multihost.initialize`` calls it; cluster workers set theirs."""
    from .flight import set_process_index as _flight
    from .metrics import set_process_index as _metrics
    _flight(index)
    _metrics(index)


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
