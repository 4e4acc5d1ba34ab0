"""95th-percentile latency over all arrivals of the window (the nearest
rank of the whole set, not a median of chunks; ``_latency.py``)."""

from pirbench.metrics._latency import latency_ms


def read(view):
    return latency_ms(view, 0.95)
