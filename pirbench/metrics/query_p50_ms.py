"""Median latency over all arrivals of the window (``_latency.py``)."""

from pirbench.metrics._latency import latency_ms


def read(view):
    return latency_ms(view, 0.50)
