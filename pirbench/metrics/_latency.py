"""Open-loop latency: from each arrival's scheduled time to its answer
on the host, over every arrival of the window; a request that failed
counts as never answered (infinitely late)."""

from pirbench.harness.stats import quantile


def latency_ms(view, q: float):
    if view.cell["traffic"]["loop"] != "open" or not view.requests:
        return None
    lat = [(r.done - r.due) * 1e3 if r.shares is not None else float("inf")
           for r in view.requests]
    return quantile(lat, q)
