"""How late the open-loop client ran: the 95th percentile over arrivals
of (submit call - scheduled time), in ms.  The client is one thread, so
a blocking answer or a full engine window delays the next submit."""

from pirbench.harness.stats import quantile


def read(view):
    if view.cell["traffic"]["loop"] != "open" or not view.requests:
        return None
    return quantile([(r.sent - r.due) * 1e3 for r in view.requests], 0.95)
