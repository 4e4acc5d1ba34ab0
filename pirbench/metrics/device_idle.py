"""Share of the traced window in which no kernel, copy or fill ran on
the card: 1 - (the union of device intervals / the window)."""


def read(view):
    if view.trace is None or view.trace["window_s"] <= 0:
        return None
    return 1.0 - view.trace["busy_s"] / view.trace["window_s"]
