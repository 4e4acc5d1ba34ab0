"""The kernels' share of their roofline, in %: the least time the card
needs for the window's answered keys (``work/<name>.py`` priced by
``harness/peaks.py``) over the summed device time of every kernel in
the traced window.  It reads the same work whatever kernels do it, so a
share above 100% would mean the work is counted too high."""


def read(view):
    if view.trace is None or view.trace["kernel_s"] <= 0:
        return None
    return 100.0 * view.least_s / view.trace["kernel_s"]
