"""The whole window's share of the card's peak, in %: the least time for
the window's answered keys (as ``kernel_roofline``) over the traced
window's seconds.  It bounds every kernel's share from the outside, so a
kernel taken off the path still shows here."""


def read(view):
    if view.trace is None or view.trace["window_s"] <= 0:
        return None
    return 100.0 * view.least_s / view.trace["window_s"]
