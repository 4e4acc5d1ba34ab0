"""Device milliseconds a dispatch spends copying its staged keys to the
card: the traced window's host-to-device copies (``Memcpy HtoD`` of
the device trace) over the program's ``dispatches``.  In the window a
dispatch makes one such copy, its staged keys; the table and the
warm-up's copies come before it.  Only a traced run on a card has
something to read."""

HTOD = "Memcpy HtoD"


def read(view):
    d = view.stats.get("dispatches", 0)
    if view.trace is None or not d:
        return None
    s = sum(sec for name, sec in view.trace["device_ops"]
            if name.startswith(HTOD))
    if not s:
        return None
    return 1e3 * s / d
