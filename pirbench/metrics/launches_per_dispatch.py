"""Kernel launches a dispatch: the program's ``ops.launch_counts()``
summed over kernels, over the window, divided by its ``dispatches``.
Nothing to read where no kernel launched (a run without a card)."""


def read(view):
    d = view.stats.get("dispatches", 0)
    total = sum(view.launches.values())
    if not d or not total:
        return None
    return total / d
