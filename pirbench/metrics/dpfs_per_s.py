"""Keys answered in the window over the window's seconds (first submit
to last answer): all the work over all the time.  Closed-loop cells."""


def read(view):
    if view.cell["traffic"]["loop"] != "closed" or view.window_s <= 0:
        return None
    return sum(r.keys for r in view.answered) / view.window_s
