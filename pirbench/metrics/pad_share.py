"""Share of dispatched key slots that were padding: ``padded_queries`` /
(``queries_submitted`` + ``padded_queries``) over the window."""


def read(view):
    real = view.stats.get("queries_submitted", 0)
    pad = view.stats.get("padded_queries", 0)
    if real + pad == 0:
        return None
    return pad / (real + pad)
