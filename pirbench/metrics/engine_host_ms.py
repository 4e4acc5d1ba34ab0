"""Host milliseconds the engine spends a dispatch on pack (decode, pad,
pinned staging) and dispatch (enqueue of upload, kernels, download):
(``pack_time_s`` + ``dispatch_time_s``) / ``dispatches`` of the
program's ``EngineCounters`` over the window."""


def read(view):
    d = view.stats.get("dispatches", 0)
    if not d:
        return None
    return 1e3 * (view.stats["pack_time_s"]
                  + view.stats["dispatch_time_s"]) / d
