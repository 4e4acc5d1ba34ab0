"""Process start to the first timed submit: imports, the CUDA context,
the kernels' library (built in a checkout's first run), the table, the
key pool, ``eval_init`` and the warm-up of the cell's own buckets."""


def read(view):
    return view.setup_s
