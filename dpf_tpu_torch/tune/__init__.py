"""Autotuning over the CUDA kernels' launch knobs (port of
``dpf_tpu/tune``).

The launch geometry the rest of the port fixes by heuristic is measured
instead, every timed candidate equality-gated against the scalar
oracle, and the winners persisted in a JSON cache keyed by device
fingerprint x shape (``cache``, ``fingerprint``): ``search.tune_eval``
(staged coordinate descent over ``chunk_leaves``, ``dot_impl``,
``kernel_impl``, ``dispatch_group``, ``aes_impl``, and K4's
``row_chunk``), ``search.scheme_sweep`` (which construction wins a
shape; ``cache.lookup_scheme``), ``kernel_search`` (mutate/tournament
over whole launch-knob variants of K4, the GGM routes and the batched
keygen; ``kvariant`` entries that ``api.DPF.resolved_eval_knobs`` takes
with provenance ``"searched"``) and ``serve_tune`` (the engine's ladder
and window, the scheme router's knobs).  ``compcache`` is the kernels'
content-hashed build cache.  ``mesh_tune`` and the cluster tier of
``serve_tune`` come with the port's multi-GPU item.
"""

from .cache import (  # noqa: F401
    TuningCache, default_cache, lookup_eval_knobs, lookup_kernel_variant,
    lookup_keygen_variant, lookup_scheme)
from .compcache import enable as enable_compilation_cache  # noqa: F401
from .fingerprint import cache_key, device_fingerprint  # noqa: F401
from .kernel_search import (  # noqa: F401
    KernelVariant, kernel_search, kernel_search_ggm, kernel_search_sweep,
    keygen_search, mutate_variant, sample_variant, variant_invalid)
from .search import (  # noqa: F401
    autotune_sweep, heuristic_knobs, heuristic_scheme, scheme_sweep,
    stage_candidates, tune_eval)
from .serve_tune import (  # noqa: F401
    lookup_router_knobs, lookup_serve_knobs, synthetic_trace,
    tune_router, tune_serving)
