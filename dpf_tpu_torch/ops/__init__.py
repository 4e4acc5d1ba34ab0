"""The port's CUDA kernels (``csrc/``), their wrappers and plain
versions.  ``launch_counts()`` reads every wrapper's launch counter in
this process (a worker or a rank reports its own) and
``zero_launch_counts()`` sets them all to 0."""

import importlib

#: kernel name -> (module of ``ops``, its wrapper, the wrapper's counter).
#: K1 at arity 4 and the per-key modes count on their wrapper's second
#: counter.
LAUNCH_COUNTERS = {
    "aes_level_step": ("aes_level", "aes_level_step", "launches"),
    "aes_level_step_a4": ("aes_level", "aes_level_step", "launches_a4"),
    "subtree_contract": ("subtree", "subtree_contract", "launches"),
    "subtree_contract_mixed": ("subtree", "subtree_contract_mixed",
                               "launches"),
    "contract_i32": ("matmul128", "dot_i32", "launches"),
    "sqrt_grid_contract": ("sqrt_grid", "sqrt_grid_contract", "launches"),
    "chacha_level_step": ("subtree", "chacha_level_step", "launches"),
    "contract_i32_per_key": ("matmul128", "dot_i32_per_key", "launches"),
    "subtree_contract_pkt": ("subtree", "subtree_contract", "launches_pkt"),
    "subtree_contract_mixed_pkt": ("subtree", "subtree_contract_mixed",
                                   "launches_pkt"),
    "sqrt_grid_contract_pkt": ("sqrt_grid", "sqrt_grid_contract",
                               "launches_pkt"),
    "prf_zoo": ("prf_zoo", "zoo_eval", "launches")}


def _counters():
    for name, (module, wrapper, attr) in LAUNCH_COUNTERS.items():
        fn = getattr(importlib.import_module("." + module, __name__), wrapper)
        yield name, fn, attr


def launch_counts() -> dict:
    """{kernel name: launches so far in this process}."""
    return {name: getattr(fn, attr) for name, fn, attr in _counters()}


def zero_launch_counts() -> None:
    """Set every launch counter of this process to 0."""
    for _, fn, attr in _counters():
        setattr(fn, attr, 0)
