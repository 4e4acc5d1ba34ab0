"""Extended PRF zoo: round-parameterized Salsa/ChaCha cores + benchmark.

Port of ``dpf_tpu/core/prf_zoo.py``.  The reference's paper tree
benchmarked 13 candidate PRFs to pick GPU-friendly ones
(``paper/kernel/gpu/dpf_gpu/prf/prf.cu:8-95``); this module keeps that
exploration: the shipped wire-compatible PRFs stay in ``prf.py``; here
are round-count variants (Salsa20/8, Salsa20/20, ChaCha8, ChaCha20, ...),
the hash candidates of ``prf_zoo_hash.py`` and a throughput benchmark.

NOTE: zoo variants are NOT wire-compatible with the reference keys -- they
exist for PRF-selection studies, like the paper's.  15 candidates: the
paper's 13 plus the two block-PRG additions (``chacha12_blk`` /
``salsa20_12_blk``, 4 GGM children per core call).  Of these,
``highway_proxy`` is an op-mix *proxy* for the HighwayHash family (see
``prf_zoo_hash.py``); every summary of the zoo should carry that
asterisk.

Every candidate maps ``(seeds [n, 4] int32, pos: int) -> [n, 4] int32``
(uint32 bits) with ``dpf_tpu``'s bits, on any device: these are the
plain versions.  ``benchmark_zoo`` times K7 (``ops/prf_zoo.py``,
``csrc/prf_zoo.cu``, one instance a candidate) on the card and these
plain cores on the CPU: eager torch on the card would time one launch
per xor.
"""

from __future__ import annotations

import json
import time

import numpy as np
import torch

from .prf import (_blk_group, _chacha20_12_words, _chacha_core,
                  _chacha_state, _prf_blk, _salsa20_12_words, _salsa_core,
                  _salsa_state)
from .prf_zoo_hash import HASH_ZOO


def make_salsa_core(rounds: int):
    """Salsa20/<rounds> with the framework's key/pos placement."""
    if rounds % 2:
        raise ValueError("rounds must be even, got %d" % rounds)

    def fn(seeds, pos: int):
        out = _salsa_core(_salsa_state(seeds, pos), rounds)
        return torch.stack([out[4], out[3], out[2], out[1]], dim=-1)

    fn.__name__ = "salsa20_%d" % rounds
    return fn


def make_chacha_core(rounds: int):
    """ChaCha<rounds> with the framework's key/pos placement."""
    if rounds % 2:
        raise ValueError("rounds must be even, got %d" % rounds)

    def fn(seeds, pos: int):
        out = _chacha_core(_chacha_state(seeds, pos), rounds)
        return torch.stack([out[7], out[6], out[5], out[4]], dim=-1)

    fn.__name__ = "chacha%d" % rounds
    return fn


def _blk_candidate(words_fn):
    def fn(seeds, pos: int):
        return _prf_blk(words_fn, seeds, pos)
    return fn


# Block-PRG candidates (core/prf_ref.py::prf_*_blk): one core call yields
# FOUR GGM children, so their selection metric is children/sec = 4x their
# calls/sec (``CHILDREN_PER_CALL``)
BLK_WORDS_FNS = {"chacha12_blk": _chacha20_12_words,
                 "salsa20_12_blk": _salsa20_12_words}

ZOO = {
    "salsa20_8": make_salsa_core(8),
    "salsa20_12": make_salsa_core(12),
    "salsa20_20": make_salsa_core(20),
    "chacha8": make_chacha_core(8),
    "chacha12": make_chacha_core(12),
    "chacha20": make_chacha_core(20),
    **HASH_ZOO,
    **{name: _blk_candidate(fn) for name, fn in BLK_WORDS_FNS.items()},
}

# GGM children produced per candidate call (default 1): the DPF cost
# model counts children, so benchmark_zoo scales by this
CHILDREN_PER_CALL = {"chacha12_blk": 4, "salsa20_12_blk": 4}


def all_children(name: str, seeds: torch.Tensor, ctr: int = 0):
    """A block-PRG candidate's four children of the block at counter
    ``ctr``, ``[4, n, 4]`` (what ``prf_multi`` serves and the benchmark
    materializes)."""
    out = BLK_WORDS_FNS[name](seeds, ctr)
    return torch.stack([_blk_group(out, 4 * b) for b in range(4)])


def benchmark_zoo(n_calls=1 << 20, reps=5, names=None, device=None):
    """Throughput of each candidate on ``device`` (None = CUDA).

    Returns {name: ggm_children_per_sec} -- calls/sec scaled by
    ``CHILDREN_PER_CALL`` (1 for classic per-child PRFs, 4 for the
    block-PRG candidates), the metric the DPF cost model selects on.
    For the block-PRG candidates the timed call materializes ALL FOUR
    128-bit children from the one core block, as ``dpf_tpu`` times them.
    On the card each call is one launch of K7 (``ops.prf_zoo.zoo_eval``),
    timed with CUDA events after a warm-up launch; on the CPU the plain
    cores, on the host clock.  Prints ``dpf_tpu``'s result line per
    candidate (the paper's PRF-selection experiment)."""
    from ..api import resolve_device
    from ..ops.prf_zoo import zoo_eval

    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    seeds = torch.from_numpy(rng.integers(0, 2 ** 32, (n_calls, 4),
                                          dtype=np.uint32).view(np.int32))
    seeds = seeds.to(dev)
    results = {}
    for name in (names or ZOO):
        kids = CHILDREN_PER_CALL.get(name, 1)

        def call():
            return zoo_eval(name, seeds, 0 if kids > 1 else 1)

        call()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                call()
            stop.record()
            stop.synchronize()
            seconds = start.elapsed_time(stop) / 1e3
        else:
            t0 = time.perf_counter()
            for _ in range(reps):
                call()
            seconds = time.perf_counter() - t0
        per_sec = n_calls * reps / seconds
        results[name] = per_sec * kids
        print(json.dumps({"prf_candidate": name, "calls": n_calls,
                          "reps": reps, "children_per_call": kids,
                          "timed_children_materialized": kids,
                          "prf_calls_per_sec": int(per_sec),
                          "ggm_children_per_sec": int(per_sec * kids)}))
    return results
