"""Generative kernel-variant search over the CUDA kernels' launch knobs.

Port of ``dpf_tpu/tune/kernel_search.py``.  ``search.py`` does staged
coordinate descent over one knob at a time; this module searches whole
points of a family's space, each a serializable :class:`KernelVariant`,
by seeded mutate/tournament over a population that always holds the
staged-descent winner and the heuristics, so it can never regress
either.  The record grammar is ``dpf_tpu``'s; the three families are
retargeted to the launch knobs the CUDA wrappers take from Python:

- ``"xla"`` (sqrt-N, :func:`kernel_search`): ``row_chunk``, K4's grid
  step (``ops/sqrt_grid.sqrt_grid_contract``'s ``grid_rows``);
- ``"ggm"`` (log-N, binary tree, :func:`kernel_search_ggm`): ``engine``
  ``"fused"`` (K2 from its frontier for the stream ciphers: ``chunk_leaves``
  its block subtree, ``f_levels`` its frontier; AES and DUMMY one launch a
  level: ``chunk_leaves`` the live-seed chunk, ``f_levels`` the phase-1
  frontier, ``dot_impl`` the contraction) or ``"dispatch"`` (the per-level
  mode: ``chunk_leaves``, ``dispatch_group``, ``dot_impl``);
- ``"keygen"`` (:func:`keygen_search`): ``prf_group``, ``path_reuse`` and
  ``squeeze_draws`` of the batched generators on the host; fitness is
  keys/s and the wire bytes are the gate.

**Trust model.**  Every timed eval candidate first passes the
scalar-oracle equality gate (its full ``[B, E]`` shares equal
``DPF.eval_cpu``'s), through the real dispatch path with the variant in
the resolver's searched slot (``kernel_resolved_from="searched"`` is
asserted); every timed keygen candidate gives the scalar generator's
wire bytes for every key and both servers.  :func:`variant_invalid`
refuses a variant before it is built, including every field of the TPU's
Pallas launchers (``tb``, ``max_cells``, ``grid_order``,
``dim_semantics``, ``limbs``, ``cw_add``, the ``"pallas"`` family and
engine), so a clean search reports ``rejected == 0`` and
``gate_escapes == 0``.  ``dpf_tpu``'s second gate, interpret-mode parity
of the Pallas variants (``pallas_parity_ok``), has no meaning on the
card: no Pallas kernel runs here, and the records keep its fields empty
(``pallas_pinned: []``).  The oracle gate is the trust model.

Winners persist as ``kvariant|...`` entries (the key carries (scheme,
radix), keygen entries the ``entry_size=0`` sentinel), read by
``api.DPF.resolved_eval_knobs`` and ``DPF.gen_batch``.

    python -m dpf_tpu_torch.tune.kernel_search --family sqrtn|logn|keygen|all
        [--shapes N:B,...] [--prf ID] [--dryrun] [--device cpu] [--out FILE]

mirrors ``benchmark.py --autotune-kernel``.
"""

from __future__ import annotations

import dataclasses
import json
import random
import time

import numpy as np
import torch

from ..api import resolve_device
from ..core import expand, sqrtn, u128
from ..core.prf_ref import PRF_CHACHA20, PRF_NAMES
from ..ops import matmul128
from ..utils.profiling import CACHE_COUNTERS
from . import compcache
from .cache import TuningCache, default_cache
from .fingerprint import cache_key, device_fingerprint
from .search import _Gate, _workload, heuristic_knobs, tune_eval

#: tuning-cache entry kind for searched kernel variants
VARIANT_KIND = "kvariant"

#: sampled DRBG squeeze-chunk widths (None = one squeeze for all draws;
#: the same stream either way)
_SQUEEZE_CHOICES = (None, 1, 2, 4, 8, 16)

#: the fields of the TPU's Pallas launchers: refused on the card
PALLAS_FIELDS = ("tb", "max_cells", "grid_order", "dim_semantics",
                 "limbs", "cw_add")

_GGM_ENGINE_IMPL = {"fused": "fused", "dispatch": "dispatch"}
#: a descent's kernel_impl (or a JAX-written one) -> the GGM engine
_IMPL_GGM_ENGINE = {"fused": "fused", "xla": "fused", "dispatch": "dispatch"}


@dataclasses.dataclass(frozen=True)
class KernelVariant:
    """One point in a family's space, serializable into the tuning
    cache.  ``None`` fields mean the route's default; a variant changes
    the launches, never a bit of the answer (nor, for keygen, a wire
    byte).  The Pallas fields are kept so ``dpf_tpu``'s records read back
    (``from_dict``); :func:`variant_invalid` refuses them."""
    family: str = "xla"
    row_chunk: int | None = None
    dot_impl: str | None = None
    tb: int | None = None
    max_cells: int | None = None
    grid_order: str | None = None
    dim_semantics: str | None = None
    limbs: str | None = None
    cw_add: str | None = None
    # --- ggm family (log-N expansion) ---
    engine: str | None = None
    chunk_leaves: int | None = None
    f_levels: int | None = None
    dispatch_group: int | None = None
    # --- keygen family (batched generators) ---
    prf_group: str | None = None
    path_reuse: str | None = None
    squeeze_draws: int | None = None

    def to_dict(self) -> dict:
        return {k: v for k, v in dataclasses.asdict(self).items()
                if v is not None}

    @classmethod
    def from_dict(cls, d: dict) -> "KernelVariant":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in dict(d).items() if k in known})

    def eval_knobs(self) -> dict:
        """This variant as the resolved-knob dict the resolver's
        searched slot carries; ``kernel_variant`` names the family."""
        if self.family == "ggm":
            return {
                "kernel_impl": _GGM_ENGINE_IMPL.get(self.engine or "fused"),
                "chunk_leaves": self.chunk_leaves,
                "dot_impl": self.dot_impl,
                "dispatch_group": self.dispatch_group,
                "f_levels": self.f_levels,
                "kernel_variant": self.to_dict(),
            }
        if self.family == "keygen":
            raise ValueError(
                "keygen variants carry no eval knobs: use keygen_knobs()")
        return {"kernel_impl": "fused", "row_chunk": self.row_chunk,
                "dot_impl": self.dot_impl,
                "kernel_variant": self.to_dict()}

    def keygen_knobs(self) -> dict:
        """This variant as the batched generators' ``knobs=`` dict; {}
        is the baseline."""
        if self.family != "keygen":
            raise ValueError("not a keygen variant: %s" % self.tag())
        return {k: getattr(self, k) for k in _KEYGEN_FIELDS
                if getattr(self, k) is not None}

    def tag(self) -> str:
        if self.family == "ggm":
            if (self.engine or "fused") == "dispatch":
                return "g.d.c%s.g%s.%s" % (self.chunk_leaves,
                                           self.dispatch_group,
                                           self.dot_impl)
            return "g.f.c%s.fl%s.%s" % (self.chunk_leaves, self.f_levels,
                                        self.dot_impl)
        if self.family == "keygen":
            return "k.%s.%s.sq%s" % (self.prf_group or "pair",
                                     self.path_reuse or "walk",
                                     self.squeeze_draws or "all")
        return "x.rc%s.%s" % (self.row_chunk, self.dot_impl)


def _k2(prf_method: int, v: KernelVariant) -> bool:
    """Does this GGM variant reach K2 (a stream cipher, fused engine)?"""
    return (prf_method in expand.SUBTREE_PRFS
            and (v.engine or "fused") == "fused")


def variant_invalid(v: KernelVariant, *, n: int, batch: int,
                    prf_method: int) -> str | None:
    """Why this variant may not be built for this shape on the card
    (None = valid).  Mutation and sampling consult it first, so an
    invalid variant never reaches the gate."""
    for f in PALLAS_FIELDS:
        if getattr(v, f) is not None:
            return ("%s is a field of the TPU's Pallas launchers, with no "
                    "meaning on the card" % f)
    if v.family == "pallas" or v.engine == "pallas":
        return "the Pallas kernels are the TPU's; the card runs K2 and K4"
    if v.dot_impl is not None and \
            v.dot_impl not in matmul128.available_impls():
        return "dot_impl %r unavailable" % (v.dot_impl,)
    if v.family == "xla":
        if v.row_chunk is not None:
            k, r = sqrtn.default_split(n)
            rc = v.row_chunk
            if rc <= 0 or r % rc or (rc != r and rc % sqrtn.ROW_CHUNK_FLOOR):
                return "row_chunk %r invalid for R=%d" % (rc, r)
        return None
    if v.family == "ggm":
        return _ggm_variant_invalid(v, n=n, batch=batch,
                                    prf_method=prf_method)
    if v.family == "keygen":
        if v.prf_group not in (None, "stacked"):
            return "prf_group %r" % (v.prf_group,)
        if v.path_reuse not in (None, "reuse"):
            return "path_reuse %r" % (v.path_reuse,)
        if v.squeeze_draws is not None and (
                not isinstance(v.squeeze_draws, int)
                or isinstance(v.squeeze_draws, bool)
                or v.squeeze_draws < 1):
            return "squeeze_draws %r" % (v.squeeze_draws,)
        return None
    return "unknown family %r" % (v.family,)


def _ggm_variant_invalid(v: KernelVariant, *, n: int, batch: int,
                         prf_method: int) -> str | None:
    """Validity of one GGM (binary tree) variant: every value must be
    one its route takes as asked, so the search never times a clamped
    request."""
    from ..ops.subtree import frontier_level_candidates, subtree_chunk_leaves
    eng = v.engine or "fused"
    if eng not in _GGM_ENGINE_IMPL:
        return "unknown ggm engine %r" % (eng,)
    if v.chunk_leaves is not None:
        c = int(v.chunk_leaves)
        if c <= 0 or c & (c - 1) or c > n:
            return "chunk_leaves %r invalid for N=%d" % (c, n)
        if _k2(prf_method, v):
            if c > subtree_chunk_leaves(n):
                return "chunk_leaves %d over K2's block of at most %d" % (
                    c, subtree_chunk_leaves(n))
        elif expand.clamp_chunk(c, n, batch) != c:
            return ("chunk_leaves %d over the live-seed budget at batch %d"
                    % (c, batch))
    if eng == "dispatch":
        if v.f_levels is not None:
            return ("f_levels is a fused-engine axis (the dispatch engine "
                    "groups its frontier instead)")
        if v.dispatch_group is not None:
            g = int(v.dispatch_group)
            f = n // (v.chunk_leaves or expand.choose_chunk(n, batch))
            if g < 1 or f % g:
                return "dispatch_group %r does not divide F=%d" % (g, f)
        return None
    if v.dispatch_group is not None:
        return "dispatch_group is a dispatch-engine axis"
    if _k2(prf_method, v) and v.dot_impl is not None:
        return "dot_impl has no meaning on K2 (it contracts inside)"
    if v.f_levels is not None:
        if _k2(prf_method, v):
            c = v.chunk_leaves or subtree_chunk_leaves(n)
            legal = frontier_level_candidates(n, c, batch)
        else:
            c = v.chunk_leaves or expand.clamp_chunk(None, n, batch)
            legal = expand.f_level_candidates(n, c, batch)
        if int(v.f_levels) not in legal:
            return ("f_levels %r illegal for chunk %d at batch %d"
                    % (v.f_levels, c, batch))
    return None


_XLA_FIELDS = ("row_chunk",)
_KEYGEN_FIELDS = ("prf_group", "path_reuse", "squeeze_draws")


def _mutable_fields(v: KernelVariant, prf_method: int) -> tuple:
    """The searched fields of ``v``'s family (a GGM engine is fixed at
    sampling: a hop between engines is another program family)."""
    if v.family == "ggm":
        if (v.engine or "fused") == "dispatch":
            return ("chunk_leaves", "dispatch_group", "dot_impl")
        if _k2(prf_method, v):
            return ("chunk_leaves", "f_levels")
        return ("chunk_leaves", "f_levels", "dot_impl")
    if v.family == "keygen":
        return _KEYGEN_FIELDS
    return _XLA_FIELDS


def _field_choices(v: KernelVariant, field: str, *, n: int, batch: int,
                   prf_method: int) -> list:
    """Legal values of one field at this shape (:func:`variant_invalid`
    still has the final word on the combination)."""
    if v.family == "ggm":
        from ..ops.subtree import (block_leaves_candidates,
                                   frontier_level_candidates,
                                   subtree_chunk_leaves)
        k2 = _k2(prf_method, v)
        if field == "chunk_leaves":
            return (block_leaves_candidates(n) if k2
                    else expand.chunk_candidates(n, batch))
        if field == "dot_impl":
            return list(matmul128.available_impls())
        if field == "dispatch_group":
            f = n // (v.chunk_leaves or expand.choose_chunk(n, batch))
            return [None] + [g for g in (1, 2, 4, 8)
                             if g <= f and f % g == 0]
        if k2:                                       # f_levels, K2
            c = v.chunk_leaves or subtree_chunk_leaves(n)
            return [None] + frontier_level_candidates(n, c, batch)
        c = v.chunk_leaves or expand.clamp_chunk(None, n, batch)
        return [None] + expand.f_level_candidates(n, c, batch)
    if v.family == "keygen":
        return {"prf_group": [None, "stacked"],
                "path_reuse": [None, "reuse"],
                "squeeze_draws": list(_SQUEEZE_CHOICES)}[field]
    from ..ops.sqrt_grid import row_chunk_candidates
    k, r = sqrtn.default_split(n)
    return row_chunk_candidates(r, k, batch)


def mutate_variant(rng: random.Random, v: KernelVariant, *, n: int,
                   batch: int, prf_method: int,
                   tries: int = 16) -> KernelVariant | None:
    """One structural mutation: re-draw a single field from its legal
    choices, keeping the combination valid.  Deterministic under the
    caller's seeded ``rng``; None when no valid novel mutation was found
    in ``tries`` draws."""
    fields = _mutable_fields(v, prf_method)
    for _ in range(tries):
        field = rng.choice(fields)
        choices = [c for c in _field_choices(v, field, n=n, batch=batch,
                                             prf_method=prf_method)
                   if c != getattr(v, field)]
        if not choices:
            continue
        cand = dataclasses.replace(v, **{field: rng.choice(choices)})
        if variant_invalid(cand, n=n, batch=batch,
                           prf_method=prf_method) is None:
            return cand
    return None


def sample_variant(rng: random.Random, family: str, *, n: int,
                   batch: int, prf_method: int, tries: int = 32,
                   engine: str | None = None) -> KernelVariant | None:
    """One random valid variant of ``family`` (fields drawn in order, so
    ``f_levels`` sees the drawn ``chunk_leaves``).  ``engine`` pins the
    GGM engine; None draws one."""
    for _ in range(tries):
        eng = engine
        if family == "ggm" and eng is None:
            eng = rng.choice(tuple(_GGM_ENGINE_IMPL))
        probe = KernelVariant(family=family,
                              engine=eng if family == "ggm" else None)
        for f in _mutable_fields(probe, prf_method):
            choices = _field_choices(probe, f, n=n, batch=batch,
                                     prf_method=prf_method)
            if choices:
                probe = dataclasses.replace(probe,
                                            **{f: rng.choice(choices)})
        if variant_invalid(probe, n=n, batch=batch,
                           prf_method=prf_method) is None:
            return probe
    return None


# ------------------------------------------------------------- search


def _tournament(rng, pop, measure, *, n, pb, prf_method, generations,
                population, log, counts):
    """Seeded mutate/tournament: time every new member (``measure`` ->
    seconds or None), keep the fastest half, refill with single-field
    mutations of the survivors.  Returns {variant: seconds}."""
    scores = {}
    for gen in range(generations):
        for v in pop:
            if v in scores:
                continue
            if variant_invalid(v, n=n, batch=pb,
                               prf_method=prf_method) is not None:
                counts["rejected"] += 1   # defensive: sampling pre-filters
                continue
            t = measure(v)
            if t is not None:
                scores[v] = t
                if log:
                    log("  gen%d %-36s %.6fs" % (gen, v.tag(), t))
        if gen == generations - 1:
            break
        ranked = sorted((s for s in scores.items() if s[0] in pop),
                        key=lambda s: s[1])
        survivors = [v for v, _ in ranked[:max(2, population // 2)]]
        if not survivors:
            break
        pop = list(survivors)
        stale = 0
        while len(pop) < population and stale < 4 * population:
            child = mutate_variant(rng, rng.choice(survivors), n=n,
                                   batch=pb, prf_method=prf_method)
            if child is None or child in pop or child in scores:
                stale += 1
                continue
            pop.append(child)
    return scores


def _eval_search(*, family_scheme, seed_variant, heur_variant, sample,
                 n, batch, entry_size, prf_method, reps, generations,
                 population, distinct, rng, cache, key, dev, log, hk):
    """The shared body of the two eval families: seed the population,
    run the tournament through the real dispatch path with each variant
    in the searched slot, gate the winner again, store the record."""
    pb = u128.next_pow2(batch)
    dpf, keys, oracle = _workload(n, batch, entry_size, prf_method,
                                  family_scheme, 2, distinct, dev)
    gate = _Gate(dpf, keys, oracle, prf_method=prf_method, radix=2,
                 scheme=family_scheme, batch=batch, reps=reps, log=log)
    counts = {"rejected": 0}

    def measure(v):
        return gate.measure(None, v.tag(), searched=v.eval_knobs())

    pop = []
    for v in (seed_variant, heur_variant):
        if v not in pop:
            pop.append(v)
    i = 0
    while len(pop) < population:
        v = sample(i)
        i += 1
        if v is None or i > 8 * population:
            break
        if v not in pop:
            pop.append(v)
    scores = _tournament(rng, pop, measure, n=n, pb=pb,
                         prf_method=prf_method, generations=generations,
                         population=population, log=log, counts=counts)
    if not scores:
        raise AssertionError("kernel search timed no candidate for n=%d "
                             "batch=%d prf=%s"
                             % (n, batch, PRF_NAMES[prf_method]))
    winner, winner_s = min(scores.items(), key=lambda s: s[1])
    escapes = gate.escapes(None, winner.eval_knobs())
    if escapes:
        raise AssertionError("gate escape: the winner %s no longer matches "
                             "the oracle" % winner.tag())
    seed_s, heur_s = scores.get(seed_variant), scores.get(heur_variant)
    record = {
        "knobs": winner.eval_knobs(),
        "variant_tag": winner.tag(),
        "heuristic": hk,
        "pallas_pinned": [],
        "pallas_gate_prf": None,
        "measured": {
            "best_s": round(winner_s, 6),
            "seed_s": round(seed_s, 6) if seed_s is not None else None,
            "heuristic_s": (round(heur_s, 6)
                            if heur_s is not None else None),
            "speedup_vs_seed": (round(seed_s / winner_s, 4)
                                if seed_s else None),
            "speedup_vs_heuristic": (round(heur_s / winner_s, 4)
                                     if heur_s else None),
            "reps": reps, "generations": generations,
            "population": population, "batch": batch, "entries": n,
            "entry_size": entry_size, "prf": PRF_NAMES[prf_method],
            "scheme": family_scheme, "radix": 2,
            "distinct": min(distinct, batch),
            "candidates_tried": gate.tried,
            "rejected": gate.rejected + counts["rejected"],
            "gate_escapes": escapes,
            "pallas_timed": False,
            "timings": {v.tag(): round(t, 6) for v, t in scores.items()},
            "device": str(dev),
        },
        "fingerprint": device_fingerprint(dev),
        "gated": True,  # every timed candidate matched the scalar oracle
    }
    cache.store(key, record)
    return {**record, "searched": True}


def kernel_search(n: int, batch: int, *, entry_size: int = 16,
                  prf_method: int = PRF_CHACHA20, reps: int = 3,
                  generations: int = 3, population: int = 6,
                  distinct: int = 32, seed: int = 0,
                  cache: TuningCache | None = None, force: bool = False,
                  log=None, device=None) -> dict:
    """Mutate/tournament search over K4's launch knobs (the sqrt-N
    family) for one (N, E, B, prf) shape; returns and stores the
    ``kvariant`` record.  The population holds the staged-descent winner
    (``tune_eval``, a warm cache reused) and the heuristic grid step."""
    cache = cache if cache is not None else default_cache()
    dev = resolve_device(device)
    pb = u128.next_pow2(batch)
    key = cache_key(VARIANT_KIND, n=n, entry_size=entry_size, batch=pb,
                    prf_method=prf_method, scheme="sqrtn", radix=2,
                    device=dev)
    if not force:
        rec = cache.lookup(key)
        if rec is not None:
            return {**rec, "searched": False}
    rng = random.Random(0x5EED ^ seed ^ (n << 1) ^ batch)
    descent = tune_eval(n, batch, entry_size=entry_size,
                        prf_method=prf_method, scheme="sqrtn", radix=2,
                        reps=reps, distinct=distinct, cache=cache,
                        force=force, log=log, device=dev)
    hk = heuristic_knobs(n, pb, prf_method=prf_method, scheme="sqrtn")
    return _eval_search(
        family_scheme="sqrtn",
        seed_variant=KernelVariant(family="xla",
                                   row_chunk=descent["knobs"]["row_chunk"]),
        heur_variant=KernelVariant(family="xla", row_chunk=hk["row_chunk"]),
        sample=lambda i: sample_variant(rng, "xla", n=n, batch=pb,
                                        prf_method=prf_method),
        n=n, batch=batch, entry_size=entry_size, prf_method=prf_method,
        reps=reps, generations=generations, population=population,
        distinct=distinct, rng=rng, cache=cache, key=key, dev=dev, log=log,
        hk=hk)


def kernel_search_ggm(n: int, batch: int, *, entry_size: int = 16,
                      prf_method: int = PRF_CHACHA20, reps: int = 3,
                      generations: int = 3, population: int = 6,
                      distinct: int = 32, seed: int = 0,
                      cache: TuningCache | None = None,
                      force: bool = False, log=None, device=None) -> dict:
    """Mutate/tournament search over the binary tree's launch knobs (the
    GGM family) for one (N, E, B, prf) shape; returns and stores the
    ``kvariant`` record under scheme="logn".  The population holds the
    staged-descent winner, the heuristics and samples of both engines."""
    cache = cache if cache is not None else default_cache()
    dev = resolve_device(device)
    pb = u128.next_pow2(batch)
    key = cache_key(VARIANT_KIND, n=n, entry_size=entry_size, batch=pb,
                    prf_method=prf_method, scheme="logn", radix=2,
                    device=dev)
    if not force:
        rec = cache.lookup(key)
        if rec is not None:
            return {**rec, "searched": False}
    rng = random.Random(0x66D ^ seed ^ (n << 1) ^ batch)
    descent = tune_eval(n, batch, entry_size=entry_size,
                        prf_method=prf_method, scheme="logn", radix=2,
                        reps=reps, distinct=distinct, cache=cache,
                        force=force, log=log, device=dev)
    dk = descent["knobs"]
    hk = heuristic_knobs(n, pb, prf_method=prf_method, scheme="logn")

    def as_variant(knobs):
        eng = _IMPL_GGM_ENGINE.get(knobs.get("kernel_impl"), "fused")
        v = KernelVariant(family="ggm", engine=eng,
                          chunk_leaves=knobs.get("chunk_leaves"),
                          dispatch_group=(knobs.get("dispatch_group")
                                          if eng == "dispatch" else None))
        if _k2(prf_method, v):
            return v
        return dataclasses.replace(v, dot_impl=knobs.get("dot_impl"))

    engines = tuple(_GGM_ENGINE_IMPL)
    return _eval_search(
        family_scheme="logn", seed_variant=as_variant(dk),
        heur_variant=as_variant(hk),
        sample=lambda i: sample_variant(rng, "ggm", n=n, batch=pb,
                                        prf_method=prf_method,
                                        engine=engines[i % len(engines)]),
        n=n, batch=batch, entry_size=entry_size, prf_method=prf_method,
        reps=reps, generations=generations, population=population,
        distinct=distinct, rng=rng, cache=cache, key=key, dev=dev, log=log,
        hk=hk)


def keygen_search(n: int, batch: int, *,
                  prf_method: int = PRF_CHACHA20, scheme: str = "logn",
                  radix: int = 2, reps: int = 3, generations: int = 3,
                  population: int = 6, seed: int = 0,
                  cache: TuningCache | None = None,
                  force: bool = False, log=None, device=None) -> dict:
    """Mutate/tournament search over the batched generators' knobs for
    one (N, B, prf, construction); returns and stores the ``kvariant``
    record under the ``entry_size=0`` sentinel.  The gate: every timed
    candidate's wire rows equal the scalar generator's, key for key,
    both servers.  ``device`` only keys the record (keygen is host
    work)."""
    from ..core import keygen as _kg, radix4 as _r4
    cache = cache if cache is not None else default_cache()
    dev = resolve_device(device)
    pb = u128.next_pow2(batch)
    key = cache_key(VARIANT_KIND, n=n, entry_size=0, batch=pb,
                    prf_method=prf_method, scheme=scheme, radix=radix,
                    device=dev)
    if not force:
        rec = cache.lookup(key)
        if rec is not None:
            return {**rec, "searched": False}
    rng = random.Random(0x4E7 ^ seed ^ (n << 1) ^ batch)
    alphas = np.array([(i * 0x9E3779B1) % n for i in range(batch)],
                      dtype=np.int64)
    seeds = [b"kgs-%04d-" % i + bytes(7) for i in range(batch)]
    if scheme == "sqrtn":
        construction, scalar_gen = "sqrtn.r2", sqrtn.generate_sqrt_keys
        batched = sqrtn.gen_sqrt_batched
    elif radix == 4:
        construction, scalar_gen = "logn.r4", _r4.generate_keys_r4
        batched = _r4.gen_batched_r4
    else:
        construction, scalar_gen = "logn.r2", _kg.generate_keys
        batched = _kg.gen_batched
    scalar = [scalar_gen(int(a), n, sd, prf_method)
              for a, sd in zip(alphas, seeds)]
    oracle = tuple(torch.from_numpy(np.stack([k[i].serialize()
                                              for k in scalar]))
                   for i in (0, 1))
    counts = {"tried": 0, "rejected": 0}

    def gen(kn):
        return batched(alphas, n, seeds, prf_method=prf_method, knobs=kn)

    def measure(v):
        counts["tried"] += 1
        kn = v.keygen_knobs() or None
        try:
            wa, wb = gen(kn)
            if not (torch.equal(wa, oracle[0])
                    and torch.equal(wb, oracle[1])):
                counts["rejected"] += 1
                if log:
                    log("  reject (wire mismatch): %s" % v.tag())
                return None
            best = float("inf")
            for _ in range(reps):
                t0 = time.perf_counter()
                gen(kn)
                best = min(best, time.perf_counter() - t0)
            return best
        except Exception as exc:
            counts["rejected"] += 1
            if log:
                log("  reject (%s): %s" % (type(exc).__name__, v.tag()))
            return None

    baseline = KernelVariant(family="keygen")
    pop = [baseline]
    while len(pop) < population:
        v = sample_variant(rng, "keygen", n=n, batch=pb,
                           prf_method=prf_method)
        if v is None:
            break
        if v not in pop:
            pop.append(v)
    scores = _tournament(rng, pop, measure, n=n, pb=pb,
                         prf_method=prf_method, generations=generations,
                         population=population, log=log, counts=counts)
    if baseline not in scores:
        raise AssertionError("keygen search could not time the baseline "
                             "for n=%d batch=%d %s" % (n, batch,
                                                       construction))
    winner, winner_s = min(scores.items(), key=lambda s: s[1])
    base_s = scores[baseline]
    record = {
        "knobs": {"keygen_knobs": winner.keygen_knobs(),
                  "kernel_variant": winner.to_dict()},
        "variant_tag": winner.tag(),
        "heuristic": {},
        "pallas_pinned": [],
        "pallas_gate_prf": None,
        "measured": {
            "best_s": round(winner_s, 6),
            "seed_s": round(base_s, 6),
            "heuristic_s": None,
            "speedup_vs_seed": round(base_s / winner_s, 4),
            "speedup_vs_heuristic": None,
            "keys_per_s": int(batch / winner_s),
            "baseline_keys_per_s": int(batch / base_s),
            "construction": construction,
            "reps": reps, "generations": generations,
            "population": population, "batch": batch, "entries": n,
            "entry_size": 0, "prf": PRF_NAMES[prf_method],
            "scheme": scheme, "radix": radix,
            "candidates_tried": counts["tried"],
            "rejected": counts["rejected"],
            "gate_escapes": 0,
            "pallas_timed": False,
            "timings": {v.tag(): round(t, 6) for v, t in scores.items()},
        },
        "fingerprint": device_fingerprint(dev),
        "gated": True,  # every timed candidate matched the wire oracle
    }
    cache.store(key, record)
    return {**record, "searched": True}


# --------------------------------------------------------------- sweep

_SWEEP_FAMILIES = ("sqrtn", "logn", "keygen")


def _sweep_families(family: str) -> tuple:
    """Parse ``--family``: sqrtn|logn|keygen|all or a comma list; order
    kept, duplicates dropped."""
    fams = (_SWEEP_FAMILIES if family == "all"
            else tuple(f.strip() for f in family.split(",") if f.strip()))
    out = []
    for f in fams:
        if f not in _SWEEP_FAMILIES:
            raise ValueError("unknown kernel-search family %r (want %s or "
                             "'all')" % (f, "|".join(_SWEEP_FAMILIES)))
        if f not in out:
            out.append(f)
    return tuple(out)


def kernel_search_sweep(shapes=None, *, prf_method: int = PRF_CHACHA20,
                        entry_size: int = 16, reps: int = 3,
                        generations: int = 3, population: int = 6,
                        family: str = "sqrtn", force: bool = False,
                        dryrun: bool = False,
                        cache: TuningCache | None = None,
                        out: str | None = None, quiet: bool = False,
                        device=None) -> dict:
    """Run the per-family searches per (N, B) point and emit one JSON
    record (``benchmark.py --autotune-kernel``'s).  ``dryrun`` shrinks
    the shapes and the budget to a seconds-long smoke with the same
    record shape and invariants (0 rejections, 0 gate escapes, a stored
    winner per family)."""
    from .search import DEFAULT_SWEEP
    compcache.enable()
    cache = cache if cache is not None else default_cache()
    dev = resolve_device(device)
    log = None if quiet else (lambda m: print(m, flush=True))
    families = _sweep_families(family)
    if shapes is None:
        shapes = ((256, 32),) if dryrun else DEFAULT_SWEEP
    if dryrun:
        reps, generations, population = 1, 2, 4
    points = []
    for fam in families:
        for n, batch in shapes:
            if log:
                log("kernel search [%s] n=%d batch=%d prf=%s on %s ..."
                    % (fam, n, batch, PRF_NAMES[prf_method], dev))
            kw = dict(prf_method=prf_method, reps=reps,
                      generations=generations, population=population,
                      cache=cache, force=force, log=log, device=dev)
            if fam == "keygen":
                rec = keygen_search(n, batch, **kw)
            else:
                search = kernel_search if fam == "sqrtn" else \
                    kernel_search_ggm
                rec = search(n, batch, entry_size=entry_size,
                             distinct=8 if dryrun else 32, **kw)
            m = rec["measured"]
            pt = {
                "family": fam, "entries": n, "batch": batch,
                "winner": rec["variant_tag"],
                "winner_knobs": rec["knobs"],
                "winner_s": m["best_s"], "seed_s": m["seed_s"],
                "heuristic_s": m["heuristic_s"],
                "speedup_vs_seed": m["speedup_vs_seed"],
                "speedup_vs_heuristic": m["speedup_vs_heuristic"],
                "winner_qps": int(batch / m["best_s"]),
                "candidates_tried": m["candidates_tried"],
                "rejected": m["rejected"],
                "gate_escapes": m["gate_escapes"],
                "pallas_timed": False, "pallas_pinned": [],
                "pallas_all_parity": True,
                "from_cache": not rec["searched"],
            }
            if fam == "keygen":
                pt["winner_keys_per_s"] = m["keys_per_s"]
                pt["baseline_keys_per_s"] = m["baseline_keys_per_s"]
                pt["construction"] = m["construction"]
            points.append(pt)
    record = {
        "metric": "generative kernel-variant search over the CUDA "
                  "kernels' launch knobs (seeded mutate/tournament, "
                  "equality-gated, best-of-%d reps)" % reps,
        "fingerprint": device_fingerprint(dev),
        "device": str(dev),
        "prf": PRF_NAMES[prf_method],
        "families": list(families),
        "dryrun": dryrun,
        "points": points,
        "tuning_cache": cache.path,
        "build_cache": compcache.enabled_dir(),
        "cache_counters": CACHE_COUNTERS.as_dict(),
        "checked": all(p["gate_escapes"] == 0 for p in points),
    }
    if "keygen" in families:
        record["keygen_throughput"] = [
            {"construction": p["construction"], "entries": p["entries"],
             "batch": p["batch"],
             "baseline_keys_per_s": p["baseline_keys_per_s"],
             "winner_keys_per_s": p["winner_keys_per_s"],
             "speedup": p["speedup_vs_seed"]}
            for p in points if p["family"] == "keygen"]
    if not quiet:
        print(json.dumps(record), flush=True)
    if out:
        with open(out, "w") as f:
            json.dump(record, f, indent=1)
            f.write("\n")
    return record


def main(argv=None):
    import argparse
    from .search import parse_shapes
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--family", default="sqrtn",
                    help="sqrtn|logn|keygen|all or a comma list")
    ap.add_argument("--shapes", default=None,
                    help="N:B points (default: tune.search.DEFAULT_SWEEP, "
                         "256:32 with --dryrun)")
    ap.add_argument("--prf", type=int, default=PRF_CHACHA20)
    ap.add_argument("--entry-size", type=int, default=16)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--generations", type=int, default=3)
    ap.add_argument("--population", type=int, default=6)
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--dryrun", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cpu to run the plain versions (default: the card)")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    return kernel_search_sweep(
        parse_shapes(args.shapes) if args.shapes else None,
        prf_method=args.prf, entry_size=args.entry_size, reps=args.reps,
        generations=args.generations, population=args.population,
        family=args.family, force=args.force, dryrun=args.dryrun,
        out=args.out, device=args.device or "cuda")


if __name__ == "__main__":
    main()
