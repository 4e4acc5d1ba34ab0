"""The port's kernel-variant search (``dpf_tpu_torch.tune.kernel_search``)
against dpf_tpu's record grammar, on the CPU.

Variants round-trip through dicts and read ``dpf_tpu``'s records; the
Pallas-only fields are refused before any build; every variant the
samplers offer gives the oracle's shares (eval families) or the scalar
generator's wire bytes, equal to ``dpf_tpu``'s (keygen family); a small
search stores a winner the resolver takes as ``searched``.  Each test
runs on a tuning cache of its own under ``tmp_path``.
"""

import importlib
import random

import numpy as np
import pytest
import torch

from dpf_tpu.core import keygen as jkeygen
from dpf_tpu.core import radix4 as jradix4
from dpf_tpu.core import sqrtn as jsqrtn
from dpf_tpu_torch.core import keygen, radix4, sqrtn
from dpf_tpu_torch.tune import cache as tcache
from dpf_tpu_torch.tune import search

# the packages export a function of the module's name, so the modules are
# imported by their full names
jks = importlib.import_module("dpf_tpu.tune.kernel_search")
ks = importlib.import_module("dpf_tpu_torch.tune.kernel_search")

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def fresh_cache(tmp_path, monkeypatch):
    monkeypatch.setenv(tcache.ENV, str(tmp_path / "tuning.json"))
    monkeypatch.setenv("DPF_TPU_TUNE_CACHE", str(tmp_path / "jax.json"))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield tcache.default_cache(refresh=True)
    torch.set_num_threads(threads)


def test_variant_dict_round_trip_and_dpf_tpu_records():
    for v in (ks.KernelVariant(family="xla", row_chunk=16),
              ks.KernelVariant(family="ggm", engine="dispatch",
                               chunk_leaves=256, dispatch_group=2,
                               dot_impl="mxu"),
              ks.KernelVariant(family="keygen", prf_group="stacked",
                               squeeze_draws=4)):
        assert ks.KernelVariant.from_dict(v.to_dict()) == v
        assert None not in v.to_dict().values()
    theirs = jks.KernelVariant(family="ggm", engine="fused",
                               chunk_leaves=1024, f_levels=9,
                               dot_impl="i32").to_dict()
    ours = ks.KernelVariant.from_dict({**theirs, "unknown_field": 1})
    assert ours.to_dict() == theirs
    assert ours.tag() == jks.KernelVariant.from_dict(theirs).tag()
    pallas = jks.pr10_default_variant().to_dict()
    assert ks.KernelVariant.from_dict(pallas).to_dict() == pallas
    kg = jks.KernelVariant(family="keygen", path_reuse="reuse")
    assert ks.KernelVariant.from_dict(kg.to_dict()).keygen_knobs() == \
        kg.keygen_knobs()


@pytest.mark.parametrize("field,value", [
    ("tb", 8), ("max_cells", 2048), ("grid_order", "kb"),
    ("dim_semantics", "arbitrary"), ("limbs", "multi"),
    ("cw_add", "staged")])
def test_pallas_fields_are_refused_before_any_build(field, value):
    for fam in ("xla", "ggm"):
        v = ks.KernelVariant(family=fam, **{field: value})
        assert "Pallas" in ks.variant_invalid(v, n=1024, batch=16,
                                              prf_method=2)
    assert ks.variant_invalid(ks.KernelVariant(family="pallas"), n=1024,
                              batch=16, prf_method=2)
    assert ks.variant_invalid(ks.KernelVariant(family="ggm",
                                               engine="pallas"),
                              n=1024, batch=16, prf_method=2)


def test_variant_rules():
    inv = ks.variant_invalid
    assert inv(ks.KernelVariant(family="xla", row_chunk=3), n=1024,
               batch=8, prf_method=3)
    assert inv(ks.KernelVariant(family="ggm", chunk_leaves=8192), n=1 << 14,
               batch=8, prf_method=2)            # over K2's 4096
    assert inv(ks.KernelVariant(family="ggm", chunk_leaves=8192), n=1 << 14,
               batch=8, prf_method=3) is None    # a live-seed chunk
    assert inv(ks.KernelVariant(family="ggm", dot_impl="mxu"), n=1024,
               batch=8, prf_method=2)            # K2 contracts inside
    assert inv(ks.KernelVariant(family="ggm", engine="dispatch",
                                f_levels=3), n=1024, batch=8, prf_method=3)
    assert inv(ks.KernelVariant(family="ggm", dispatch_group=2), n=1024,
               batch=8, prf_method=3)
    assert inv(ks.KernelVariant(family="keygen", squeeze_draws=0), n=1024,
               batch=8, prf_method=3)


@pytest.mark.parametrize("prf", range(6))
def test_sampled_variants_give_the_oracle_shares(prf):
    """Every GGM and sqrt-N variant the sampler and mutator offer at
    N = 1024 runs through the resolver's searched slot and gives
    ``eval_cpu``'s shares."""
    n, batch = 1024, 4
    rng = random.Random(prf)
    for scheme, family in (("logn", "ggm"), ("sqrtn", "xla")):
        dpf, keys, oracle = search._workload(n, batch, 3, prf, scheme, 2,
                                             batch, CPU)
        gate = search._Gate(dpf, keys, oracle, prf_method=prf, radix=2,
                            scheme=scheme, batch=batch, reps=1, log=None)
        seen = []
        for i in range(6):
            eng = ("fused", "dispatch")[i % 2] if family == "ggm" else None
            v = ks.sample_variant(rng, family, n=n, batch=batch,
                                  prf_method=prf, engine=eng)
            assert v is not None
            child = ks.mutate_variant(rng, v, n=n, batch=batch,
                                      prf_method=prf)
            for w in (v, child):
                if w is None or w in seen:
                    continue
                assert ks.variant_invalid(w, n=n, batch=batch,
                                          prf_method=prf) is None
                seen.append(w)
                assert gate.measure(None, w.tag(),
                                    searched=w.eval_knobs()) is not None, w
        assert gate.rejected == 0 and len(seen) >= 2


@pytest.mark.parametrize("construction", ["logn.r2", "logn.r4", "sqrtn.r2"])
def test_keygen_variants_give_dpf_tpus_wire_bytes(construction):
    n, batch, prf = 1024, 6, 5
    alphas = np.array([(i * 0x9E3779B1) % n for i in range(batch)])
    seeds = [b"kgv-%d" % i + bytes(8) for i in range(batch)]
    ours, theirs = {"logn.r2": (keygen.gen_batched, jkeygen.gen_batched),
                    "logn.r4": (radix4.gen_batched_r4,
                                jradix4.gen_batched_r4),
                    "sqrtn.r2": (sqrtn.gen_sqrt_batched,
                                 jsqrtn.gen_sqrt_batched)}[construction]
    want = [np.asarray(w) for w in theirs(alphas, n, seeds, prf_method=prf)]
    rng = random.Random(3)
    variants = {ks.KernelVariant(family="keygen")}
    for _ in range(12):
        variants.add(ks.sample_variant(rng, "keygen", n=n, batch=batch,
                                       prf_method=prf))
    assert len(variants) >= 4
    for v in variants:
        got = ours(alphas, n, seeds, prf_method=prf,
                   knobs=v.keygen_knobs() or None)
        for g, w in zip(got, want):
            assert np.array_equal(g.numpy(), w), v.tag()
        jgot = theirs(alphas, n, seeds, prf_method=prf,
                      knobs=v.keygen_knobs() or None)
        for g, w in zip(jgot, want):
            assert np.array_equal(np.asarray(g), w), v.tag()


def test_ggm_search_stores_a_searched_winner(fresh_cache):
    from dpf_tpu_torch import DPF
    from dpf_tpu_torch.utils.config import EvalConfig
    kw = dict(prf_method=2, reps=1, generations=2, population=4,
              distinct=2, device="cpu")
    rec = ks.kernel_search_ggm(512, 8, entry_size=3, **kw)
    m = rec["measured"]
    assert rec["searched"] and rec["gated"] and rec["pallas_pinned"] == []
    assert m["rejected"] == 0 and m["gate_escapes"] == 0
    assert m["best_s"] <= min(t for t in (m["seed_s"], m["heuristic_s"])
                              if t is not None)
    assert ks.kernel_search_ggm(512, 8, entry_size=3,
                                **kw)["searched"] is False
    d = DPF(config=EvalConfig(prf_method=2, kernel_impl=None,
                              dot_impl=None), device="cpu")
    d.eval_init(np.arange(512 * 3, dtype=np.int32).reshape(512, 3))
    kn = d.resolved_eval_knobs(8)
    assert kn["kernel_resolved_from"] == "searched"
    assert kn["kernel_variant"] == rec["knobs"]["kernel_variant"]
    keys = d.gen_batch(list(range(8)), 512)[0]
    assert torch.equal(d.eval_gpu(keys), d.eval_cpu(keys))


def test_sqrtn_and_keygen_searches(fresh_cache):
    from dpf_tpu_torch import DPF
    rec = ks.kernel_search(1024, 8, entry_size=3, prf_method=4, reps=1,
                           generations=2, population=3, distinct=2,
                           device="cpu")
    assert rec["measured"]["rejected"] == 0
    assert rec["knobs"]["kernel_variant"]["family"] == "xla"
    kg = ks.keygen_search(256, 8, prf_method=3, reps=1, generations=2,
                          population=3, device="cpu")
    assert kg["measured"]["rejected"] == 0 and kg["gated"]
    d = DPF(prf=3, device="cpu")
    assert d._resolved_keygen_knobs(256, 8) == \
        kg["knobs"]["keygen_knobs"]
    assert d._resolved_keygen_knobs(256, 600) is not None   # nearest batch
    rec = ks.kernel_search_sweep(family="keygen", dryrun=True, quiet=True,
                                 device="cpu")
    assert rec["checked"] and rec["keygen_throughput"]
    with pytest.raises(ValueError, match="unknown kernel-search family"):
        ks._sweep_families("pallas")
