"""The port's workload models (``dpf_tpu_torch.models``) against
``dpf_tpu``'s, on the CPU.

Datasets and loaders are numpy copies and must give equal arrays.  The
models take ``dpf_tpu``'s flax params through ``interop`` and must give
its logits (atol 1e-5 rec, 1e-4 LM: float32 sums in another order), its
gradients (rtol 1e-4, atol 1e-6) and its parameters after one Adam step
(atol 1e-4), and the accuracy-vs-PIR-budget evaluation with one plan
must agree (AUC within 2e-3, perplexity rtol 1e-4).  The port's own
training reaches ``tests/test_apps.py``'s properties.  No full JAX
training loop runs here: one step, or carried weights.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dpf_tpu.apps.batch_pir import (BatchPIROptimize as JBatchPIROptimize,
                                    CollocateConfig as JCollocateConfig,
                                    HotColdConfig as JHotColdConfig,
                                    PIRConfig as JPIRConfig)
from dpf_tpu.models import datasets as jdatasets
from dpf_tpu.models import lm as jlm
from dpf_tpu.models import loaders as jloaders
from dpf_tpu.models import rec as jrec
from dpf_tpu_torch import interop
from dpf_tpu_torch.apps import sweep
from dpf_tpu_torch.apps.batch_pir import (BatchPIROptimize, CollocateConfig,
                                          HotColdConfig, PIRConfig)
from dpf_tpu_torch.models import checkpoint, datasets, lm, loaders, rec

FIX = os.path.join(os.path.dirname(__file__), "fixtures")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _same_dataset(a, b):
    assert type(a).__name__ == type(b).__name__
    for k, v in vars(a).items():
        w = getattr(b, k)
        if isinstance(v, np.ndarray):
            assert v.dtype == w.dtype and v.shape == w.shape, k
            assert v.tobytes() == w.tobytes(), k
        else:
            assert v == w, k


# ---------------------------------------------------------------- datasets

@pytest.mark.parametrize("make,kw", [
    ("make_rec_dataset", {}),
    ("make_rec_dataset", dict(n_items=300, n_users=80, samples_per_user=4,
                              seed=1)),
    ("make_rec_dataset", dict(n_items=40, n_users=10, n_clusters=50,
                              seed=5)),
    ("make_ratings_dataset", {}),
    ("make_lm_dataset", {}),
    ("make_lm_dataset", dict(vocab_size=150, seq_len=12, n_train=60,
                             n_val=8, seed=2)),
])
def test_datasets_equal_dpf_tpu(make, kw):
    _same_dataset(getattr(datasets, make)(**kw),
                  getattr(jdatasets, make)(**kw))


def test_access_patterns_equal_dpf_tpu():
    a = datasets.make_rec_dataset(n_items=100, n_users=30)
    b = jdatasets.make_rec_dataset(n_items=100, n_users=30)
    for split in ("train", "val"):
        assert a.access_patterns(split) == b.access_patterns(split)
    a = datasets.make_lm_dataset(vocab_size=50, n_train=10, n_val=4)
    b = jdatasets.make_lm_dataset(vocab_size=50, n_train=10, n_val=4)
    assert a.access_patterns("val") == b.access_patterns("val")


@pytest.mark.parametrize("loader,sub,kw", [
    ("load_taobao", "taobao", {}),
    ("load_taobao", "taobao", dict(max_hist=3, split=0.5, limit=20)),
    ("load_movielens", "ml-20m", {}),
    ("load_wikitext", "wikitext-2", dict(seq_len=8)),
    ("load_wikitext", "wikitext-2", dict(seq_len=8, vocab_limit=5)),
])
def test_loaders_equal_dpf_tpu(loader, sub, kw):
    d = os.path.join(FIX, sub)
    _same_dataset(getattr(loaders, loader)(d, **kw),
                  getattr(jloaders, loader)(d, **kw))


def test_loaders_fall_back_to_synthetic(monkeypatch, tmp_path):
    monkeypatch.setattr(loaders, "DATA_ROOT", str(tmp_path))
    _same_dataset(loaders.load_taobao_or_synthetic(),
                  jdatasets.make_rec_dataset())
    _same_dataset(loaders.load_movielens_or_synthetic(),
                  jdatasets.make_ratings_dataset())
    _same_dataset(loaders.load_wikitext_or_synthetic(),
                  jdatasets.make_lm_dataset())


# ------------------------------------------------- carried flax weights

def _rec_setup(seed=3):
    ds = jdatasets.make_rec_dataset(n_items=300, n_users=80,
                                    samples_per_user=4, seed=1)
    jm = jrec.RecModel(n_items=ds.n_items)
    params = jm.init(jax.random.PRNGKey(seed),
                     jnp.zeros((1, ds.max_hist), jnp.int32),
                     jnp.ones((1,), jnp.int32), jnp.zeros((1,), jnp.int32))
    tm = rec.RecModel(ds.n_items)
    tm.load_state_dict(interop.rec_state_from_numpy(_np(params)))
    return ds, jm, params, tm


def _lm_setup(seed=4):
    ds = jdatasets.make_lm_dataset(vocab_size=150, seq_len=12, n_train=60,
                                   n_val=8, seed=2)
    jm = jlm.LSTMLanguageModel(vocab_size=ds.vocab_size)
    params = jm.init(jax.random.PRNGKey(seed),
                     jnp.zeros((1, ds.seq_len), jnp.int32))
    tm = lm.LSTMLanguageModel(ds.vocab_size)
    tm.load_state_dict(interop.lm_state_from_numpy(_np(params)))
    return ds, jm, params, tm


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _rec_batch(ds):
    b = ds.train_idx[:64]
    return (ds.hist[b], ds.hist_len[b], ds.target[b], ds.label[b])


def _t(a):
    return torch.from_numpy(np.asarray(a)).long()


def test_interop_state_dicts_fill_the_modules():
    _, _, params, tm = _rec_setup()
    assert set(interop.rec_state_from_numpy(_np(params))) == \
        set(tm.state_dict())
    _, _, params, tm = _lm_setup()
    state = interop.lm_state_from_numpy(_np(params))
    assert set(state) == set(tm.state_dict())
    assert not state["lstm.bias_ih_l0"].any()


def test_rec_logits_and_gradients_equal_dpf_tpu():
    ds, jm, params, tm = _rec_setup()
    hist, hist_len, target, label = _rec_batch(ds)
    want = np.asarray(jm.apply(params, hist, hist_len, target))
    got = tm(_t(hist), _t(hist_len), _t(target))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-5)

    def loss_fn(p):
        return optax.sigmoid_binary_cross_entropy(
            jm.apply(p, hist, hist_len, target), label).mean()
    jgrads = interop.rec_state_from_numpy(_np(jax.grad(loss_fn)(params)))
    rec.rec_loss(tm, _t(hist), _t(hist_len), _t(target),
                 torch.from_numpy(label)).backward()
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), jgrads[name].numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=name)


def test_rec_adam_step_equals_dpf_tpu():
    ds, jm, params, tm = _rec_setup()
    hist, hist_len, target, label = _rec_batch(ds)
    tx = optax.adam(1e-2)

    def loss_fn(p):
        return optax.sigmoid_binary_cross_entropy(
            jm.apply(p, hist, hist_len, target), label).mean()
    grads = jax.grad(loss_fn)(params)
    updates, _ = tx.update(grads, tx.init(params))
    want = interop.rec_state_from_numpy(
        _np(optax.apply_updates(params, updates)))
    opt = torch.optim.Adam(tm.parameters(), lr=1e-2)
    rec.rec_loss(tm, _t(hist), _t(hist_len), _t(target),
                 torch.from_numpy(label)).backward()
    opt.step()
    for name, v in tm.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[name].numpy(), rtol=0,
                                   atol=1e-4, err_msg=name)


def test_lm_logits_and_gradients_equal_dpf_tpu():
    ds, jm, params, tm = _lm_setup()
    toks = ds.train_tokens[:8]
    want = np.asarray(jm.apply(params, toks[:, :-1]))
    got = tm(_t(toks[:, :-1]))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-4)

    def loss_fn(p):
        return optax.softmax_cross_entropy_with_integer_labels(
            jm.apply(p, toks[:, :-1]), toks[:, 1:]).mean()
    jgrads = interop.lm_state_from_numpy(_np(jax.grad(loss_fn)(params)))
    lm.lm_loss(tm, _t(toks)).backward()
    for name, p in tm.named_parameters():
        if not p.requires_grad:      # the input bias: zero, as in flax
            assert p.grad is None and not p.any()
            continue
        np.testing.assert_allclose(p.grad.numpy(), jgrads[name].numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=name)


def test_lm_adam_step_equals_dpf_tpu():
    ds, jm, params, tm = _lm_setup()
    toks = ds.train_tokens[:32]
    tx = optax.adam(1e-2)

    def loss_fn(p):
        return optax.softmax_cross_entropy_with_integer_labels(
            jm.apply(p, toks[:, :-1]), toks[:, 1:]).mean()
    grads = jax.grad(loss_fn)(params)
    updates, _ = tx.update(grads, tx.init(params))
    want = interop.lm_state_from_numpy(
        _np(optax.apply_updates(params, updates)))
    opt = torch.optim.Adam([p for p in tm.parameters() if p.requires_grad],
                           lr=1e-2)
    lm.lm_loss(tm, _t(toks)).backward()
    opt.step()
    for name, v in tm.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[name].numpy(), rtol=0,
                                   atol=1e-4, err_msg=name)


class _CopyingJnp:
    """``jax.numpy`` whose ``asarray`` copies.  ``dpf_tpu``'s evaluations
    zero rows of a numpy working copy, hand it over with
    ``jnp.asarray`` and restore the rows right after the call; on the
    CPU ``asarray`` may alias the numpy buffer and the jitted call runs
    asynchronously, so the restore can land before the call reads the
    table and the reference sees rows unmasked (its AUC then differs from
    run to run).  A copy makes the reference read what it meant to."""

    def __getattr__(self, name):
        return getattr(jnp, name)

    @staticmethod
    def asarray(x, *args, **kwargs):
        return jnp.array(x, copy=True)


@pytest.fixture
def jax_copies_its_table(monkeypatch):
    monkeypatch.setattr(jrec, "jnp", _CopyingJnp())
    monkeypatch.setattr(jlm, "jnp", _CopyingJnp())


def _plans(ds, queries, bin_fraction):
    """The same plan in both packages."""
    tp, vp = ds.access_patterns("train"), ds.access_patterns("val")
    return (BatchPIROptimize(tp, vp, HotColdConfig(1.0), CollocateConfig(0),
                             PIRConfig(bin_fraction=bin_fraction,
                                       queries_to_hot=queries)),
            JBatchPIROptimize(tp, vp, JHotColdConfig(1.0),
                              JCollocateConfig(0),
                              JPIRConfig(bin_fraction=bin_fraction,
                                         queries_to_hot=queries)))


@pytest.mark.parametrize("queries", [None, 0, 1])
def test_rec_evaluate_with_pir_equals_dpf_tpu(queries, jax_copies_its_table):
    ds, jm, params, tm = _rec_setup()
    ours, theirs = (None, None) if queries is None else \
        _plans(ds, queries, 0.02)
    got = rec.evaluate_with_pir(tm, ds, ours)
    want = jrec.evaluate_with_pir(jm, params, ds, theirs)
    assert got["n_eval"] == want["n_eval"]
    assert abs(got["roc_auc"] - want["roc_auc"]) <= 2e-3


@pytest.mark.parametrize("queries", [None, 0, 1])
def test_lm_evaluate_with_pir_equals_dpf_tpu(queries, jax_copies_its_table):
    ds, jm, params, tm = _lm_setup()
    ours, theirs = (None, None) if queries is None else \
        _plans(ds, queries, 0.5)
    got = lm.evaluate_with_pir(tm, ds, ours)
    want = jlm.evaluate_with_pir(jm, params, ds, theirs)
    assert got["n_eval"] == want["n_eval"]
    np.testing.assert_allclose(got["perplexity"], want["perplexity"],
                               rtol=1e-4)
    np.testing.assert_allclose(got["val_loss"], want["val_loss"], rtol=1e-4)


def test_evaluate_restores_the_table():
    ds, _, _, tm = _rec_setup()
    before = tm.item_embedding.weight.detach().clone()
    rec.evaluate_with_pir(tm, ds, _plans(ds, 0, 0.02)[0])
    assert torch.equal(tm.item_embedding.weight, before)


def test_roc_auc_equals_dpf_tpu():
    rng = np.random.default_rng(0)
    labels = (rng.random(200) < 0.4).astype(np.float64)
    scores = np.round(rng.normal(size=200), 1)     # with ties
    assert rec.roc_auc(labels, scores) == jrec.roc_auc(labels, scores)


# ------------------------------------------------- the port's own training

@pytest.fixture(scope="module")
def trained_rec():
    ds = datasets.make_rec_dataset(n_items=300, n_users=80,
                                   samples_per_user=4, seed=1)
    return ds, rec.train_rec_model(ds, epochs=3, seed=1, device="cpu")


def test_rec_model_learns(trained_rec):
    ds, model = trained_rec
    assert rec.evaluate_with_pir(model, ds, None)["roc_auc"] > 0.55


def test_rec_accuracy_degrades_without_pir_recovery(trained_rec):
    ds, model = trained_rec

    def auc(queries):
        return rec.evaluate_with_pir(model, ds,
                                     _plans(ds, queries, 0.02)[0])["roc_auc"]
    full = rec.evaluate_with_pir(model, ds, None)["roc_auc"]
    rich, poor = auc(8), auc(0)
    assert rich > poor
    assert abs(full - rich) < 0.15


def test_lm_with_pir_masking():
    ds = datasets.make_lm_dataset(vocab_size=150, seq_len=12, n_train=60,
                                  n_val=8, seed=2)
    model = lm.train_lm(ds, epochs=1, seed=2, device="cpu")
    full = lm.evaluate_with_pir(model, ds, None)
    masked = lm.evaluate_with_pir(model, ds, _plans(ds, 1, 0.5)[0])
    assert masked["perplexity"] >= full["perplexity"] * 0.9


def test_training_is_seeded():
    ds = datasets.make_lm_dataset(vocab_size=60, seq_len=6, n_train=40,
                                  n_val=4, seed=3)
    a = lm.train_lm(ds, epochs=1, seed=7, device="cpu").state_dict()
    b = lm.train_lm(ds, epochs=1, seed=7, device="cpu").state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_init_follows_flax_families():
    """Embedding rows of variance 1 / D, Dense kernels truncated at two
    standard deviations of sqrt(1 / fan_in) / 0.88, orthogonal recurrent
    gate blocks, zero biases."""
    g = torch.Generator().manual_seed(0)
    m = lm.LSTMLanguageModel(2000, 32, 64, generator=g)
    emb = m.token_embedding.weight.detach()
    assert abs(emb.std().item() - (1 / 32) ** 0.5) < 0.01
    w = m.dense.weight.detach()
    std = (1 / 64) ** 0.5 / .87962566103423978
    assert w.abs().max().item() <= 2 * std
    assert abs(w.std().item() - (1 / 64) ** 0.5) < 0.01
    for gate in range(4):
        q = m.lstm.weight_hh_l0[64 * gate:64 * (gate + 1)].detach()
        assert torch.allclose(q @ q.T, torch.eye(64), atol=1e-5)
    assert not m.lstm.bias_ih_l0.any() and not m.lstm.bias_hh_l0.any()
    assert not m.dense.bias.any()


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ds = datasets.make_lm_dataset(vocab_size=20, n_train=4, n_val=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        lm.train_lm(ds)
    rds = datasets.make_rec_dataset(n_items=40, n_users=10)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        rec.train_rec_model(rds)


# ------------------------------------------------------------ checkpoints

def test_checkpoint_round_trip(tmp_path):
    _, _, _, tm = _rec_setup()
    path = checkpoint.save_params(str(tmp_path / "ck" / "rec.pt"), tm)
    fresh = rec.RecModel(tm.item_embedding.num_embeddings)
    fresh.load_state_dict(checkpoint.load_params(path, like=fresh))
    assert all(torch.equal(a, b) for a, b in
               zip(fresh.state_dict().values(), tm.state_dict().values()))
    with pytest.raises(ValueError):
        checkpoint.load_params(path, like=rec.RecModel(7))


def test_train_or_restore_does_not_retrain(tmp_path):
    ds = datasets.make_lm_dataset(vocab_size=40, seq_len=6, n_train=33,
                                  n_val=4)
    path = str(tmp_path / "lm.pt")
    calls = []

    def train():
        calls.append(1)
        return lm.train_lm(ds, epochs=1, device="cpu")

    def init():
        return lm.init_lm(ds, seed=99, device="cpu")
    first = checkpoint.train_or_restore(path, init, train)
    again = checkpoint.train_or_restore(path, init, train)
    assert calls == [1]
    assert all(torch.equal(first.state_dict()[k], again.state_dict()[k])
               for k in first.state_dict())


# ------------------------------------------------------------------ sweep

def test_sweep_fills_accuracy_stats():
    ds = datasets.make_rec_dataset(n_items=120, n_users=30,
                                   samples_per_user=3, seed=2)
    model = rec.init_rec_model(ds, device="cpu")
    grid = {"cache_size_fraction": [1.0], "num_collocate": [0],
            "bin_fraction": [0.1], "queries_to_hot": [0, 4],
            "queries_to_cold": [0]}
    res = sweep.run_sweep(
        ds.access_patterns("train"), ds.access_patterns("val"), grid=grid,
        model_eval=lambda opt: rec.evaluate_with_pir(model, ds, opt))
    assert len(res) == 2
    for r in res:
        assert r["accuracy_stats"]["n_eval"] == len(ds.val_idx)
        assert 0.0 <= r["accuracy_stats"]["roc_auc"] <= 1.0
