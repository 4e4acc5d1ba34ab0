"""Real-dataset loaders with synthetic fallback.

Port of ``dpf_tpu/models/loaders.py`` (numpy and the standard library):
a copy, so this package imports no JAX; the same files parse to equal
arrays in both packages.

The reference's workload modules parse the actual Taobao CTR, MovieLens,
and WikiText-2 downloads (``taobao_rec_dataset_v2.py:87-197``,
``movielens_dataset.py:59-113``, ``language_model/data.py`` +
``language_model_dataset.py``).  Nothing is downloaded, so the
default experiments run on the statistical stand-ins in ``datasets.py`` —
but the *code path* for real data must exist: these loaders parse the
same file formats into the SAME dataclasses (``RecDataset``/``LMDataset``)
the synthetic generators produce, so every downstream consumer (rec/lm
models, batch-PIR optimizer, sweeps, codesign) works unchanged the moment
the files are dropped in.

File formats (matching the reference's expectations):

* Taobao (``dir/raw_sample.csv`` + ``dir/ad_feature.csv``):
  ``user,time_stamp,adgroup_id,pid,nonclk,clk`` rows; ad ids are
  remapped densely in first-seen order; each interaction's history is
  the user's *clicked* ads before its timestamp.
* MovieLens (``dir/ratings.csv``): ``userId,movieId,rating,timestamp``
  with a header; click := rating >= 4; same history construction.
* WikiText-2 (``dir/train.txt``, ``dir/valid.txt``): whitespace tokens,
  ``<eos>`` appended per line; vocabulary built from the train split
  (optionally capped to the most frequent ``vocab_limit`` words, rest
  mapped to ``<unk>``).

``load_*_or_synthetic`` helpers check the conventional location and fall
back to ``datasets.make_*`` so experiments are runnable either way.
"""

from __future__ import annotations

import bisect
import os
from collections import Counter, defaultdict

import numpy as np

from .datasets import (LMDataset, RecDataset, make_lm_dataset,
                       make_ratings_dataset, make_rec_dataset)


def _interactions_to_rec(rows, n_items, max_hist, split):
    """Shared assembly: (user, item, ts, click) rows -> RecDataset.

    History = the user's clicked items strictly before each row's
    timestamp (most recent ``max_hist``), the reference's
    ``obtain_click_history`` semantics; train/val split by user (first
    ``split`` fraction of users train, rest val), matching the
    reference's user-major split rather than a row shuffle.
    """
    by_user = defaultdict(list)
    for u, i, ts, c in rows:
        by_user[u].append((i, ts, c))

    hist_l, target_l, label_l, user_of = [], [], [], []
    for u, events in by_user.items():
        events.sort(key=lambda e: e[1])
        clicked_items, clicked_ts = [], []    # ts ascending
        for item, ts, click in events:
            # clicked_ts is sorted: the strictly-earlier prefix ends at
            # bisect_left(ts) — O(log E) per event, not a full rescan
            cut = bisect.bisect_left(clicked_ts, ts)
            h = clicked_items[max(0, cut - max_hist):cut]
            hist_l.append(h)
            target_l.append(item)
            label_l.append(float(click))
            user_of.append(u)
            if click:
                clicked_items.append(item)
                clicked_ts.append(ts)

    n = len(hist_l)
    hist = np.zeros((n, max_hist), np.int32)
    hist_len = np.zeros(n, np.int32)
    target = np.array(target_l, np.int32)
    label = np.array(label_l, np.float32)
    for i, h in enumerate(hist_l):
        hist[i, :len(h)] = h
        hist_len[i] = len(h)

    users = list(by_user)
    cut = set(users[:int(split * len(users))])
    tr = np.array([i for i in range(n) if user_of[i] in cut], np.int64)
    va = np.array([i for i in range(n) if user_of[i] not in cut], np.int64)
    return RecDataset(n_items=n_items, max_hist=max_hist, hist=hist,
                      hist_len=hist_len, target=target, label=label,
                      train_idx=tr, val_idx=va)


def load_taobao(data_dir, max_hist=10, split=0.8, limit=None) -> RecDataset:
    """Parse the Taobao ad-click logs (reference
    ``taobao_rec_dataset_v2.py:87-197``).  Requires ``raw_sample.csv``;
    ``ad_feature.csv`` (if present) restricts to ads with features, as
    the reference does when it drops rows without profiles."""
    sample = os.path.join(data_dir, "raw_sample.csv")
    known_ads = None
    feat = os.path.join(data_dir, "ad_feature.csv")
    if os.path.exists(feat):
        with open(feat) as f:
            known_ads = {int(ln.split(",", 2)[0])
                         for ln in f.readlines()[1:] if ln.strip()}
    remap = {}
    rows = []
    with open(sample) as f:
        for i, ln in enumerate(f.readlines()[1:]):
            if limit is not None and i >= limit:
                break
            v = ln.strip().split(",")
            if len(v) < 6:
                continue
            user, ts, ad, clk = int(v[0]), int(v[1]), int(v[2]), int(v[5])
            if known_ads is not None and ad not in known_ads:
                continue        # no ad profile (reference skips these)
            if ad not in remap:
                remap[ad] = len(remap)
            rows.append((user, remap[ad], ts, clk))
    if not rows:
        raise ValueError("no usable rows in %s" % sample)
    return _interactions_to_rec(rows, len(remap), max_hist, split)


def load_movielens(data_dir, max_hist=16, split=0.8,
                   limit=None) -> RecDataset:
    """Parse MovieLens ``ratings.csv`` (reference
    ``movielens_dataset.py:59-113``): click := rating >= 4; movie ids
    remapped densely in first-seen order."""
    path = os.path.join(data_dir, "ratings.csv")
    remap = {}
    rows = []
    with open(path) as f:
        for i, ln in enumerate(f.readlines()[1:]):
            if limit is not None and i >= limit:
                break
            v = ln.strip().split(",")
            if len(v) < 4:
                continue
            user, movie = int(v[0]), int(v[1])
            click = float(v[2]) >= 4.0
            ts = int(v[3])
            if movie not in remap:
                remap[movie] = len(remap)
            rows.append((user, remap[movie], ts, int(click)))
    if not rows:
        raise ValueError("no usable rows in %s" % path)
    return _interactions_to_rec(rows, len(remap), max_hist, split)


def load_wikitext(data_dir, seq_len=32, vocab_limit=None) -> LMDataset:
    """Parse WikiText-style token files (reference
    ``language_model/data.py``): whitespace split, ``<eos>`` per line;
    vocab from the train split, optional most-frequent cap with
    ``<unk>`` = 0."""
    def read_tokens(name):
        toks = []
        with open(os.path.join(data_dir, name), encoding="utf8") as f:
            for ln in f:
                toks.extend(ln.split() + ["<eos>"])
        return toks

    train_toks = read_tokens("train.txt")
    val_toks = read_tokens("valid.txt")

    if vocab_limit:
        common = [w for w, _ in Counter(train_toks).most_common(
            vocab_limit - 1)]
        word2idx = {"<unk>": 0}
        for w in common:
            word2idx[w] = len(word2idx)
    else:
        word2idx = {}
        for w in train_toks:
            if w not in word2idx:
                word2idx[w] = len(word2idx)

    def encode(toks):
        unk = word2idx.get("<unk>", 0)
        ids = np.array([word2idx.get(w, unk) for w in toks], np.int32)
        n_seq = ids.size // (seq_len + 1)
        if n_seq == 0:
            raise ValueError("split too small for seq_len=%d" % seq_len)
        return ids[:n_seq * (seq_len + 1)].reshape(n_seq, seq_len + 1)

    return LMDataset(vocab_size=len(word2idx), seq_len=seq_len,
                     train_tokens=encode(train_toks),
                     val_tokens=encode(val_toks))


# Conventional data locations (the reference hardcodes ./data/<name>/)
DATA_ROOT = os.environ.get("DPF_DATA_ROOT", "data")


def _dir(name):
    return os.path.join(DATA_ROOT, name)


def load_taobao_or_synthetic(**kw):
    d = _dir("taobao")
    if os.path.exists(os.path.join(d, "raw_sample.csv")):
        return load_taobao(d, **kw)
    return make_rec_dataset()


def load_movielens_or_synthetic(**kw):
    d = _dir("ml-20m")
    if os.path.exists(os.path.join(d, "ratings.csv")):
        return load_movielens(d, **kw)
    return make_ratings_dataset()


def load_wikitext_or_synthetic(**kw):
    d = _dir("wikitext-2")
    if os.path.exists(os.path.join(d, "train.txt")):
        return load_wikitext(d, **kw)
    return make_lm_dataset()
