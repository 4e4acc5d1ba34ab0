"""Synthetic workload datasets + access-pattern extraction.

Port of ``dpf_tpu/models/datasets.py``, which uses only numpy: a copy,
so this package imports no JAX.  The same seed gives byte-identical
arrays in both packages.

The reference's batch-PIR experiments run on Taobao CTR, MovieLens, and
WikiText-2 (``paper/experimental/.../modules/*``) -- external downloads.
These generators produce statistical stand-ins with the properties the
experiments exercise:

* zipf-distributed item popularity (so hot/cold splitting matters),
* user-interest clustering (so co-location finds structure),
* click labels correlated with cluster membership (so a trained model's
  accuracy degrades measurably when PIR fails to recover embeddings),
* a markov token stream for the LM (so context carries information).

Each dataset exposes the contract the reference modules do
(``taobao_rec_dataset_v2.py:87-197``): train/val *access patterns* -- one
set of embedding-table indices per example -- plus arrays for model
training; the ``evaluate_with_pir`` hooks are in rec.py / lm.py.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class RecDataset:
    """Synthetic CTR dataset: user histories + candidate item + click label."""
    n_items: int
    max_hist: int
    hist: np.ndarray          # [N, max_hist] int32 item ids (0 = pad)
    hist_len: np.ndarray      # [N] int32
    target: np.ndarray        # [N] int32 candidate item
    label: np.ndarray         # [N] float32 click 0/1
    train_idx: np.ndarray
    val_idx: np.ndarray

    def access_patterns(self, split="train"):
        """Embedding rows touched per example (the batch-PIR unit)."""
        idx = self.train_idx if split == "train" else self.val_idx
        out = []
        for i in idx:
            l = int(self.hist_len[i])
            out.append([int(x) for x in self.hist[i, :l]]
                       + [int(self.target[i])])
        return out


def make_rec_dataset(n_items=2000, n_users=400, samples_per_user=6,
                     max_hist=10, n_clusters=20, seed=0,
                     pop_exponent=0.8) -> RecDataset:
    rng = np.random.default_rng(seed)
    # zipf popularity over items, each item assigned an interest cluster
    pop = 1.0 / np.arange(1, n_items + 1) ** pop_exponent
    pop /= pop.sum()
    item_cluster = rng.integers(0, n_clusters, n_items)

    rows = []
    nonempty_clusters = np.unique(item_cluster)
    for _ in range(n_users):
        # pick among clusters that actually own items (small n_items can
        # leave some of the n_clusters empty)
        user_cluster = int(rng.choice(nonempty_clusters))
        cluster_items = np.where(item_cluster == user_cluster)[0]
        for _ in range(samples_per_user):
            l = int(rng.integers(2, max_hist + 1))
            own = rng.choice(cluster_items, size=max(1, l // 2))
            other = rng.choice(n_items, size=l - own.size, p=pop)
            h = np.concatenate([own, other])[:l]
            target = (int(rng.choice(cluster_items)) if rng.random() < 0.5
                      else int(rng.choice(n_items, p=pop)))
            # click iff target matches user's cluster (plus noise)
            label = float(item_cluster[target] == user_cluster)
            if rng.random() < 0.1:
                label = 1.0 - label
            rows.append((h, l, target, label))

    n = len(rows)
    hist = np.zeros((n, max_hist), np.int32)
    hist_len = np.zeros(n, np.int32)
    target = np.zeros(n, np.int32)
    label = np.zeros(n, np.float32)
    for i, (h, l, t, y) in enumerate(rows):
        hist[i, :l] = h
        hist_len[i] = l
        target[i] = t
        label[i] = y
    perm = rng.permutation(n)
    split = int(0.8 * n)
    return RecDataset(n_items=n_items, max_hist=max_hist, hist=hist,
                      hist_len=hist_len, target=target, label=label,
                      train_idx=perm[:split], val_idx=perm[split:])


def make_ratings_dataset(n_items=1500, n_users=300, samples_per_user=8,
                         max_hist=16, n_clusters=12, seed=1) -> RecDataset:
    """MovieLens-style second recommendation workload (reference
    ``modules/movielens_rec/movielens_dataset.py``): same contract as
    ``make_rec_dataset`` but longer histories, flatter popularity, and
    denser per-user activity — a different access-pattern regime for the
    batch-PIR sweeps (bins see more co-access, hot split matters less).
    """
    return make_rec_dataset(n_items=n_items, n_users=n_users,
                            samples_per_user=samples_per_user,
                            max_hist=max_hist, n_clusters=n_clusters,
                            seed=seed, pop_exponent=0.4)


@dataclass
class LMDataset:
    """Synthetic token stream for the LSTM language model."""
    vocab_size: int
    seq_len: int
    train_tokens: np.ndarray  # [n_train, seq_len+1] int32
    val_tokens: np.ndarray    # [n_val, seq_len+1] int32

    def access_patterns(self, split="train"):
        toks = self.train_tokens if split == "train" else self.val_tokens
        return [[int(t) for t in row] for row in toks]


def make_lm_dataset(vocab_size=1000, seq_len=32, n_train=300, n_val=60,
                    seed=0) -> LMDataset:
    rng = np.random.default_rng(seed)
    # first-order markov chain with zipf marginals: contexts are informative
    pop = 1.0 / np.arange(1, vocab_size + 1)
    pop /= pop.sum()
    # each token has a small successor set
    succ = rng.choice(vocab_size, size=(vocab_size, 4), p=pop)

    def sample(n):
        out = np.zeros((n, seq_len + 1), np.int32)
        for i in range(n):
            t = int(rng.choice(vocab_size, p=pop))
            for j in range(seq_len + 1):
                out[i, j] = t
                t = (int(succ[t, rng.integers(0, 4)])
                     if rng.random() < 0.85 else
                     int(rng.choice(vocab_size, p=pop)))
        return out

    return LMDataset(vocab_size=vocab_size, seq_len=seq_len,
                     train_tokens=sample(n_train), val_tokens=sample(n_val))
