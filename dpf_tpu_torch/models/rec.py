"""Recommendation (CTR) model with a PIR-maskable embedding table.

Port of ``dpf_tpu/models/rec.py`` (the reference's ``RecModel``,
EmbeddingBag tables + 3-layer MLP, ``taobao_rec_dataset_v2.py:30-70``)
in ``torch.nn``, plus the accuracy-vs-PIR-budget evaluation hook
(``:199-260``): embeddings of rows a batch-PIR plan failed to recover are
replaced by a sentinel (zero) vector before inference, and ROC-AUC is
reported.

The module holds its parameters, so where ``dpf_tpu`` passes
``(model, params)`` the port passes the model: ``train_rec_model``
returns it and ``evaluate_with_pir(model, ds, pir_optimize)`` reads it.
``interop.rec_state_from_numpy`` carries ``dpf_tpu``'s flax params into
its ``state_dict``.  The layers run in PyTorch's own kernels (cuBLAS on
the card): ``dpf_tpu`` computes them in XLA, with no Pallas kernel.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..api import resolve_device
from .datasets import RecDataset
from .init import flax_dense_, flax_embed_


class RecModel(nn.Module):
    """Mean-pooled history and target embeddings -> 3-layer MLP -> logit.

    Item 0 is a real item: only ``hist_len`` masks the history (no
    ``padding_idx``).  ``generator`` seeds the initializers (flax's
    default families, ``models/init.py``)."""

    def __init__(self, n_items: int, embed_dim: int = 16, hidden: int = 64,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.item_embedding = nn.Embedding(n_items, embed_dim)
        self.dense_0 = nn.Linear(3 * embed_dim, hidden)
        self.dense_1 = nn.Linear(hidden, hidden)
        self.dense_2 = nn.Linear(hidden, 1)
        with torch.no_grad():
            flax_embed_(self.item_embedding.weight, generator)
            for layer in (self.dense_0, self.dense_1, self.dense_2):
                flax_dense_(layer, generator)

    def forward(self, hist, hist_len, target, table=None):
        """hist [B, L], hist_len [B], target [B] -> logits [B].  ``table``
        replaces the embedding weight (the masked working copy)."""
        w = self.item_embedding.weight if table is None else table
        h = F.embedding(hist, w)                               # [B, L, D]
        mask = (torch.arange(h.shape[1], device=h.device)[None, :]
                < hist_len[:, None]).to(h.dtype)               # [B, L]
        pooled = (h * mask[..., None]).sum(1) / torch.clamp(
            mask.sum(1, keepdim=True), min=1.0)               # mean-pool
        t = F.embedding(target, w)                             # [B, D]
        x = torch.cat([pooled, t, pooled * t], dim=-1)
        x = F.relu(self.dense_0(x))
        x = F.relu(self.dense_1(x))
        return self.dense_2(x)[..., 0]


def _batches(rng, idx, batch_size):
    idx = rng.permutation(idx)
    for i in range(0, len(idx) - batch_size + 1, batch_size):
        yield idx[i:i + batch_size]


def rec_loss(model: RecModel, hist, hist_len, target, label):
    """Mean sigmoid binary cross-entropy (optax's
    ``sigmoid_binary_cross_entropy(...).mean()``)."""
    return F.binary_cross_entropy_with_logits(
        model(hist, hist_len, target), label)


def dataset_tensors(ds: RecDataset, device) -> tuple:
    """(hist, hist_len, target, label) of every example on ``device``."""
    return (torch.from_numpy(ds.hist).long().to(device),
            torch.from_numpy(ds.hist_len).long().to(device),
            torch.from_numpy(ds.target).long().to(device),
            torch.from_numpy(ds.label).to(device))


def init_rec_model(ds: RecDataset, embed_dim=16, seed=0,
                   device=None) -> RecModel:
    """A fresh model for ``ds``, initialized on the host from ``seed`` and
    moved to ``device`` (None = CUDA): every device gets the same
    weights."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    return RecModel(ds.n_items, embed_dim=embed_dim, generator=gen).to(dev)


def train_rec_model(ds: RecDataset, epochs=3, batch_size=64, lr=1e-2,
                    embed_dim=16, seed=0, device=None) -> RecModel:
    """Adam on the mean BCE, batches in ``dpf_tpu``'s order (a numpy
    permutation of ``train_idx`` each epoch, the trailing partial batch
    dropped); returns the trained model on ``device`` (None = CUDA)."""
    model = init_rec_model(ds, embed_dim, seed, device)
    dev = next(model.parameters()).device
    opt = torch.optim.Adam(model.parameters(), lr=lr)
    data = dataset_tensors(ds, dev)
    rng = np.random.default_rng(seed)
    for _ in range(epochs):
        for b in _batches(rng, ds.train_idx, batch_size):
            sel = torch.from_numpy(np.asarray(b, np.int64)).to(dev)
            opt.zero_grad(set_to_none=True)
            rec_loss(model, *(t[sel] for t in data)).backward()
            opt.step()
    return model


def roc_auc(labels: np.ndarray, scores: np.ndarray) -> float:
    """Rank-based AUC (Mann-Whitney), no sklearn dependency."""
    order = np.argsort(scores)
    ranks = np.empty_like(order, dtype=np.float64)
    ranks[order] = np.arange(1, len(scores) + 1)
    # average ranks for ties
    sorted_scores = scores[order]
    i = 0
    while i < len(sorted_scores):
        j = i
        while j + 1 < len(sorted_scores) and \
                sorted_scores[j + 1] == sorted_scores[i]:
            j += 1
        if j > i:
            ranks[order[i:j + 1]] = (i + 1 + j + 1) / 2.0
        i = j + 1
    pos = labels > 0.5
    n_pos, n_neg = pos.sum(), (~pos).sum()
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    return float((ranks[pos].sum() - n_pos * (n_pos + 1) / 2)
                 / (n_pos * n_neg))


def missing_rows(touched: set, pir_optimize) -> list:
    """The touched rows a plan does not recover (none without a plan)."""
    if pir_optimize is None:
        return []
    recovered, _ = pir_optimize.fetch(sorted(touched))
    return sorted(touched - set(recovered))


@torch.no_grad()
def evaluate_with_pir(model: RecModel, ds: RecDataset, pir_optimize=None):
    """Validation ROC-AUC with PIR-unrecovered embeddings masked to zero.

    ``pir_optimize`` is a ``BatchPIROptimize`` (or None = no PIR, full
    access).  Per validation example, the rows its lookup touches are
    fetched with the plan; the unrecovered ones are zeroed in one shared
    working copy of the table on the model's device for that example's
    forward pass and restored after it (reference semantics,
    ``taobao_rec_dataset_v2.py:199-260``)."""
    table = model.item_embedding.weight.detach().clone()
    dev = table.device
    hist, hist_len, target, _ = dataset_tensors(ds, dev)
    scores, labels = [], []
    for i in ds.val_idx:
        i = int(i)
        l = int(ds.hist_len[i])
        touched = set(int(x) for x in ds.hist[i, :l]) | {int(ds.target[i])}
        missing = torch.tensor(missing_rows(touched, pir_optimize),
                               dtype=torch.long, device=dev)
        saved = table[missing].clone()
        table[missing] = 0.0
        scores.append(model(hist[i:i + 1], hist_len[i:i + 1],
                            target[i:i + 1], table=table))
        table[missing] = saved
        labels.append(float(ds.label[i]))
    scores = torch.cat(scores).cpu().double().numpy()
    return {"roc_auc": roc_auc(np.asarray(labels), scores),
            "n_eval": len(labels)}
