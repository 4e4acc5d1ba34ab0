"""LSTM language model with a PIR-maskable token-embedding table.

Port of ``dpf_tpu/models/lm.py`` (the reference's upstream-style LSTM LM,
``modules/language_model/language_model.py:9-67``) in ``torch.nn``, with
the evaluation hook where token embeddings not recovered by the
batch-PIR plan are dropped (zeroed) during eval
(``language_model_dataset.py:148-200``); reports perplexity instead of
AUC.

``nn.LSTM`` (cuDNN on the card) takes the place of flax's
``nn.RNN(nn.LSTMCell)``, which ``dpf_tpu`` computes in XLA, with no
Pallas kernel.  The gates are torch's order (i, f, g, o), which is
flax's; ``interop.lm_state_from_numpy`` carries flax's params across.
cuDNN may run float32 LSTMs in TF32 unless
``torch.backends.cudnn.allow_tf32`` is False (the default is True).  On
an H100 (``chip_smoke.py`` phase 10.1) the logits against the CPU did
not move with it on, and the parameters after one Adam step differed by
about 1e-2; with it off both agree with the CPU within 1e-4.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..api import resolve_device
from .datasets import LMDataset
from .init import flax_dense_, flax_embed_, flax_lstm_
from .rec import missing_rows


class LSTMLanguageModel(nn.Module):
    """Embedding -> one-layer LSTM (zero initial state) -> vocab logits."""

    def __init__(self, vocab_size: int, embed_dim: int = 32,
                 hidden: int = 64, generator: torch.Generator | None = None):
        super().__init__()
        self.token_embedding = nn.Embedding(vocab_size, embed_dim)
        self.lstm = nn.LSTM(embed_dim, hidden, batch_first=True)
        self.dense = nn.Linear(hidden, vocab_size)
        with torch.no_grad():
            flax_embed_(self.token_embedding.weight, generator)
            flax_lstm_(self.lstm, generator)
            flax_dense_(self.dense, generator)
        # flax's cell has one bias a gate (on the hidden-state Dense):
        # torch's input bias stays zero and untrained, so Adam sees
        # flax's parameters
        self.lstm.bias_ih_l0.requires_grad_(False)

    def forward(self, tokens, table=None):
        """tokens [B, T] -> logits [B, T, vocab].  ``table`` replaces the
        embedding weight (the masked working copy)."""
        w = self.token_embedding.weight if table is None else table
        h, _ = self.lstm(F.embedding(tokens, w))
        return self.dense(h)


def lm_loss(model: LSTMLanguageModel, tokens, table=None):
    """Mean next-token cross-entropy over [B, T] (optax's
    ``softmax_cross_entropy_with_integer_labels(...).mean()``)."""
    logits = model(tokens[:, :-1], table)
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           tokens[:, 1:].reshape(-1))


def init_lm(ds: LMDataset, embed_dim=32, hidden=64, seed=0,
            device=None) -> LSTMLanguageModel:
    """A fresh model for ``ds``, initialized on the host from ``seed`` and
    moved to ``device`` (None = CUDA)."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    return LSTMLanguageModel(ds.vocab_size, embed_dim, hidden,
                             generator=gen).to(dev)


def train_lm(ds: LMDataset, epochs=2, batch_size=32, lr=1e-2, seed=0,
             embed_dim=32, hidden=64, device=None) -> LSTMLanguageModel:
    """Adam on the mean cross-entropy; each step draws its batch as
    ``rng.permutation(len(toks))[:batch_size]``, as many steps an epoch
    as ``dpf_tpu`` takes.  Returns the model on ``device`` (None =
    CUDA)."""
    model = init_lm(ds, embed_dim, hidden, seed, device)
    dev = next(model.parameters()).device
    opt = torch.optim.Adam([p for p in model.parameters() if p.requires_grad],
                           lr=lr)
    toks = torch.from_numpy(ds.train_tokens).long().to(dev)
    rng = np.random.default_rng(seed)
    n = len(ds.train_tokens)
    for _ in range(epochs):
        for _ in range(0, n - batch_size + 1, batch_size):
            sel = torch.from_numpy(rng.permutation(n)[:batch_size]).to(dev)
            opt.zero_grad(set_to_none=True)
            lm_loss(model, toks[sel]).backward()
            opt.step()
    return model


@torch.no_grad()
def evaluate_with_pir(model: LSTMLanguageModel, ds: LMDataset,
                      pir_optimize=None):
    """Validation perplexity with unrecovered token embeddings zeroed in
    one shared working copy of the table, per sequence (restored after
    its forward pass)."""
    table = model.token_embedding.weight.detach().clone()
    dev = table.device
    val = torch.from_numpy(ds.val_tokens).long().to(dev)
    losses = []
    for k, row in enumerate(ds.val_tokens):
        missing = torch.tensor(
            missing_rows(set(int(t) for t in row), pir_optimize),
            dtype=torch.long, device=dev)
        saved = table[missing].clone()
        table[missing] = 0.0
        losses.append(lm_loss(model, val[k:k + 1], table))
        table[missing] = saved
    losses = torch.stack(losses).cpu().double().numpy()
    mean_loss = float(np.mean(losses))
    return {"val_loss": mean_loss, "perplexity": float(np.exp(mean_loss)),
            "n_eval": len(losses)}
