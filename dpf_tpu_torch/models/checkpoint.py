"""Model checkpoint/resume (port of ``dpf_tpu/models/checkpoint.py``).

The reference persists trained workload models to ``model.pt``; the JAX
package writes Orbax checkpoints of flax params.  Here a checkpoint is
one file: ``torch.save`` of a model's ``state_dict``, read back with
``torch.load(weights_only=True)``.
"""

from __future__ import annotations

import os

import torch
from torch import nn


def _state(params) -> dict:
    return params.state_dict() if isinstance(params, nn.Module) else params


def save_params(path: str, params) -> str:
    """Save a ``state_dict`` (or a module's); returns the absolute path.
    Tensors are saved from the host, so a checkpoint loads anywhere."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    state = {k: v.detach().cpu() for k, v in _state(params).items()}
    tmp = "%s.%d.tmp" % (path, os.getpid())
    torch.save(state, tmp)
    os.replace(tmp, path)
    return path


def load_params(path: str, like=None, map_location="cpu") -> dict:
    """Load a ``state_dict`` saved by ``save_params``.

    ``like``: a module or ``state_dict`` with the target structure; the
    loaded tensors must match its keys, shapes and dtypes, and land on
    its devices.  Without it, tensors land on ``map_location``."""
    state = torch.load(os.path.abspath(path), weights_only=True,
                       map_location=map_location)
    if like is None:
        return state
    ref = _state(like)
    if set(state) != set(ref):
        raise ValueError("checkpoint %s has keys %s, expected %s"
                         % (path, sorted(state), sorted(ref)))
    out = {}
    for k, v in ref.items():
        if state[k].shape != v.shape or state[k].dtype != v.dtype:
            raise ValueError("checkpoint %s: %s is %s %s, expected %s %s"
                             % (path, k, state[k].dtype,
                                tuple(state[k].shape), v.dtype,
                                tuple(v.shape)))
        out[k] = state[k].to(v.device)
    return out


def train_or_restore(path: str, init_fn, train_fn) -> nn.Module:
    """Resume-from-checkpoint pattern.

    ``init_fn() -> model`` must be cheap (a fresh module on its device);
    ``train_fn() -> model`` is the expensive run.  Restores into
    ``init_fn()``'s model from ``path`` when present, otherwise trains
    and checkpoints."""
    if os.path.exists(path):
        model = init_fn()
        model.load_state_dict(load_params(path, like=model))
        return model
    model = train_fn()
    save_params(path, model)
    return model
