"""flax's default initializer families for the port's ``torch.nn`` layers.

A model trained in the port starts where ``dpf_tpu``'s flax model does
(the same distributions, not the same values: ``torch.Generator`` and
``jax.random`` give different numbers from one seed):

* ``Dense``: ``lecun_normal``, a normal truncated at two standard
  deviations with variance 1 / fan_in after the truncation, and a zero
  bias (``flax.linen.linear.default_kernel_init``);
* ``Embed``: ``variance_scaling(1.0, "fan_in", "normal", out_axis=0)``,
  whose fan-in for a ``[V, D]`` table is D: a plain normal of variance
  1 / D (``flax.linen.linear.default_embed_init``);
* ``LSTMCell``: ``lecun_normal`` input kernels, ``orthogonal``
  recurrent kernels, one per gate, and zero biases
  (``flax.linen.recurrent.LSTMCell``).
"""

from __future__ import annotations

import math

import torch
from torch import nn

# the standard deviation of a unit normal truncated to [-2, 2]
# (jax.nn.initializers.variance_scaling's correction)
_TRUNC_STD = .87962566103423978


def lecun_normal_(w: torch.Tensor, fan_in: int, generator=None):
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    return nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                 generator=generator)


def flax_dense_(layer: nn.Linear, generator=None) -> None:
    """``nn.Linear`` as flax's ``Dense``: weight [out, in], fan-in = in."""
    lecun_normal_(layer.weight, layer.in_features, generator)
    if layer.bias is not None:
        nn.init.zeros_(layer.bias)


def flax_embed_(w: torch.Tensor, generator=None):
    """A ``[V, D]`` table as flax's ``Embed``: normal, variance 1 / D."""
    return nn.init.normal_(w, 0.0, math.sqrt(1.0 / w.shape[1]),
                           generator=generator)


def flax_lstm_(lstm: nn.LSTM, generator=None) -> None:
    """A one-layer ``nn.LSTM`` as flax's ``LSTMCell``: each gate's block
    (i, f, g, o) of ``weight_ih_l0`` lecun-normal, of ``weight_hh_l0``
    orthogonal, both biases zero."""
    h = lstm.hidden_size
    for g in range(4):
        lecun_normal_(lstm.weight_ih_l0[g * h:(g + 1) * h], lstm.input_size,
                      generator)
        nn.init.orthogonal_(lstm.weight_hh_l0[g * h:(g + 1) * h],
                            generator=generator)
    nn.init.zeros_(lstm.bias_ih_l0)
    nn.init.zeros_(lstm.bias_hh_l0)
