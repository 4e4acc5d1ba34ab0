"""Carry server state across from the JAX package as numpy arrays.

``state_from_numpy(table, keys)`` takes the state ``dpf_tpu`` serves
from -- the ``[N, E]`` int32 table and ``[B, W]`` int32 wire keys of one
construction -- and returns the port's tensors on the device:

* log-N keys (``[B, 524]``, binary or radix-4): a ``DeviceState`` with
  the table permuted into the tree's leaf order (bit-reversed, or
  digit-reversed for radix-4 keys) and the packed codewords and start
  seeds, ready for ``core.expand.expand_and_contract`` or
  ``core.radix4.expand_and_contract_mixed``;
* sqrt-N keys: a ``SqrtDeviceState`` with the natural-order table and
  the column seeds and codeword rows, ready for
  ``core.sqrtn.eval_contract_batched``.

``scheme`` names the construction (``"logn"`` or ``"sqrtn"``); None
detects it from the wire words and refuses a batch that would parse as
both.  Both packages then compute on identical state.

``rec_state_from_numpy(params)`` and ``lm_state_from_numpy(params)`` do
the same for the workload models: ``dpf_tpu``'s flax params, as a nested
dict of numpy arrays, become the ``state_dict`` of the port's
``models.rec.RecModel`` / ``models.lm.LSTMLanguageModel``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .api import resolve_device
from .core import expand, keygen, radix4, sqrtn
from .core.u32 import from_u32


class DeviceState(NamedTuple):
    table_perm: torch.Tensor   # [N, E] int32, rows in leaf order
    cw1: torch.Tensor          # [B, 64, 4] int32 limbs
    cw2: torch.Tensor          # [B, 64, 4] int32 limbs
    last: torch.Tensor         # [B, 4] int32 start seeds
    radix: int = 2             # 4 for radix-4 keys

    @property
    def depth(self) -> int:
        return self.table_perm.shape[0].bit_length() - 1


class SqrtDeviceState(NamedTuple):
    table: torch.Tensor        # [N, E] int32, natural order
    seeds: torch.Tensor        # [B, K, 4] int32 column seeds
    cw1: torch.Tensor          # [B, R, 4] int32 limbs
    cw2: torch.Tensor          # [B, R, 4] int32 limbs


def _sqrt_header_fits(wire: np.ndarray) -> bool:
    """True when every key's header reads as a consistent sqrt-N key
    (slot count 4 + K + 2R and n = K R)."""
    if wire.shape[1] % 4 or wire.shape[1] < 16:
        return False
    slots = wire.view(np.uint32).reshape(wire.shape[0], -1, 4)
    k = slots[:, 0, 0].astype(np.int64)
    r = slots[:, 1, 0].astype(np.int64)
    return bool(((4 + k + 2 * r == slots.shape[1])
                 & (k * r == sqrtn.sqrt_wire_ns(wire))).all())


def detect_scheme(wire: np.ndarray) -> str:
    """The construction of a stacked [B, W] wire batch: ``"sqrtn"`` when
    the headers read as sqrt-N keys, ``"logn"`` for 524-word keys;
    raises when both or neither fit."""
    sqrt_fits = _sqrt_header_fits(wire)
    logn_fits = wire.shape[1] == keygen.KEY_WORDS
    if sqrt_fits and logn_fits:
        raise ValueError("ambiguous keys: they read as log-N and as sqrt-N "
                         "keys; pass scheme=")
    if sqrt_fits:
        return "sqrtn"
    if logn_fits:
        return "logn"
    raise ValueError("keys of %d int32 words are neither log-N nor sqrt-N "
                     "keys" % wire.shape[1])


def state_from_numpy(table: np.ndarray, keys: np.ndarray, device=None,
                     scheme: str | None = None):
    """[N, E] int32 table + [B, W] int32 wire keys -> ``DeviceState``
    (log-N) or ``SqrtDeviceState`` (sqrt-N) on ``device`` (None =
    CUDA)."""
    dev = resolve_device(device)
    tbl = np.asarray(table)
    if tbl.dtype != np.int32 or tbl.ndim != 2:
        raise ValueError("table must be a 2D int32 array")
    n = tbl.shape[0]
    if n < 2 or n & (n - 1):
        raise ValueError("table rows (%d) must be a power of two" % n)
    wire = sqrtn.stack_sqrt_wire_keys(np.asarray(keys))
    if scheme is None:
        scheme = detect_scheme(wire)
    if scheme == "sqrtn":
        pk = sqrtn.decode_sqrt_keys_batched(wire)
        if pk.n != n:
            raise ValueError("keys for n=%d, table has %d rows" % (pk.n, n))
        return SqrtDeviceState(torch.from_numpy(tbl.copy()).to(dev),
                               *(from_u32(a).to(dev)
                                 for a in (pk.seeds, pk.cw1, pk.cw2)))
    if scheme != "logn":
        raise ValueError("scheme must be 'logn' or 'sqrtn' (got %r)"
                         % (scheme,))
    wire = keygen.stack_wire_keys(wire)
    radix = 4 if radix4.is_mixed_key(wire[0]) else 2
    if radix == 4:
        pk = radix4.decode_mixed_keys_batched(wire)
        rows = tbl[radix4.mixed_reverse_indices(radix4.arities(n))]
    else:
        pk = keygen.decode_keys_batched(wire)
        rows = expand.permute_table(tbl)
    if pk.n != n:
        raise ValueError("keys for n=%d, table has %d rows" % (pk.n, n))
    perm = torch.from_numpy(np.ascontiguousarray(rows)).to(dev)
    return DeviceState(perm, from_u32(pk.cw1).to(dev),
                       from_u32(pk.cw2).to(dev), from_u32(pk.last).to(dev),
                       radix)


# ---------------------------------------------------------------------------
# Workload model weights: dpf_tpu's flax params as nested numpy dicts
# ---------------------------------------------------------------------------

def _params_root(params) -> dict:
    """The ``params`` collection of a flax variables dict (or the
    collection itself)."""
    return params["params"] if "params" in params else params


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _linear(dense) -> dict:
    """flax ``Dense`` {kernel [in, out], bias} -> ``nn.Linear``'s
    {weight [out, in], bias}."""
    return {"weight": _tensor(dense["kernel"]).T.contiguous(),
            "bias": _tensor(dense["bias"])}


def rec_state_from_numpy(params) -> dict:
    """``dpf_tpu.models.rec.RecModel``'s params (``jax.tree_util.tree_map(
    np.asarray, params)``) -> the ``state_dict`` of the port's
    ``models.rec.RecModel``."""
    p = _params_root(params)
    state = {"item_embedding.weight": _tensor(p["item_embedding"]
                                              ["embedding"])}
    for i in range(3):
        for k, v in _linear(p["Dense_%d" % i]).items():
            state["dense_%d.%s" % (i, k)] = v
    return state


def lm_state_from_numpy(params) -> dict:
    """``dpf_tpu.models.lm.LSTMLanguageModel``'s params -> the
    ``state_dict`` of the port's ``models.lm.LSTMLanguageModel``.

    flax's ``LSTMCell`` has one ``Dense`` a gate on the input (``ii``,
    ``if``, ``ig``, ``io``, no bias) and one on the hidden state (``hi``,
    ``hf``, ``hg``, ``ho``, with bias); torch stacks the gates (i, f, g,
    o) in ``weight_ih_l0`` / ``weight_hh_l0`` and keeps two biases, of
    which ``bias_ih_l0`` is then zero."""
    p = _params_root(params)
    cell = p["LSTMCell_0"]
    w_ih = torch.cat([_tensor(cell["i" + g]["kernel"]) for g in "ifgo"],
                     dim=1).T.contiguous()
    w_hh = torch.cat([_tensor(cell["h" + g]["kernel"]) for g in "ifgo"],
                     dim=1).T.contiguous()
    b_hh = torch.cat([_tensor(cell["h" + g]["bias"]) for g in "ifgo"])
    dense = _linear(p["Dense_0"])
    return {"token_embedding.weight": _tensor(p["token_embedding"]
                                              ["embedding"]),
            "lstm.weight_ih_l0": w_ih, "lstm.weight_hh_l0": w_hh,
            "lstm.bias_ih_l0": torch.zeros_like(b_hh),
            "lstm.bias_hh_l0": b_hh,
            "dense.weight": dense["weight"], "dense.bias": dense["bias"]}
