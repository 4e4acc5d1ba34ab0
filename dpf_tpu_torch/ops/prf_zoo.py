"""The PRF zoo's candidates on the card: kernel K7 and its plain version.

Counterpart of ``dpf_tpu/core/prf_zoo.py::benchmark_zoo``'s jit-compiled
candidates (XLA; the TPU has no Pallas kernel for them).  One CUDA
kernel, ``csrc/prf_zoo.cu``, templated on the candidate, one instance
for each of the 15 (``CANDIDATES``, the order of ``core.prf_zoo.ZOO``):

* ``zoo_plain(name, seeds, pos)`` -- the plain version: the candidate's
  core from ``core/prf_zoo.py`` (per-child candidates: the output at
  ``pos``, ``[n, 4]``; block-PRG candidates: the four children of the
  block at counter ``pos``, ``[4, n, 4]``).
* ``zoo_eval(name, seeds, pos)`` -- the wrapper: a CUDA tensor launches
  K7 (a build or launch failure raises; there is no fallback), a CPU
  tensor takes the plain version.  It counts launches in
  ``zoo_eval.launches``.
* ``ops_per_call(name)`` -- the 32-bit instructions one call needs,
  counted from the plain function as the card executes them (LOP3,
  IADD3, LEA.HI; ``instructions_of``): the work of K7's bound.
"""

from __future__ import annotations

import torch

from ..core import prf_zoo
from . import cuda_build

CANDIDATES = tuple(prf_zoo.ZOO)


def _check(name: str, seeds: torch.Tensor) -> int:
    if name not in prf_zoo.ZOO:
        raise ValueError("unknown PRF-zoo candidate %r (one of %s)"
                         % (name, ", ".join(CANDIDATES)))
    if seeds.dtype != torch.int32 or seeds.dim() != 2 or seeds.shape[1] != 4:
        raise ValueError("seeds must be an int32 [n, 4] limb tensor, got "
                         "%s %s" % (seeds.dtype, tuple(seeds.shape)))
    return CANDIDATES.index(name)


def zoo_plain(name: str, seeds: torch.Tensor, pos: int = 1) -> torch.Tensor:
    """The candidate's plain core: ``[n, 4]`` at ``pos``, or the four
    children ``[4, n, 4]`` of a block-PRG candidate's block at counter
    ``pos``."""
    _check(name, seeds)
    if prf_zoo.CHILDREN_PER_CALL.get(name, 1) > 1:
        return prf_zoo.all_children(name, seeds, pos)
    return prf_zoo.ZOO[name](seeds, pos)


def zoo_eval(name: str, seeds: torch.Tensor, pos: int = 1) -> torch.Tensor:
    """K7 on CUDA tensors, the plain core on CPU ones (``zoo_plain``'s
    shapes).  ``pos`` is a position (or block counter) below 2^64."""
    cand = _check(name, seeds)
    if not 0 <= pos < (1 << 64):
        raise ValueError("pos must be in [0, 2^64), got %r" % (pos,))
    if seeds.device.type == "cpu":
        return zoo_plain(name, seeds, pos)
    if seeds.device.type != "cuda":
        raise ValueError("zoo_eval: unsupported device %s" % seeds.device)
    seeds = seeds.contiguous()
    if seeds.data_ptr() % 16:        # the kernel loads 16 bytes a seed
        seeds = seeds.clone()
    kids = prf_zoo.CHILDREN_PER_CALL.get(name, 1)
    n = seeds.shape[0]
    shape = (kids, n, 4) if kids > 1 else (n, 4)
    out = torch.empty(shape, dtype=torch.int32, device=seeds.device)
    with torch.cuda.device(seeds.device):
        cuda_build.launch("prf_zoo", "prf_zoo_launch", cand,
                          seeds.data_ptr(), out.data_ptr(), n, pos,
                          torch.cuda.current_stream().cuda_stream)
    zoo_eval.launches += 1
    return out


zoo_eval.launches = 0


# ---------------------------------------------------------------------------
# Instructions a call needs, counted from the plain function
# ---------------------------------------------------------------------------

# torch ops on a seed-dependent value and the instruction each becomes:
# bitwise ones fuse into LOP3, additions into IADD3 (and a rotate into
# the add that reads it, LEA.HI), the rest one each
_BOOL = {"__xor__", "__rxor__", "__and__", "__rand__", "__or__", "__ror__",
         "__invert__", "bitwise_not", "bitwise_xor", "bitwise_and",
         "bitwise_or"}
_ADD = {"add", "sub", "rsub", "__add__", "__radd__", "__sub__", "__rsub__"}
_ONE = {"mul", "__mul__", "__rmul__", "__lshift__", "__rshift__", "lt", "gt",
        "le", "ge", "__lt__", "__gt__", "__le__", "__ge__"}
# results that depend on no input value
_CONSTANT = {"zeros_like", "ones_like", "full_like", "empty_like"}


class _Node:
    """One recorded operation: ``kind`` "bool" (a LOP3 operand tree),
    "add" (an IADD3 chain), "add64" (an IADD3 / IADD3.X pair chain),
    "rot" (a 32-bit rotate), "op" (``weight`` instructions) or "free"
    (no instruction: views,
    stacks, dtype casts); ``n_const`` its constant operands; ``pairs``
    an "add64"'s operands as (lo, hi) node pairs."""
    __slots__ = ("kind", "weight", "inputs", "n_const", "pairs")

    def __init__(self, kind, weight, inputs, n_const, pairs=None):
        self.kind, self.weight, self.inputs = kind, weight, inputs
        self.n_const, self.pairs = n_const, pairs


def _leaves(x):
    if isinstance(x, (list, tuple)):
        for v in x:
            yield from _leaves(v)
    else:
        yield x


def instructions_of(fn) -> int:
    """32-bit instructions the card needs for ``fn(seeds)`` on one seed
    (``seeds`` an int32 ``[1, 4]`` tensor): ``fn`` runs under a
    ``TorchFunctionMode`` that records each operation on a seed-dependent
    value; operations on constants fold away and those the output does
    not depend on are dropped.  What is left is counted as the card
    executes it:

    * a bitwise function of at most three operands (constants included)
      is one ``LOP3``: an and, or, xor or not is merged into the one
      that consumes it when it has no other consumer and the merged
      function keeps to three operands;
    * a sum of ``k`` 32-bit addends is ``ceil((k - 1) / 2)`` ``IADD3``
      (its constants folded into one): an add or subtract is merged
      into the add that consumes it when it has no other;
    * a rotate whose one consumer is such a sum is merged into it: a
      ``LEA.HI`` adds one addend to the funnel-shifted operand, so the
      sum takes ``1 + ceil((k - 2) / 2)`` instructions;
    * a 64-bit add of limb pairs is an ``IADD3`` / ``IADD3.X`` pair,
      merged into chains the same way; a 64-bit rotate two funnel
      shifts (none by 32); a 32 x 32 -> 64 product one ``IMAD.WIDE``;
    * a rotate, shift, byte swap, multiply or compare is one.

    Not the emulation the plain version uses for 64-bit words and wide
    products."""
    from torch.overrides import TorchFunctionMode

    from ..core import prf as prf_mod
    from ..core import prf_zoo_hash as zh

    nodes, order, keep, views = {}, [], [], {}
    inner = [False]

    def record(outs, args, kind, weight=1, pairs=None, view=False):
        ins = [t for t in _leaves(args) if isinstance(t, torch.Tensor)]
        if not any(id(t) in nodes for t in ins):
            return
        n_const = sum(1 for t in _leaves(args)
                      if not isinstance(t, torch.Tensor) or id(t) not in nodes)
        node = _Node(kind, weight,
                     [nodes[id(t)] for t in ins if id(t) in nodes], n_const,
                     pairs)
        if view:           # one node for each element read, however often
            node = views.setdefault((id(node.inputs[0]), repr(args[1:])),
                                    node)
        order.append(node)
        for o in _leaves(outs):
            if isinstance(o, torch.Tensor):
                keep.append(o)
                nodes[id(o)] = node

    class Recorder(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = getattr(func, "__name__", "")
            if not inner[0] and name not in _CONSTANT:
                record(out, args, "bool" if name in _BOOL else "add"
                       if name in _ADD else "op" if name in _ONE else "free",
                       view=name == "__getitem__")
            return out

    def unit(fn, kind, weight):
        def wrapped(*args):
            if inner[0]:
                return fn(*args)
            pairs = None
            if kind == "add64":
                pairs = [tuple(nodes.get(id(t)) for t in a) for a in args]
            inner[0] = True
            try:
                out = fn(*args)
            finally:
                inner[0] = False
            if weight(*args):          # else it returns its operands
                record(out, args, kind, weight(*args), pairs)
            return out
        return wrapped

    patches = [
        (prf_mod, "rotl", "rot", lambda x, b: 1),
        (zh, "shr", "op", lambda x, s: 1 if s else 0),
        (zh, "_rotl32", "rot", lambda x, n: 1 if n % 32 else 0),
        (zh, "_rotr32", "rot", lambda x, b: 1),
        (zh, "_bswap32", "op", lambda x: 1),
        (zh, "_add64", "add64", lambda a, b: 2),
        (zh, "_rotl64", "op", lambda a, n: 0 if n % 32 == 0 else 2),
        (zh, "_mul32x32", "op", lambda a, b: 1)]
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _, _ in patches]
    seeds = torch.zeros((1, 4), dtype=torch.int32)
    nodes[id(seeds)] = _Node("free", 0, [], 0)
    try:
        for mod, attr, kind, weight in patches:
            setattr(mod, attr, unit(getattr(mod, attr), kind, weight))
        with Recorder():
            out = fn(seeds)
    finally:
        for mod, attr, fn_ in saved:
            setattr(mod, attr, fn_)
    return _fused_count(nodes[id(out)], order)


def _fused_count(out, order) -> int:
    """``instructions_of``'s count over the recorded graph."""
    live, stack = set(), [out]
    while stack:
        node = stack.pop()
        if id(node) not in live:
            live.add(id(node))
            stack.extend(node.inputs)

    uses = {id(out): 1}
    for node in order:
        if id(node) in live:
            for i in set(map(id, node.inputs)):
                uses[i] = uses.get(i, 0) + 1
    merged, operands, consts, rots, total = set(), {}, {}, {}, 0
    for node in order:
        if id(node) not in live or node.kind == "free":
            continue
        if node.kind == "bool":
            cut, n_const = set(), node.n_const
            for i in node.inputs:
                if i.kind == "bool" and uses[id(i)] == 1 and \
                        len(cut | operands[id(i)]) + n_const + \
                        consts[id(i)] <= 3:
                    cut |= operands[id(i)]
                    n_const += consts[id(i)]
                    merged.add(id(i))
                else:
                    cut.add(id(i))
            operands[id(node)], consts[id(node)] = cut, n_const
        elif node.kind in ("add", "add64"):
            if node.kind == "add":
                ins = node.inputs
            else:                  # a pair from one node is one addend
                ins = [p[0] if p[0] is p[1] and p[0] is not None else None
                       for p in node.pairs]
            k, n_const, rot = 0, node.n_const > 0, False
            for i in ins:
                if i is not None and i.kind == node.kind and \
                        uses[id(i)] == 1:
                    k += operands[id(i)]
                    n_const |= consts[id(i)]
                    rot |= rots[id(i)]
                    merged.add(id(i))
                else:
                    k += 1
            for i in ins:              # one LEA.HI a sum
                if node.kind == "add" and not rot and i.kind == "rot" \
                        and uses[id(i)] == 1:
                    rot = True
                    merged.add(id(i))
            operands[id(node)], consts[id(node)] = k, n_const
            rots[id(node)] = rot
    for node in order:
        if id(node) not in live or id(node) in merged:
            continue
        if node.kind in ("op", "rot"):
            total += node.weight
        elif node.kind == "bool":
            total += 1
        elif node.kind != "free":
            n = operands[id(node)] + consts[id(node)]
            if rots[id(node)]:
                total += 1 + -(-max(n - 2, 0) // 2)
            else:
                steps = max(1, -(-(n - 1) // 2))
                total += steps * (2 if node.kind == "add64" else 1)
    return total


def ops_per_call(name: str) -> int:
    """32-bit instructions one call of candidate ``name`` needs (all four
    children of a block-PRG candidate's block), by ``instructions_of``:
    the work of K7's bound."""
    pos = 0 if name in prf_zoo.CHILDREN_PER_CALL else 1
    return instructions_of(lambda seeds: zoo_plain(name, seeds, pos))
