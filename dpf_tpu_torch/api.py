"""User-facing DPF API on PyTorch and CUDA.

Port of ``dpf_tpu/api.py::DPF`` for its three constructions: the binary
GGM tree (the reference's wire format, 524-int32 keys), with
``config=EvalConfig(radix=4)`` the radix-4 tree (``core/radix4.py``),
and with ``scheme="sqrtn"`` the sqrt-N grid (``core/sqrtn.py``,
``(4 + K + 2R) * 4``-int32 keys).  ``gen`` / ``eval_init`` /
``eval_gpu`` (alias ``eval_tpu``) / ``eval_cpu`` / ``eval_one_hot`` /
``eval_points`` / ``eval_free``, constants ``ENTRY_SIZE`` /
``BATCH_SIZE`` / ``PRF_*``.  Shares are bit-identical to ``dpf_tpu``'s;
a key of one construction sent to a server of another raises.

Keys are made on the host, as in ``dpf_tpu``: ``gen`` with one index,
or ``gen`` / ``gen_batch`` with a list of indices (the vectorized
generators ``keygen.gen_batched``, ``radix4.gen_batched_r4`` and
``sqrtn.gen_sqrt_batched``; the binary tree takes the C++ generator of
``native/`` when it is built).  The server runs on the device given at
construction: ``device=None`` means ``"cuda"`` and raises when CUDA is
absent; ``device="cpu"`` runs the kernels' plain versions on the CPU.
Keys are CPU int32 tensors;
``eval_gpu`` / ``eval_one_hot`` / ``eval_points`` return int32 tensors
on the server's device; ``eval_cpu`` returns CPU tensors.

``eval_gpu`` and the serving engine (``serving_engine()``,
``serve/engine.py``) share one route: ``_decode_batch`` (the batched
wire codec), ``_stage_packed`` (the batch in one host buffer in the
device layout: pageable for ``eval_gpu``, a pinned slot for the engine)
and ``_dispatch_packed`` (upload, kernels; no host sync).
``EvalConfig(kernel_impl="dispatch")`` runs the GGM trees one level a
launch with ``dispatch_deadline`` checked between launches.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from . import native
from .core import evalref, expand, keygen, radix4, sqrtn, u128
from .core.prf_ref import (PRF_AES128, PRF_CHACHA20, PRF_CHACHA20_BLK,
                           PRF_DUMMY, PRF_NAMES, PRF_SALSA20,
                           PRF_SALSA20_BLK)
from .core.u32 import from_u32
from .utils.config import check_construction


def resolve_device(device=None) -> torch.device:
    """``None`` -> CUDA.  A CUDA device raises when CUDA is absent: there
    is no fallback to the CPU unless the caller asks for it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to "
                           "run the plain versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError("unsupported device %s" % dev)
    return dev


def _to_numpy(x, dtype=None) -> np.ndarray:
    if hasattr(x, "detach"):  # torch tensor, any device
        x = x.detach().cpu().numpy()
    arr = np.asarray(x)
    if dtype is not None and arr.dtype != dtype:
        arr = arr.astype(dtype)
    return arr


def _check_construction(scheme: str, radix: int) -> None:
    check_construction(scheme, radix)
    if scheme == "auto":
        raise NotImplementedError("scheme='auto' needs the tuning cache, "
                                  "not ported yet (ROADMAP Queue 1 item 8)")


def gen_batched_binary(alphas, n: int, seeds, prf_method: int, knobs=None):
    """Batched binary-tree keygen: the C++ generator one key at a time
    when ``native`` is built, else ``keygen.gen_batched`` (``knobs`` is
    read by the vectorized generator only).  Both give the same bytes.
    Returns two ``[B, 524]`` int32 CPU tensors."""
    alphas, seeds = keygen._check_batch_args(alphas, n, seeds)
    if not native.available():
        return keygen.gen_batched(alphas, n, seeds, prf_method=prf_method,
                                  knobs=knobs)
    outs = [native.gen(int(a), n, sd, prf_method)
            for a, sd in zip(alphas, seeds)]
    return (torch.from_numpy(np.stack([a for a, _ in outs])),
            torch.from_numpy(np.stack([b for _, b in outs])))


#: int32 words a staged log-N key takes: cw1 and cw2 (64 x 4 each) and
#: the start seed (4)
LOGN_KEY_WORDS = 2 * 64 * 4 + 4


def _logn_planes(buf, size: int) -> tuple:
    """The three planes of a staged log-N buffer (numpy array or
    tensor): cw1 ``[size, 64, 4]``, cw2 ``[size, 64, 4]`` and the start
    seeds ``[size, 4]``, each contiguous."""
    p = size * 64 * 4
    return (buf[:p].reshape(size, 64, 4), buf[p:2 * p].reshape(size, 64, 4),
            buf[2 * p:2 * p + 4 * size].reshape(size, 4))


def _host_buffer(words: int, stage=None) -> torch.Tensor:
    """``words`` int32 of host memory: the staging slot's pinned buffer,
    or a fresh pageable one."""
    if stage is None:
        return torch.empty(words, dtype=torch.int32)
    return stage.buffer(words)


class StagedKeys:
    """A packed batch laid out in one host buffer (``stage_packed``):
    ``rows`` real keys, dispatched as ``size`` rows; ``stage`` is the
    pinned staging slot that holds ``host``, or None."""
    __slots__ = ("host", "rows", "size", "pk", "stage")

    def __init__(self, host, rows, size, pk, stage):
        self.host = host
        self.rows = rows
        self.size = size
        self.pk = pk
        self.stage = stage


def stage_packed(pk, size: int | None, stage, sqrt: bool) -> StagedKeys:
    """Lay a packed batch out in one host buffer in the layout the
    device takes (host work only).  Log-N: three planes, cw1
    ``[size, 64, 4]``, cw2 and the start seeds ``[size, 4]``, padded here
    to ``size`` rows by repeating the last key (2 KiB a row).  Sqrt-N
    (``sqrt``): ``[rows, 4 (K + 2R)]``, a key's seeds and codewords per
    row, padded on the device (48 KiB a row at N = 2^20).

    ``stage``: a pinned staging slot (``serve.engine.PinnedStage``:
    ``buffer(words)`` hands out its pinned buffer once the last copy
    that read it has passed); None = a fresh pageable buffer."""
    rows = pk.batch
    size = rows if size is None else int(size)
    if size < rows:
        raise ValueError("cannot stage %d keys in %d rows" % (rows, size))
    if sqrt:
        k, r = pk.n_keys, pk.n_codewords
        width = 4 * (k + 2 * r)
        host = _host_buffer(rows * width, stage).view(rows, width)
        h = host.numpy().view(np.uint32)
        h[:, :4 * k] = pk.seeds.reshape(rows, 4 * k)
        h[:, 4 * k:4 * (k + r)] = pk.cw1.reshape(rows, 4 * r)
        h[:, 4 * (k + r):] = pk.cw2.reshape(rows, 4 * r)
    else:
        host = _host_buffer(size * LOGN_KEY_WORDS, stage)
        for plane, src in zip(_logn_planes(host.numpy().view(np.uint32),
                                           size),
                              (pk.cw1, pk.cw2, pk.last)):
            plane[:rows] = src
            plane[rows:] = src[-1]
    return StagedKeys(host, rows, size, pk, stage)


def upload(staged: StagedKeys, device: torch.device) -> torch.Tensor:
    """The staged buffer on ``device``: from pinned memory an
    asynchronous copy on the current stream, after which the staging
    slot records the event that frees it; from pageable memory a copy the
    host waits for; on the CPU the buffer itself."""
    host = staged.host
    if device.type == "cpu":
        return host
    dev = host.to(device, non_blocking=host.is_pinned())
    if staged.stage is not None:
        staged.stage.record_copy()
    return dev


def _native_gen(k: int, n: int, seed: bytes, prf_method: int):
    """The scalar binary keygen through ``native`` when it is built, else
    None."""
    if not native.available():
        return None
    return native.gen(k, n, seed, prf_method)


def _native_expand_batch(keys, prf_method: int):
    """``[B, n]`` int32 one-hot shares of binary keys through ``native``
    when it is built, else None."""
    if not native.available():
        return None
    return np.stack([native.eval_expand(k, prf_method) for k in keys])


class DPF(object):
    """Two-server DPF with server-side evaluation on an NVIDIA GPU."""

    PRF_DUMMY = PRF_DUMMY
    PRF_SALSA20 = PRF_SALSA20
    PRF_CHACHA20 = PRF_CHACHA20
    PRF_AES128 = PRF_AES128
    PRF_SALSA20_BLK = PRF_SALSA20_BLK
    PRF_CHACHA20_BLK = PRF_CHACHA20_BLK

    ENTRY_SIZE = 16       # int32 words per entry (reference parity)
    BATCH_SIZE = 512      # max keys per device dispatch (reference parity)
    MIN_ENTRIES = 128

    DEFAULT_PRF = PRF_AES128

    def __init__(self, prf=None, strict=True, config=None, scheme=None,
                 device=None):
        """config: optional ``utils.config.EvalConfig`` (``prf_method``,
        ``batch_size``, ``radix``, ``scheme``, ``row_chunk``).  scheme:
        ``"logn"`` or ``"sqrtn"``, overrides the config's.  device:
        where the server evaluates (None = CUDA)."""
        radix, sch = 2, "logn"
        self.row_chunk = None
        self._config = config
        if config is not None:
            if prf is None:
                prf = config.prf_method
            self.BATCH_SIZE = config.batch_size
            radix, sch = config.radix, config.scheme
            self.row_chunk = config.row_chunk
        if scheme is not None:
            sch = scheme
        _check_construction(sch, radix)
        self.scheme = sch
        self.radix = radix
        self.device = resolve_device(device)
        self.prf_method = self.DEFAULT_PRF if prf is None else prf
        if self.prf_method not in PRF_NAMES:
            raise ValueError("unknown PRF id %r" % (self.prf_method,))
        self.prf_method_string = PRF_NAMES[self.prf_method]
        self.strict = strict          # enforce reference shape limits
        self.table = None             # original table (numpy int32)
        self.table_device = None      # table on self.device: rows
        #                               bit- or digit-reversed (log-N),
        #                               natural order (sqrt-N)
        self.table_num_entries = None
        self.table_effective_entry_size = None
        self.buffers = None           # reference-API compat handle
        # dispatch mode's cooperative deadline (a time.monotonic()
        # value), checked between its launches; None = no deadline
        self.dispatch_deadline = None

    # ------------------------------------------------------------------ gen

    def _check_gen_domain(self, k: int, n: int) -> int:
        """Index in range, then the strict/auto-pad power-of-two policy.
        Returns the (possibly padded) domain."""
        if k >= n:
            raise ValueError(
                "k (%d), the selected element, must be less than n (%d), "
                "the number of entries in the table" % (k, n))
        if n & (n - 1) != 0:
            if self.strict:
                raise ValueError(
                    "Table num entries (%d) must be a power of two "
                    "(pass strict=False to auto-pad)" % n)
            n = u128.next_pow2(n)
        return n

    def gen(self, k, n, seed: bytes | None = None):
        """Generate the two servers' keys for secret index k in [0, n).

        With strict=False a non-power-of-two n is allowed: keys cover the
        next power-of-two domain, matching eval_init's zero padding.
        Returns two int32 CPU tensors: [524] for the log-N trees,
        [(4 + K + 2R) * 4] for sqrt-N.

        ``k`` may be a list (or 1-D array or tensor) of indices: then
        ``seed`` is the list of per-key seeds (or None) and the call is
        ``gen_batch``."""
        if isinstance(k, (list, tuple, np.ndarray, torch.Tensor)) and \
                np.ndim(k) >= 1:
            return self.gen_batch(k, n, seeds=seed)
        n = self._check_gen_domain(int(k), int(n))
        if seed is None:
            seed = os.urandom(128)
        if self.scheme == "sqrtn":
            make = sqrtn.generate_sqrt_keys
        elif self.radix == 4:
            make = radix4.generate_keys_r4
        else:
            wire = _native_gen(int(k), n, seed, self.prf_method)
            if wire is not None:
                return torch.from_numpy(wire[0]), torch.from_numpy(wire[1])
            make = keygen.generate_keys
        k0, k1 = make(int(k), n, seed, self.prf_method)
        return (torch.from_numpy(k0.serialize()),
                torch.from_numpy(k1.serialize()))

    def gen_batch(self, indices, n, seeds=None):
        """B keys over one domain ``n`` in a few vectorized host calls
        (``keygen.gen_batched`` or the native generator, ``radix4.
        gen_batched_r4``, ``sqrtn.gen_sqrt_batched``) instead of B calls
        of ``gen``.

        ``seeds``: a list of per-key DRBG seeds (None = a fresh
        ``os.urandom`` seed a key).  Returns two ``[B, words]`` int32 CPU
        tensors; row i equals ``gen(indices[i], n, seed=seeds[i])``.
        Each call is counted in the ``dpf_keygen_*`` metric series
        (``obs.metrics.observe_keygen``)."""
        indices = _to_numpy(indices).astype(np.int64).reshape(-1)
        n = self._check_gen_domain(
            int(indices.max()) if indices.size else 0, int(n))
        t0 = time.perf_counter()
        if self.scheme == "sqrtn":
            construction = "sqrtn.r2"
            wa, wb = sqrtn.gen_sqrt_batched(indices, n, seeds,
                                            prf_method=self.prf_method)
        elif self.radix == 4:
            construction = "logn.r4"
            wa, wb = radix4.gen_batched_r4(indices, n, seeds,
                                           prf_method=self.prf_method)
        else:
            construction = "logn.r2"
            wa, wb = gen_batched_binary(indices, n, seeds, self.prf_method)
        try:  # observability must never break keygen
            from .obs.metrics import observe_keygen
            observe_keygen(construction, indices.size,
                           time.perf_counter() - t0)
        except Exception as e:
            from .utils.profiling import note_swallowed
            note_swallowed("api.keygen_metrics", e)
        return wa, wb

    # ----------------------------------------------------------- eval_init

    def eval_init(self, table):
        """Upload a [N, E] integer table; the log-N trees pre-permute rows
        for BFS order (bit-reversed, or digit-reversed for radix 4), the
        sqrt-N grid takes them in natural order.

        With strict=False, non-power-of-two N is zero-padded to the next
        power of two (matching gen's domain rounding)."""
        tbl = _to_numpy(table, np.int32)
        if tbl.ndim != 2:
            raise ValueError("table must be 2D [entries, entry_size]")
        n, e = tbl.shape
        if n < self.MIN_ENTRIES:
            raise ValueError(
                "Table (%d) must have at least %d elements"
                % (n, self.MIN_ENTRIES))
        if n & (n - 1) != 0:
            if self.strict:
                raise ValueError(
                    "Table num entries (%d) must be a power of two "
                    "(pass strict=False to auto-pad)" % n)
            n_pad = u128.next_pow2(n)
            padded = np.zeros((n_pad, e), np.int32)
            padded[:n] = tbl
            tbl, n = padded, n_pad
        if self.strict and e > self.ENTRY_SIZE:
            raise ValueError(
                "Table entry dimension (%d) must be <= %d "
                "(pass strict=False to lift)" % (e, self.ENTRY_SIZE))
        self.table = np.ascontiguousarray(tbl)
        self.table_num_entries = n
        self.table_effective_entry_size = e
        if self.scheme == "sqrtn":
            permuted = self.table
        elif self.radix == 4:
            perm = radix4.mixed_reverse_indices(radix4.arities(n))
            permuted = np.ascontiguousarray(self.table[perm])
        else:
            permuted = expand.permute_table(self.table)
        self.table_device = torch.from_numpy(permuted).to(self.device)
        self.buffers = (self.table_device,)
        return self.buffers

    # ------------------------------------------------------------ eval_gpu

    def eval_gpu(self, keys) -> torch.Tensor:
        """Batched server evaluation on the device (the blocking loop).

        keys: a list of wire keys (tensors or arrays) or one [B, W]
        array.  Batches of at most ``BATCH_SIZE`` keys, each padded to a
        power of two by repeating its last key, each through
        ``_dispatch_packed`` (the serving engine's route).  Returns
        [len(keys), entry_size] int32 shares on the server's device."""
        if self.table_device is None:
            raise RuntimeError("Must call `eval_init` before `eval_gpu`")
        pk = self._decode_batch(keys)
        results = []
        for lo in range(0, pk.batch, self.BATCH_SIZE):
            part = pk.slice(lo, min(lo + self.BATCH_SIZE, pk.batch))
            staged = self._stage_packed(part, u128.next_pow2(part.batch))
            results.append(self._dispatch_packed(staged)[:part.batch])
        return torch.cat(results)[:, :self.table_effective_entry_size]

    # The JAX package's name for the same call.
    eval_tpu = eval_gpu

    def _decode(self, keys):
        """Wire keys -> packed batch of this server's construction
        (``keygen.PackedKeys`` or ``sqrtn.PackedSqrtKeys``): a key of
        another construction raises."""
        if self.scheme == "sqrtn":
            return sqrtn.decode_sqrt_keys_batched(keys)
        if self.radix == 4:
            return radix4.decode_mixed_keys_batched(keys)
        return keygen.decode_keys_batched(keys)

    def _decode_batch(self, keys):
        """Wire keys -> packed batch, validated against the table (the
        ingest shared with the serving engine)."""
        pk = self._decode(keys)
        n = self.table_num_entries
        if n is not None and pk.n != n:
            raise ValueError(
                "key generated for n=%d but table has n=%d" % (pk.n, n))
        return pk

    def _device_keys(self, pk: keygen.PackedKeys):
        return tuple(from_u32(a).to(self.device)
                     for a in (pk.cw1, pk.cw2, pk.last))

    # ------------------------------------------------ staged dispatch

    def _stage_packed(self, pk, size: int | None = None,
                      stage=None) -> "StagedKeys":
        """``stage_packed`` in this server's layout (host work only)."""
        return stage_packed(pk, size, stage, self.scheme == "sqrtn")

    def _dispatch_packed(self, pk) -> torch.Tensor:
        """Dispatch one packed batch (``keygen.PackedKeys``,
        ``sqrtn.PackedSqrtKeys`` or a ``StagedKeys`` from
        ``_stage_packed``) and return the ``[size, E]`` int32 shares on
        the device WITHOUT a host sync: on the card every copy and
        kernel is enqueued on the current stream, so the caller (the
        serving engine) packs the next batch while this one runs.  A
        packed batch is staged in a pageable buffer at its own size."""
        if self.table_device is None:
            raise RuntimeError("Must call `eval_init` before dispatch")
        staged = (pk if isinstance(pk, StagedKeys)
                  else self._stage_packed(pk))
        if self.scheme == "sqrtn":
            return self._dispatch_packed_sqrt(staged)
        if self.radix == 4:
            return self._dispatch_packed_r4(staged)
        cw1, cw2, last = _logn_planes(upload(staged, self.device), staged.size)
        n = self.table_num_entries
        depth = n.bit_length() - 1
        k = self.resolved_eval_knobs(staged.size)
        if k["kernel_impl"] == "dispatch":
            return expand.eval_dispatch(
                cw1, cw2, last, self.table_device, depth=depth,
                prf_method=self.prf_method, chunk_leaves=k["chunk_leaves"],
                group=k["dispatch_group"], deadline=self.dispatch_deadline)
        return expand.expand_and_contract(
            cw1, cw2, last, self.table_device, depth=depth,
            prf_method=self.prf_method, chunk_leaves=k["chunk_leaves"])

    def _dispatch_packed_r4(self, staged: "StagedKeys") -> torch.Tensor:
        """Radix-4 device dispatch, asynchronous like
        ``_dispatch_packed``."""
        cw1, cw2, last = _logn_planes(upload(staged, self.device), staged.size)
        k = self.resolved_eval_knobs(staged.size)
        if k["kernel_impl"] == "dispatch":
            return radix4.eval_dispatch_mixed(
                cw1, cw2, last, self.table_device,
                n=self.table_num_entries, prf_method=self.prf_method,
                chunk_leaves=k["chunk_leaves"], group=k["dispatch_group"],
                deadline=self.dispatch_deadline)
        return radix4.expand_and_contract_mixed(
            cw1, cw2, last, self.table_device, n=self.table_num_entries,
            prf_method=self.prf_method, chunk_leaves=k["chunk_leaves"])

    def _dispatch_packed_sqrt(self, staged: "StagedKeys") -> torch.Tensor:
        """Sqrt-N device dispatch: the staged rows go to the device, are
        padded there, and K4 reads seeds and codewords at the key
        stride.  An explicit ``row_chunk`` passes straight through (an
        invalid pin raises), else the scan's heuristic chunk is clamped
        to the batch's split and the kernel's cell cap."""
        pk = staged.pk
        seeds, cw1, cw2 = sqrtn.sqrt_key_views(
            upload(staged, self.device), pk.n_keys, pk.n_codewords,
            pad_to=staged.size)
        rc = self.row_chunk
        if rc is None:
            rc = sqrtn.clamp_row_chunk(None, pk.n_codewords, pk.n_keys,
                                       staged.size)
        return sqrtn.eval_contract_batched(
            seeds, cw1, cw2, self.table_device, prf_method=self.prf_method,
            row_chunk=rc)

    def resolved_eval_knobs(self, batch: int) -> dict:
        """Program knobs for one dispatch batch size: the heuristic branch
        of ``dpf_tpu``'s resolution (the tuning cache is not ported
        yet).  ``kernel_impl`` is the config's (``"xla"`` by default);
        ``"xla"``, ``"pallas"`` and the auto state take the fused
        kernels (``kernel_impl: "fused"``): the stream ciphers the subtree
        kernel's block of at most 4096 leaves, AES and DUMMY the 64 MiB
        live-seed chunk (``expand.choose_chunk``).  ``"dispatch"`` takes
        the per-level mode with the live-seed chunk for every PRF and
        its ``dispatch_group`` (``kernel_resolved_from: "config"``).  For radix 4 the chunk is rounded down to a
        product of trailing arities (``radix4._suffix_chunk``) and the
        kernels are the radix-4 ones: K2 ``subtree_contract_mixed``, K1
        at arity 4.  ``kernel`` names the kernel that expands the
        levels."""
        n = self.table_num_entries
        if n is None:
            raise RuntimeError("Must call `eval_init` before resolving")
        if self.scheme == "sqrtn":
            return self._resolved_sqrt_knobs(n, batch)
        cfg = self._config
        dispatch = cfg is not None and cfg.kernel_impl == "dispatch"
        group = cfg.dispatch_group if dispatch else None
        if self.prf_method in expand.SUBTREE_PRFS and not dispatch:
            from .ops.subtree import subtree_chunk_leaves
            chunk, kernel = subtree_chunk_leaves(n), "subtree_contract"
        else:
            chunk = expand.clamp_chunk(None, n, batch)
            kernel = {PRF_AES128: "aes_level_step",
                      PRF_CHACHA20: "chacha_level_step"}.get(
                          self.prf_method, "plain_level_step")
        if self.radix == 4:
            chunk = radix4._suffix_chunk(radix4.arities(n), chunk)[1]
            kernel = {"subtree_contract": "subtree_contract_mixed",
                      "aes_level_step": "aes_level_step_a4",
                      "chacha_level_step": "plain_level_step"}.get(kernel,
                                                                   kernel)
        return {"chunk_leaves": chunk, "kernel": kernel,
                "kernel_impl": "dispatch" if dispatch else "fused",
                "dispatch_group": group,
                "kernel_resolved_from": "config" if dispatch
                else "heuristic"}

    def _resolved_sqrt_knobs(self, n: int, batch: int) -> dict:
        """The sqrt-N branch: every PRF id goes to K4.  ``row_chunk`` is
        the config's pin or None (resolved per batch from the keys'
        split); ``row_chunk_effective`` is the K4 grid step the
        default split gets at this batch size."""
        from .ops.sqrt_grid import sqrt_row_chunk
        k, r = sqrtn.default_split(n)
        rc = self.row_chunk
        eff = sqrt_row_chunk(r, k, rc if rc is not None else
                             sqrtn.clamp_row_chunk(None, r, k, batch))
        return {"row_chunk": rc, "row_chunk_effective": eff,
                "kernel": "sqrt_grid_contract", "kernel_impl": "fused",
                "kernel_resolved_from": "heuristic"}

    # ------------------------------------------------- one-hot and points

    def eval_one_hot(self, keys) -> torch.Tensor:
        """Full one-hot expansion: [len(keys), N] int32 shares in natural
        index order, on the server's device.  Memory O(batch x N)."""
        if self.scheme == "sqrtn":
            return torch.stack([sqrtn.eval_grid(k, self.prf_method,
                                                self.device)
                                for k in self._sqrt_batch(keys)])
        pk = self._decode(keys)
        cw1, cw2, last = self._device_keys(pk)
        if self.radix == 4:
            return radix4.expand_leaves_mixed(cw1, cw2, last, n=pk.n,
                                              prf_method=self.prf_method)
        return expand.expand_leaves(cw1, cw2, last, depth=pk.depth,
                                    prf_method=self.prf_method)

    def eval_points(self, keys, indices) -> torch.Tensor:
        """Sparse evaluation: each key at the given indices only.
        Returns [len(keys), len(indices)] int32 one-hot shares."""
        idx = _to_numpy(indices).astype(np.int64)
        if self.scheme == "sqrtn":
            sk = self._sqrt_batch(keys)
            if idx.ndim != 1 or (idx >= sk[0].n).any() or (idx < 0).any():
                raise ValueError("indices must be 1D and < n=%d" % sk[0].n)
            return sqrtn.eval_points_sqrt(sk, idx, self.prf_method,
                                          self.device)
        pk = self._decode(keys)
        if idx.ndim != 1 or (idx >= pk.n).any() or (idx < 0).any():
            raise ValueError("indices must be 1D and < n=%d" % pk.n)
        cw1, cw2, last = self._device_keys(pk)
        if self.radix == 4:
            return radix4.eval_points_mixed(cw1, cw2, last,
                                            torch.from_numpy(idx), n=pk.n,
                                            prf_method=self.prf_method)
        return expand.eval_points(cw1, cw2, last, torch.from_numpy(idx),
                                  depth=pk.depth, prf_method=self.prf_method)

    # ------------------------------------------------------------ eval_cpu

    def eval_cpu(self, keys, one_hot_only=False) -> torch.Tensor:
        """Host reference evaluation (plain PyTorch on the CPU: one key at
        a time for the binary tree and the sqrt-N grid, the whole batch
        through the plain level steps for radix 4), whatever the server's
        device.  Returns CPU tensors."""
        if self.scheme == "sqrtn":
            hots = np.stack([sqrtn.eval_grid(k, self.prf_method).numpy()
                             for k in self._sqrt_batch(keys)])
        elif self.radix == 4:
            pk = radix4.decode_mixed_keys_batched(keys)
            hots = radix4.expand_leaves_mixed(
                *(from_u32(a) for a in (pk.cw1, pk.cw2, pk.last)), n=pk.n,
                prf_method=self.prf_method).numpy()
        else:
            hots = self._binary_one_hots(keys)       # [B, N] int32
        if one_hot_only:
            return torch.from_numpy(hots)
        if self.table is None:
            raise RuntimeError(
                "Must call `eval_init` before `eval_cpu` with "
                "one_hot_only=False")
        # exact wrapping mod-2^32 product on the host
        prod = hots.view(np.uint32) @ self.table.view(np.uint32)
        return torch.from_numpy(prod.view(np.int32))

    def _binary_one_hots(self, keys) -> np.ndarray:
        """Binary keys' one-hot shares: ``native.eval_expand`` when it is
        built, else the plain reference; a radix-4 key raises first (the
        native codec would misread its layout)."""
        wire = keygen.stack_wire_keys(keys)
        if (wire.view(np.uint32)[:, 1] == 4).any():
            raise ValueError("mixed-radix key: serve radix-4 keys with "
                             "DPF(config=EvalConfig(radix=4))")
        hots = _native_expand_batch(wire, self.prf_method)
        if hots is None:
            hots = np.stack([evalref.eval_one_hot_i32(
                keygen.deserialize_key(k), self.prf_method) for k in wire])
        return hots

    def _sqrt_batch(self, keys) -> list:
        """Deserialize a sqrt-N key batch and check its split is
        uniform."""
        if not len(keys):
            raise ValueError("empty key batch")
        sk = [sqrtn.deserialize_sqrt_key(k) for k in keys]
        for k in sk:
            if (k.n, k.n_keys) != (sk[0].n, sk[0].n_keys):
                raise ValueError("keys for mixed sqrt-N splits")
        return sk

    # ------------------------------------------------------- serving_engine

    def serving_engine(self, **kwargs):
        """A ``serve.ServingEngine`` over this DPF's initialized table:
        vectorized key ingest, bucketed batches, double-buffered dispatch
        on CUDA events with pinned key staging.  kwargs forward to
        ``ServingEngine`` (``max_in_flight``, ``buckets``, ``warmup``,
        ...).  Requires a prior ``eval_init``."""
        from .serve import ServingEngine
        return ServingEngine(self, **kwargs)

    # ------------------------------------------------------------ eval_free

    def eval_free(self, buffers=None):
        self.table_device = None
        self.buffers = None

    def __repr__(self):
        if self.table_device is None:
            return ("DPF(_uninitialized_, prf_method=%s, scheme=%s, "
                    "device=%s)" % (self.prf_method_string, self.scheme,
                                    self.device))
        return ("DPF(entries=%d, entry_size=%d, prf_method=%s, scheme=%s, "
                "radix=%d, device=%s)" % (self.table_num_entries,
                                          self.table_effective_entry_size,
                                          self.prf_method_string,
                                          self.scheme, self.radix,
                                          self.device))
