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

Knobs left at their auto state resolve per dispatch batch size in
``resolved_eval_knobs``: explicit config > a searched kernel variant
(``tune/kernel_search.py``) > the tuning cache (``tune/cache.py``) >
the heuristics, keyed by the server's device fingerprint and memoized
per batch size until the next ``eval_init``.  ``scheme="auto"`` resolves
at first use from the cache's scheme winner, else the binary tree
(``tune/search.heuristic_scheme``), so a cold cache never changes the
wire format.  ``gen_batch`` takes the searched keygen knobs.
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
from .utils.config import check_construction, is_auto, is_auto_kernel


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
    if scheme == "auto" and radix == 4:
        raise ValueError(
            "scheme='auto' resolves the whole construction (scheme AND "
            "radix) from the tuning cache; leave radix at 2")


#: a tuning record's kernel_impl -> the port's route (records written by
#: ``dpf_tpu`` spell the fused route "xla" or "pallas")
_ROUTE = {"xla": "fused", "pallas": "fused", "fused": "fused",
          "dispatch": "dispatch"}


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
                 device=None, entry_size=None):
        """config: optional ``utils.config.EvalConfig``.  scheme:
        ``"logn"``, ``"sqrtn"`` or ``"auto"`` (resolved at the first
        ``gen`` or ``eval_init``: the tuning cache's scheme winner for
        this shape, else the binary tree; ``scheme_resolved_from`` says
        which), overrides the config's.  device: where the server
        evaluates (None = CUDA).  entry_size: the table width a
        keygen-only ``scheme="auto"`` instance resolves with (a server
        uses its table's)."""
        radix, sch = 2, "logn"
        self.row_chunk = None
        self._config = config
        # the plain AES's formulation on the CPU (``_plain_aes_impl``)
        self.aes_impl = "auto" if config is None else config.aes_impl
        if config is not None:
            if prf is None:
                prf = config.prf_method
            self.BATCH_SIZE = config.batch_size
            radix, sch = config.radix, config.scheme
            self.row_chunk = config.row_chunk
        if scheme is not None:
            sch = scheme
        _check_construction(sch, radix)
        if entry_size is not None and sch != "auto":
            raise ValueError(
                "entry_size only parameterizes scheme='auto' resolution "
                "(the table's own width governs everything else)")
        self._auto_entry_size = entry_size
        self.scheme_resolved_from = None  # "cache"/"heuristic" once auto
        self.scheme = sch
        self.radix = radix
        self.device = resolve_device(device)
        self._tuned_cache = {}        # batch -> tuning-cache knob dict
        self._keygen_knobs_cache = {}  # (n, pow2 batch) -> knobs or None
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

    def _ensure_scheme(self, n: int, entry_size: int | None = None):
        """Resolve ``scheme="auto"`` for domain ``n``: the tuning cache's
        scheme winner for this shape on this device (``tune.cache.
        lookup_scheme``), else ``tune.search.heuristic_scheme``.  Sticky:
        the first use pins the construction."""
        if self.scheme != "auto":
            return
        from .tune.cache import lookup_scheme
        rec = lookup_scheme(
            n=n, entry_size=(entry_size or self._auto_entry_size
                             or self.ENTRY_SIZE),
            batch=self.BATCH_SIZE, prf_method=self.prf_method,
            device=self.device)
        if rec and rec.get("scheme") in ("logn", "sqrtn"):
            self.scheme_resolved_from = "cache"
        else:
            from .tune.search import heuristic_scheme
            rec = heuristic_scheme(n)
            self.scheme_resolved_from = "heuristic"
        self.scheme = rec["scheme"]
        self.radix = int(rec.get("radix") or 2)

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
        self._ensure_scheme(n)
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
        (``obs.metrics.observe_keygen``).  The searched keygen knobs
        for this shape (``_resolved_keygen_knobs``) reach the vectorized
        generators; they change no byte."""
        indices = _to_numpy(indices).astype(np.int64).reshape(-1)
        n = self._check_gen_domain(
            int(indices.max()) if indices.size else 0, int(n))
        self._ensure_scheme(n)
        knobs = self._resolved_keygen_knobs(n, indices.size)
        t0 = time.perf_counter()
        if self.scheme == "sqrtn":
            construction = "sqrtn.r2"
            wa, wb = sqrtn.gen_sqrt_batched(indices, n, seeds,
                                            prf_method=self.prf_method,
                                            knobs=knobs)
        elif self.radix == 4:
            construction = "logn.r4"
            wa, wb = radix4.gen_batched_r4(indices, n, seeds,
                                           prf_method=self.prf_method,
                                           knobs=knobs)
        else:
            construction = "logn.r2"
            wa, wb = gen_batched_binary(indices, n, seeds, self.prf_method,
                                        knobs=knobs)
        try:  # observability must never break keygen
            from .obs.metrics import observe_keygen
            observe_keygen(construction, indices.size,
                           time.perf_counter() - t0)
        except Exception as e:
            from .utils.profiling import note_swallowed
            note_swallowed("api.keygen_metrics", e)
        return wa, wb

    def _resolved_keygen_knobs(self, n: int, batch: int) -> dict | None:
        """Searched batched-keygen knobs for this (scheme, radix, n,
        batch), or None (the baseline): the ``kvariant`` keygen entry
        (``lookup_keygen_variant``), memoized per (n, pow2 batch) and
        taken only from a keygen-family variant."""
        key = (n, u128.next_pow2(max(1, batch)))
        memo = self._keygen_knobs_cache
        if key not in memo:
            from .tune.cache import lookup_keygen_variant
            rec = lookup_keygen_variant(
                n=n, batch=key[1], prf_method=self.prf_method,
                scheme=self.scheme, radix=self.radix,
                device=self.device) or {}
            fam = (rec.get("kernel_variant") or {}).get("family")
            kk = rec.get("keygen_knobs")
            memo[key] = dict(kk) if (kk and fam == "keygen") else None
        return memo[key]

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
        self._ensure_scheme(n, e)
        self.table = np.ascontiguousarray(tbl)
        self.table_num_entries = n
        self.table_effective_entry_size = e
        self._tuned_cache = {}  # the shape changed: resolve again
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

    def _plain_aes_impl(self) -> str | None:
        """The config's ``aes_impl`` on a CPU server; None on the card,
        where the AES levels run K1 and point walks take the gather
        form whatever the config says."""
        return self.aes_impl if self.device.type == "cpu" else None

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
                group=k["dispatch_group"], deadline=self.dispatch_deadline,
                aes_impl=self._plain_aes_impl(), dot_impl=k["dot_impl"])
        return expand.expand_and_contract(
            cw1, cw2, last, self.table_device, depth=depth,
            prf_method=self.prf_method, chunk_leaves=k["chunk_leaves"],
            aes_impl=self._plain_aes_impl(), f_levels=k.get("f_levels"),
            dot_impl=k["dot_impl"])

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
                deadline=self.dispatch_deadline,
                aes_impl=self._plain_aes_impl(), dot_impl=k["dot_impl"])
        return radix4.expand_and_contract_mixed(
            cw1, cw2, last, self.table_device, n=self.table_num_entries,
            prf_method=self.prf_method, chunk_leaves=k["chunk_leaves"],
            aes_impl=self._plain_aes_impl(), dot_impl=k["dot_impl"])

    def _dispatch_packed_sqrt(self, staged: "StagedKeys") -> torch.Tensor:
        """Sqrt-N device dispatch: the staged rows go to the device, are
        padded there, and K4 reads seeds and codewords at the key
        stride.  A tuned or searched K4 grid step runs as given
        (``grid_rows``); an explicit ``row_chunk`` passes straight
        through (an invalid pin raises); else the scan's heuristic chunk
        is clamped to the batch's split and the kernel's cell cap."""
        pk = staged.pk
        seeds, cw1, cw2 = sqrtn.sqrt_key_views(
            upload(staged, self.device), pk.n_keys, pk.n_codewords,
            pad_to=staged.size)
        k = self.resolved_eval_knobs(staged.size)
        rc, grid_rows = self.row_chunk, k.get("grid_rows")
        if grid_rows is not None and \
                pk.n_keys != sqrtn.default_split(pk.n)[0]:
            grid_rows = None      # tuned for the default split only
        if grid_rows is None and rc is None:
            rc = sqrtn.clamp_row_chunk(None, pk.n_codewords, pk.n_keys,
                                       staged.size)
        return sqrtn.eval_contract_batched(
            seeds, cw1, cw2, self.table_device, prf_method=self.prf_method,
            row_chunk=rc, grid_rows=grid_rows)

    def _lookup_tuned(self, batch: int) -> dict:
        """The tuning cache's knobs for this shape and batch size on this
        server's device (``lookup_eval_knobs``, nearest batch), with the
        searched kernel variant of the same shape under ``_searched``;
        {} when every knob the construction reads is pinned."""
        cfg = self._config
        if cfg is not None:
            fields = ((cfg.row_chunk,) if self.scheme == "sqrtn" else
                      (cfg.chunk_leaves, cfg.dot_impl, cfg.dispatch_group))
            if not (any(is_auto(v) for v in fields)
                    or is_auto_kernel(cfg.kernel_impl)):
                return {}
        from .tune.cache import lookup_eval_knobs, lookup_kernel_variant
        shape = dict(n=self.table_num_entries,
                     entry_size=self.table_effective_entry_size,
                     batch=batch, prf_method=self.prf_method,
                     scheme=self.scheme, radix=self.radix,
                     device=self.device)
        tuned = dict(lookup_eval_knobs(**shape) or {})
        searched = lookup_kernel_variant(**shape)
        if searched:
            tuned["_searched"] = searched
        return tuned

    def resolved_eval_knobs(self, batch: int) -> dict:
        """Program knobs for one dispatch batch size (port of
        ``dpf_tpu``'s resolution, with the card's routes).

        Per knob: an explicit ``EvalConfig`` field wins; a knob at its
        auto state takes a searched kernel variant's value (a
        ``kvariant`` entry of ``tune/kernel_search.py`` of this
        construction's family), else the tuning cache's (``tune/
        cache.py``: this device's fingerprint x (N, E, B, prf, scheme,
        radix), nearest-batch fallback), else the heuristic.  The lookup
        is memoized per batch size in ``_tuned_cache`` (cleared by
        ``eval_init``), which is also where a tuner pins the knobs it
        measures.  ``kernel_resolved_from``
        (``config``, ``searched``, ``tuned`` or ``heuristic``) is the
        provenance of the route.

        Routes: ``kernel_impl: "fused"`` (the default) takes for the
        stream ciphers K2 once, ``chunk_leaves`` its block subtree
        (``subtree_chunk_leaves``: at most 4096 leaves), and for AES and
        DUMMY one launch a level (K1 or the plain step) and K3 a group,
        ``chunk_leaves`` the 64 MiB live-seed chunk
        (``expand.choose_chunk``); ``"dispatch"`` the per-level mode
        with the live-seed chunk for every PRF and its
        ``dispatch_group``.  For radix 4 the chunk is rounded down to a
        product of trailing arities (``radix4._suffix_chunk``) and the
        kernels are the radix-4 ones.  An explicit or tuned chunk the
        route cannot take as asked is clamped and surfaced
        (``chunk_leaves_effective``, counted at
        ``api.chunk_leaves_clamped``); a K2 block that is not a power of
        two raises ``ValueError``.  ``dot_impl`` is the per-level routes'
        contraction; ``f_levels`` (a searched variant's, binary tree)
        the frontier the route starts from.  ``kernel`` names the
        kernel that expands the levels."""
        n = self.table_num_entries
        if n is None:
            raise RuntimeError("Must call `eval_init` before resolving")
        tuned = self._tuned_cache.get(batch)
        if tuned is None:
            tuned = self._tuned_cache[batch] = self._lookup_tuned(batch)
        if self.scheme == "sqrtn":
            return self._resolved_sqrt_knobs(n, batch, tuned)
        return self._resolved_logn_knobs(n, batch, tuned)

    def _resolved_logn_knobs(self, n: int, batch: int, tuned: dict) -> dict:
        """The GGM trees' branch of ``resolved_eval_knobs``."""
        from .ops import matmul128
        from .ops.subtree import subtree_chunk_leaves

        cfg = self._config
        dflt = matmul128.default_impl()

        def explicit(field):
            v = getattr(cfg, field) if cfg is not None else None
            return None if is_auto(v) else v

        searched = tuned.get("_searched") or {}
        variant = searched.get("kernel_variant") or {}
        if variant.get("family") != "ggm":
            searched, variant = {}, {}
        if cfg is not None and not is_auto_kernel(cfg.kernel_impl):
            impl, impl_from = cfg.kernel_impl, "config"
        elif searched.get("kernel_impl") in _ROUTE:
            impl, impl_from = _ROUTE[searched["kernel_impl"]], "searched"
        elif tuned.get("kernel_impl") in _ROUTE:
            impl, impl_from = _ROUTE[tuned["kernel_impl"]], "tuned"
        else:
            impl, impl_from = "fused", "heuristic"
        if impl_from != "searched":
            searched, variant = {}, {}
        k2 = self.prf_method in expand.SUBTREE_PRFS and impl == "fused"
        chunk_req = chunk_from = None
        if explicit("chunk_leaves"):
            chunk_req, chunk_from = int(cfg.chunk_leaves), "config"
        elif searched.get("chunk_leaves"):
            chunk_req, chunk_from = int(searched["chunk_leaves"]), "searched"
        elif tuned.get("chunk_leaves") and _ROUTE.get(
                tuned.get("kernel_impl", "fused")) == impl:
            # a tuned chunk rides only with the route it was timed on
            chunk_req, chunk_from = int(tuned["chunk_leaves"]), "tuned"
        if k2:
            top = subtree_chunk_leaves(n)
            if chunk_req is not None and (chunk_req < 1
                                          or chunk_req & (chunk_req - 1)):
                raise ValueError("chunk_leaves (%d) of K2 must be a power "
                                 "of two" % chunk_req)
            chunk = top if chunk_req is None else min(chunk_req, top)
        elif chunk_req is None:
            chunk = expand.clamp_chunk(None, n, batch)
        elif chunk_from == "config":
            chunk = min(chunk_req, n)
        else:
            chunk = expand.clamp_chunk(chunk_req, n, batch)
        if self.radix == 4:
            chunk = radix4._suffix_chunk(radix4.arities(n), chunk)[1]
        clamped = chunk_req is not None and chunk != chunk_req
        if clamped:
            from .utils.profiling import note_swallowed
            note_swallowed("api.chunk_leaves_clamped", RuntimeError(
                "requested chunk_leaves %d (from %s) clamped to %d by the "
                "route's limit" % (chunk_req, chunk_from, chunk)))
        f_levels = searched.get("f_levels")
        if f_levels is not None:
            base = n.bit_length() - chunk.bit_length()
            ok = (0 <= int(f_levels) <= base if k2
                  else base <= int(f_levels) <= n.bit_length() - 1)
            if self.radix != 2 or impl != "fused" or not ok:
                f_levels = None
        if impl_from == "searched" and explicit("dot_impl") is None:
            dot = searched.get("dot_impl") or dflt
        else:
            dot = explicit("dot_impl") or tuned.get("dot_impl") or dflt
        if impl == "dispatch":
            group = explicit("dispatch_group")
            if group is None:
                group = (searched.get("dispatch_group")
                         if impl_from == "searched"
                         else tuned.get("dispatch_group"))
        else:
            group = None
        if k2:
            kernel = "subtree_contract"
        else:
            kernel = {PRF_AES128: "aes_level_step",
                      PRF_CHACHA20: "chacha_level_step"}.get(
                          self.prf_method, "plain_level_step")
        if self.radix == 4:
            kernel = {"subtree_contract": "subtree_contract_mixed",
                      "aes_level_step": "aes_level_step_a4",
                      "chacha_level_step": "plain_level_step"}.get(kernel,
                                                                   kernel)
        out = {"chunk_leaves": chunk, "kernel": kernel, "kernel_impl": impl,
               "dispatch_group": group, "kernel_resolved_from": impl_from,
               "dot_impl": dot}
        if f_levels is not None:
            out["f_levels"] = int(f_levels)
        if variant:
            out["kernel_variant"] = variant
        if clamped:
            out["chunk_leaves_effective"] = chunk
        unroll = (cfg.round_unroll if cfg is not None
                  and cfg.round_unroll is not None
                  else tuned.get("round_unroll"))
        if unroll is not None:
            out["round_unroll"] = unroll   # recorded; moves no path
        return out

    def _resolved_sqrt_knobs(self, n: int, batch: int, tuned: dict) -> dict:
        """The sqrt-N branch: every PRF id goes to K4.  ``row_chunk`` is
        the config's pin (K4's step is it halved to the cell cap) or None;
        with no pin a searched variant's or the tuning cache's K4 grid
        step comes back as ``grid_rows`` (run as given), else the step
        is resolved per batch from the keys' split.
        ``row_chunk_effective`` is the K4 grid step the default split
        gets at this batch size."""
        from .ops.sqrt_grid import heuristic_grid_rows, sqrt_row_chunk
        cfg = self._config
        k, r = sqrtn.default_split(n)
        searched = tuned.get("_searched") or {}
        if (searched.get("kernel_variant") or {}).get("family") not in (
                "xla", "pallas"):
            searched = {}
        rc, grid_rows = self.row_chunk, None
        if rc is not None:
            eff = sqrt_row_chunk(r, k, rc)
        else:
            grid_rows = searched.get("row_chunk") or tuned.get("row_chunk")
            eff = (int(grid_rows) if grid_rows
                   else heuristic_grid_rows(r, k, batch))
        if cfg is not None and not is_auto_kernel(cfg.kernel_impl):
            impl_from = "config"
        elif searched.get("row_chunk") or searched.get("kernel_impl"):
            impl_from = "searched"
        elif tuned.get("row_chunk") or tuned.get("kernel_impl"):
            impl_from = "tuned"
        else:
            impl_from = "heuristic"
        out = {"row_chunk": rc, "row_chunk_effective": eff,
               "kernel": "sqrt_grid_contract", "kernel_impl": "fused",
               "kernel_resolved_from": impl_from}
        if grid_rows:
            out["grid_rows"] = int(grid_rows)   # K4's step, run as given
        if impl_from == "searched":
            out["kernel_variant"] = searched["kernel_variant"]
        return out

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
            return radix4.expand_leaves_mixed(
                cw1, cw2, last, n=pk.n, prf_method=self.prf_method,
                aes_impl=self._plain_aes_impl())
        return expand.expand_leaves(cw1, cw2, last, depth=pk.depth,
                                    prf_method=self.prf_method,
                                    aes_impl=self._plain_aes_impl())

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
            return radix4.eval_points_mixed(
                cw1, cw2, last, torch.from_numpy(idx), n=pk.n,
                prf_method=self.prf_method, aes_impl=self._plain_aes_impl())
        return expand.eval_points(cw1, cw2, last, torch.from_numpy(idx),
                                  depth=pk.depth, prf_method=self.prf_method,
                                  aes_impl=self._plain_aes_impl())

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

    def sharded_server(self, mesh=None, **kwargs):
        """A ``parallel.sharded.ShardedDPFServer`` over this DPF's table
        with its construction, PRF and batch cap.  Requires a prior
        ``eval_init`` (which resolves ``scheme="auto"``, so keys already
        minted stay servable).  ``mesh``: a ``parallel.sharded.
        make_mesh`` mesh (None = one over every visible card); kwargs
        forward to ``ShardedDPFServer`` (the explicit pins
        ``chunk_leaves``, ``row_chunk``, ``psum_group``, ``dot_impl``)."""
        if self.table is None:
            raise RuntimeError(
                "Must call `eval_init` before `sharded_server`")
        from .parallel.sharded import ShardedDPFServer
        return ShardedDPFServer(
            self.table, mesh, prf_method=self.prf_method,
            batch_size=self.BATCH_SIZE, radix=self.radix,
            scheme=self.scheme, **kwargs)

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
