"""Pipelined serving engine: keep the card busy under a stream of query
batches.

Port of ``dpf_tpu/serve/engine.py``.  The blocking loop (``DPF.eval_gpu``
and a copy to the host per batch) serializes host and device: decode,
pack, upload, launch, then wait.  The engine splits that pipeline:

* **Vectorized ingest**: a batch decodes through the batched wire codec
  (``DPF._decode_batch``) in O(1) Python operations.
* **Double-buffered dispatch on CUDA events**: ``submit()`` enqueues a
  batch's key upload, kernels and result download on the current stream
  and returns a future; the host packs batch k+1 while batch k runs.
  Each dispatched part records one ``torch.cuda.Event`` after its
  result's download, and a part is resolved by waiting on its own event,
  never by a device-wide synchronise.  ``max_in_flight`` bounds the
  window: when it is full, ``submit`` first resolves the oldest part
  (backpressure).
* **Pinned staging**: keys are laid out in pinned host buffers, one per
  window slot plus one (``PinnedStage``), and uploaded with
  ``non_blocking=True``; a slot is filled again only after the event of
  the copy that read it has passed.  A pageable upload would make the
  host wait for every kernel queued before it, so a window of 2 would
  serialize like the blocking loop.  Results come back into pinned
  memory ordered by the part's event.
* **Shape-bucketed batching**: ragged batches pad up to a small ladder
  of power-of-two buckets (``serve/buckets.py``); ``warmup()`` builds
  the kernels (``ops/cuda_build.build``) and runs one dispatch a bucket.

Every copy and kernel runs on the current stream, so the caching
allocator's stream-ordered reuse of the intermediate tensors is safe.
The engine takes any server with ``_decode_batch(keys)``,
``_stage_packed(pk, size, stage)`` and ``_dispatch_packed(staged)``
(``api.DPF`` in its three constructions).  Results are bit-identical to
the blocking loop: pad rows are discarded and each key's shares do not
depend on the batch around it.  On a CPU server (``device="cpu"``)
dispatch computes synchronously and there are no events to wait on.
"""

from __future__ import annotations

import time
from collections import deque

import numpy as np
import torch

from ..core.expand import DeadlineExceeded
from ..obs.flight import FLIGHT
from ..obs.tracer import span
from ..utils.profiling import EngineCounters, note_swallowed
from .buckets import Buckets


class LoadShed(RuntimeError):
    """Admission control rejected a batch instead of queueing it
    (``shed=True`` and the pending queue at ``max_queue_depth``, or the
    p99 latency over ``slo_s`` while a backlog exists).  Nothing was
    dispatched."""


class EngineClosed(RuntimeError):
    """The engine was decommissioned (``ServingEngine.close``): every
    later ``submit`` is rejected.  Unlike ``LoadShed`` it never heals."""


class PinnedStage:
    """One pinned host buffer for key uploads and the event of the last
    copy that read it.  ``buffer(words)`` waits for that event (and only
    it) before handing the buffer out again, growing it when needed;
    ``record_copy()`` is called by the server right after it enqueues
    the upload."""
    __slots__ = ("host", "copied")

    def __init__(self):
        self.host = None       # pinned int32 tensor
        self.copied = None     # torch.cuda.Event after the last upload

    def buffer(self, words: int) -> torch.Tensor:
        if self.copied is not None:
            self.copied.synchronize()
            self.copied = None
        if self.host is None or self.host.numel() < words:
            self.host = torch.empty(words, dtype=torch.int32,
                                    pin_memory=True)
        return self.host[:words]

    def record_copy(self) -> None:
        self.copied = torch.cuda.Event()
        self.copied.record()


class _Part:
    """One dispatched (bucket-padded) chunk of a submitted batch."""
    __slots__ = ("host", "event", "n_real", "bucket", "out")

    def __init__(self, host, event, n_real, bucket):
        self.host = host        # [bucket, E] result, pinned on the card
        self.event = event      # recorded after its download; None = CPU
        self.n_real = n_real    # rows that are real queries (not pad)
        self.bucket = bucket    # padded dispatch size (fault targeting)
        self.out = None         # resolved host rows


class EngineFuture:
    """Result handle for one submitted batch.  ``result()`` resolves this
    batch, and FIFO every batch submitted before it, and returns the
    ``[batch, entry_size]`` int32 share array."""
    __slots__ = ("_engine", "_parts", "_value", "_t0")

    def __init__(self, engine):
        self._engine = engine
        self._parts = []
        self._value = None
        self._t0 = None     # submit-entry perf_counter (latency ring)

    def done(self) -> bool:
        return self._value is not None

    def result(self):
        if self._value is None:
            self._engine._resolve_through(self)
        return self._value


class ServingEngine:
    """Throughput-oriented DPF serving over one prepared table.

    Args (as ``dpf_tpu``'s):
      server: an ``api.DPF`` after ``eval_init``.
      max_in_flight: dispatched parts outstanding before ``submit``
        applies backpressure (2 is double buffering).
      buckets: a ``Buckets``, an iterable of power-of-two sizes, or None
        for the default /2 ladder under the server's batch cap.
      warmup: build the kernels and run every bucket at construction.
      max_queue_depth / slo_s / shed: admission control (pending futures
        bound; p99 over ``slo_s`` with a backlog; reject with
        ``LoadShed`` instead of blocking).
      deadline / timeout_s: a ``time.monotonic()`` deadline (absolute,
        or relative to now), checked between dispatches and resolutions;
        a trip raises ``DeadlineExceeded`` and counts in
        ``stats.deadline_misses``, as does one raised by the server's
        dispatch mode (``DPF.dispatch_deadline``).
      label: construction label for fault targeting and the router.
      injector: a ``faults.FaultInjector`` consulted before each
        dispatch, on each resolved result and before each warmup run.
    """

    def __init__(self, server, *, max_in_flight: int = 2, buckets=None,
                 warmup: bool = False, deadline: float | None = None,
                 timeout_s: float | None = None,
                 max_queue_depth: int | None = None,
                 slo_s: float | None = None, shed: bool = False,
                 label: str | None = None, injector=None,
                 tenant: str | None = None):
        if max_in_flight < 1:
            raise ValueError("max_in_flight must be >= 1 (got %d)"
                             % max_in_flight)
        if deadline is not None and timeout_s is not None:
            raise ValueError(
                "pass deadline (absolute time.monotonic()) or timeout_s "
                "(relative), not both")
        if timeout_s is not None:
            deadline = time.monotonic() + timeout_s
        if max_queue_depth is not None and max_queue_depth < 1:
            raise ValueError("max_queue_depth must be >= 1 (got %d)"
                             % max_queue_depth)
        n = getattr(server, "table_num_entries", None)
        if n is None:
            raise RuntimeError(
                "server has no initialized table — call eval_init first")
        self._server = server
        self._n = int(n)
        self._out_width = server.table_effective_entry_size
        self._cuda = server.device.type == "cuda"
        self.max_in_flight = int(max_in_flight)
        if not isinstance(buckets, Buckets):
            buckets = Buckets(buckets if buckets is not None
                              else Buckets.default_sizes(server.BATCH_SIZE))
        self.buckets = buckets
        self.deadline = deadline
        self.max_queue_depth = max_queue_depth
        self.slo_s = slo_s
        self.shed = bool(shed)
        self.label = label
        self.tenant = tenant
        self._injector = injector
        self.stats = EngineCounters()
        self._closed = False
        self._queue = deque()     # _Part refs, dispatch order, unresolved
        self._pending = deque()   # futures with unresolved parts, FIFO
        self._stages = []         # PinnedStage ring (CUDA servers)
        self._next_stage = 0
        try:
            from ..obs.metrics import register_engine
            register_engine(self)
        except Exception as e:  # observability must never break serving
            note_swallowed("serve.engine.register_metrics", e, self.stats)
        if warmup:
            self.warmup()

    # ------------------------------------------------------- staging

    def _stage(self, pk, size: int):
        """Lay ``pk`` out for a ``size``-row dispatch: in the next pinned
        slot on the card (``max_in_flight + 1`` of them), in a fresh
        buffer on the CPU."""
        stage = None
        if self._cuda:
            if not self._stages:
                self._stages = [PinnedStage()
                                for _ in range(self.max_in_flight + 1)]
            stage = self._stages[self._next_stage % len(self._stages)]
            self._next_stage += 1
        return self._server._stage_packed(pk, size, stage)

    def _launch(self, staged, n_real: int) -> _Part:
        """Enqueue one staged part and its result's download; no host
        sync."""
        dev = self._server._dispatch_packed(staged)
        if not self._cuda:
            return _Part(dev, None, n_real, staged.size)
        host = torch.empty(dev.shape, dtype=dev.dtype, pin_memory=True)
        host.copy_(dev, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return _Part(host, event, n_real, staged.size)

    @staticmethod
    def _wait(part: _Part) -> None:
        """Block on this part's own event (never the whole device)."""
        if part.event is not None:
            part.event.synchronize()

    # ------------------------------------------------------------- submit

    def submit(self, keys) -> EngineFuture:
        """Decode and dispatch one batch; returns a future at once.

        Admission control runs first (block on the oldest pending future,
        or shed).  Each max-bucket chunk is padded and staged (pack),
        waits for room in the window (backpressure), then is enqueued
        (dispatch).  If anything raises mid-batch, the parts already
        dispatched are waited for on their events and dropped from the
        window, so the engine stays consistent."""
        if self._closed:
            raise EngineClosed(
                "engine %r is closed — submit after close()"
                % (self.label or "engine",))
        self._check_deadline()
        t_enter = time.perf_counter()
        b_req = getattr(keys, "batch", None) or len(keys)
        with span("submit", engine=self.label or "engine", batch=b_req):
            with span("admit"):
                self._admit(b_req)
            t0 = time.perf_counter()
            with span("pack", phase="decode"):
                pk = self._server._decode_batch(keys)
            b = pk.batch
            fut = EngineFuture(self)
            fut._t0 = t_enter
            try:
                for lo, hi in self.buckets.chunks(b):
                    self._check_deadline()
                    size = self.buckets.bucket_for(hi - lo)
                    with span("pack", phase="pad", bucket=size):
                        staged = self._stage(pk.slice(lo, hi), size)
                    self.stats.pack_time_s += time.perf_counter() - t0
                    while len(self._queue) >= self.max_in_flight:
                        self._check_deadline()
                        self._resolve_one()
                    with span("dispatch", bucket=size):
                        if self._injector is not None:
                            self._injector.on_dispatch(self, size)
                        t1 = time.perf_counter()
                        try:
                            part = self._launch(staged, hi - lo)
                        except DeadlineExceeded:
                            self._note_deadline()
                            raise
                        self.stats.dispatch_time_s += (time.perf_counter()
                                                       - t1)
                    fut._parts.append(part)
                    self._queue.append(part)
                    self.stats.note_dispatch(padded=size - (hi - lo),
                                             in_flight=len(self._queue))
                    t0 = time.perf_counter()
            except BaseException:
                for p in fut._parts:
                    try:
                        self._queue.remove(p)
                    except ValueError:
                        pass
                    self._wait(p)
                    p.host = p.event = None
                raise
            self.stats.batches_submitted += 1
            self.stats.queries_submitted += b
            self._pending.append(fut)
            return fut

    # ---------------------------------------------------------- resolution

    def _resolve_one(self):
        """Wait for the oldest in-flight part's event and keep its rows."""
        part = self._queue.popleft()
        with span("wait", bucket=part.bucket):
            t0 = time.perf_counter()
            self._wait(part)
            part.out = part.host.numpy()[:part.n_real].copy()
            if self._injector is not None:
                part.out = self._injector.on_result(self, part.bucket,
                                                    part.out)
            self.stats.wait_time_s += time.perf_counter() - t0
            part.host = part.event = None

    def _finalize(self, fut: EngineFuture):
        with span("decode", parts=len(fut._parts)):
            parts = fut._parts
            if len(parts) == 1:
                out = parts[0].out
            else:
                out = np.concatenate([p.out for p in parts])
            fut._value = np.ascontiguousarray(out[:, :self._out_width])
            fut._parts = []
            if fut._t0 is not None:
                self.stats.note_latency(time.perf_counter() - fut._t0)

    def _resolve_through(self, fut: EngineFuture):
        """Resolve futures FIFO until (and including) ``fut``."""
        while self._pending:
            head = self._pending.popleft()
            while any(p.out is None for p in head._parts):
                self._resolve_one()
            self._finalize(head)
            if head is fut:
                return
        if fut._value is None:
            raise RuntimeError("future does not belong to this engine")

    def drain(self) -> None:
        """Resolve every outstanding dispatch; all previously returned
        futures become ``done()``."""
        while self._pending:
            self._check_deadline()
            head = self._pending.popleft()
            while any(p.out is None for p in head._parts):
                self._resolve_one()
            self._finalize(head)

    def close(self) -> None:
        """Drain, then reject every later ``submit`` with
        ``EngineClosed``.  Idempotent."""
        self.drain()
        if not self._closed:
            self._closed = True
            ev = dict(engine=self.label or "engine",
                      served=self.stats.queries_submitted)
            if self.tenant is not None:
                ev["tenant"] = self.tenant
            FLIGHT.record("engine_close", **ev)

    @property
    def closed(self) -> bool:
        return self._closed

    @property
    def dispatch_blocking(self) -> bool:
        """Whether ``submit`` computes in the caller's thread (a CPU
        server) rather than enqueueing on a CUDA stream and returning:
        the twin's ``FleetConfig.dispatch_blocking`` for this engine."""
        return not self._cuda

    # ------------------------------------------------------------- warmup

    def warmup(self, tune: bool = False, trace=None) -> None:
        """Build the kernels (on the card) and run one dispatch a bucket
        with synthetic keys; no serving counter moves.  A kernel that
        does not build or launch raises here.  Each dispatch resolves its
        knobs as traffic will (``DPF.resolved_eval_knobs``: searched,
        tuned or heuristic), so it runs the launches traffic runs.

        ``tune=True`` first replaces ``buckets`` and ``max_in_flight`` in
        place with the tuned serving knobs of this (device, table shape,
        cap): the tuning cache's (``tune.serve_tune.lookup_serve_knobs``),
        else, for a server that can mint keys, a search
        (``tune_serving``) against ``trace`` (batch sizes; None = the
        synthetic trace)."""
        if tune:
            from ..tune.serve_tune import lookup_serve_knobs, tune_serving
            cap = self.buckets.max
            knobs = lookup_serve_knobs(self._server, cap)
            if knobs is None and hasattr(self._server, "gen_batch"):
                knobs = tune_serving(self._server, cap=cap,
                                     trace=trace)["knobs"]
            if knobs:
                self.buckets = Buckets(knobs["buckets"])
                self.max_in_flight = int(knobs["max_in_flight"])
                self._stages = []    # one pinned slot a window, plus one
        if self._cuda:
            from ..ops import cuda_build
            cuda_build.build()
        for size in self.buckets.sizes:
            if self._injector is not None:
                self._injector.on_warmup(self, size)
            self._run(self._synthetic_packed(size))

    def _run(self, pk) -> None:
        """One blocking dispatch of a packed batch, resolved by its
        event."""
        self._wait(self._launch(self._stage(pk, pk.batch), pk.batch))

    def _synthetic_packed(self, size: int):
        """A zero-codeword packed batch with the shapes real traffic
        produces at this bucket size (warmup and probe input)."""
        from ..core import keygen, sqrtn
        if self._server.scheme == "sqrtn":
            k, r = sqrtn.default_split(self._n)
            return sqrtn.PackedSqrtKeys(
                seeds=np.zeros((size, k, 4), dtype=np.uint32),
                cw1=np.zeros((size, r, 4), dtype=np.uint32),
                cw2=np.zeros((size, r, 4), dtype=np.uint32),
                n=self._n)
        return keygen.PackedKeys(
            cw1=np.zeros((size, 64, 4), dtype=np.uint32),
            cw2=np.zeros((size, 64, 4), dtype=np.uint32),
            last=np.zeros((size, 4), dtype=np.uint32),
            depth=self._n.bit_length() - 1, n=self._n)

    def probe(self, reps: int = 1) -> dict:
        """Best-of-``reps`` seconds of one warmed dispatch per bucket (the
        router's cost-model seed): on the card, CUDA events around the
        upload, the kernels and the download; on the CPU, the host clock.
        Each bucket runs once untimed first.  Returns ``{size: s}``."""
        out = {}
        for size in self.buckets.sizes:
            if self._injector is not None:
                self._injector.on_warmup(self, size)
            pk = self._synthetic_packed(size)
            self._run(pk)
            best = float("inf")
            for _ in range(max(1, reps)):
                staged = self._stage(pk, size)
                if self._cuda:
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    self._launch(staged, size)
                    end.record()
                    end.synchronize()
                    dt = start.elapsed_time(end) / 1e3
                else:
                    t0 = time.perf_counter()
                    self._launch(staged, size)
                    dt = time.perf_counter() - t0
                best = min(best, dt)
            out[size] = best
        return out

    # ------------------------------------------------------------ plumbing

    def resolved_config(self) -> dict:
        """Bucket ladder, window and the server's eval knobs at the cap
        (benchmark records embed it)."""
        d = {"buckets": list(self.buckets.sizes),
             "max_in_flight": self.max_in_flight}
        try:
            d.update(self._server.resolved_eval_knobs(self.buckets.max))
        except Exception as e:  # diagnostics must never break serving
            note_swallowed("serve.engine.resolved_config", e, self.stats)
        return d

    def _note_deadline(self):
        self.stats.deadline_misses += 1
        ev = dict(engine=self.label or "engine",
                  pending=len(self._pending), in_flight=len(self._queue))
        if self.tenant is not None:
            ev["tenant"] = self.tenant
        FLIGHT.record("deadline", **ev)

    def _check_deadline(self):
        if self.deadline is not None and time.monotonic() > self.deadline:
            self._note_deadline()
            raise DeadlineExceeded(
                "serving-engine deadline passed between dispatches")

    def _admit(self, n_queries: int):
        """Admission control, before any decode or dispatch: the pending
        queue at ``max_queue_depth``, or the ring's p99 over ``slo_s``
        while a backlog exists.  ``shed=True`` rejects with
        ``LoadShed``; otherwise the engine resolves the oldest pending
        future until under the depth bound (the p99 trigger never
        blocks)."""
        over_depth = (self.max_queue_depth is not None
                      and len(self._pending) >= self.max_queue_depth)
        over_slo = False
        if self.slo_s is not None and (self._pending or self._queue):
            p99 = self.stats.p99
            over_slo = p99 is not None and p99 > self.slo_s
        if self.shed and (over_depth or over_slo):
            self.stats.shed_batches += 1
            self.stats.shed_queries += n_queries
            ev = dict(engine=self.label or "engine", batch=n_queries,
                      reason=("queue_depth" if over_depth
                              else "p99_over_slo"),
                      pending=len(self._pending),
                      p99=self.stats.p99, slo_s=self.slo_s)
            if self.tenant is not None:
                ev["tenant"] = self.tenant
            FLIGHT.record("shed", **ev)
            raise LoadShed(
                "admission control rejected the batch (%s; pending=%d, "
                "p99=%s, slo_s=%s)"
                % ("queue depth" if over_depth else "p99 over SLO",
                   len(self._pending), self.stats.p99, self.slo_s))
        while (self.max_queue_depth is not None
               and len(self._pending) >= self.max_queue_depth):
            self._check_deadline()
            self._resolve_through(self._pending[0])

    @property
    def in_flight(self) -> int:
        return len(self._queue)

    def __repr__(self):
        return ("ServingEngine(n=%d, buckets=%s, max_in_flight=%d, "
                "served=%d)" % (self._n, list(self.buckets.sizes),
                                self.max_in_flight,
                                self.stats.queries_submitted))
