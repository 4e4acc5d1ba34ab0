"""Multi-tenant serving: per-tenant routers, weighted-fair dispatch.

Port of ``dpf_tpu/serve/tenant.py``.  One process, many tables, many
tenants.  ``TenantRouter`` composes the single-table machinery into an
isolated stack per tenant over shared infrastructure:

* **One ``SchemeRouter`` per tenant** over that tenant's registry table
  (``serve/registry.py`` holds the named, versioned, LRU-resident
  uploads), so every tenant keeps the construction race, cost model,
  retry and failover, breakers and supervisor rebuilds.
* **Shared where sharing is safe**: tenants whose (N, E, cap) shapes
  collide share ONE bucket ladder (the same ``Buckets`` instance), so
  their per-bucket costs compare.  The ladder is the tuned router
  ladder of that shape (``tune.serve_tune.lookup_router_knobs``), else
  ``Buckets.default_sizes(cap)``.
* **Isolated where isolation is the point**: admission control
  (``LoadShed``), ``CircuitBreaker`` state, ``RetryPolicy``, fault
  injectors and SLOs are per tenant, and every flight and metrics event
  of a tenant's stack carries ``tenant=``.
* **Weighted-fair scheduling**: deficit round robin over the per-tenant
  queues (``weight`` = share of dispatch, ``max_in_flight`` = the
  tenant's concurrency quota).  A bursting tenant's backlog waits in
  ITS queue and is clipped to its weighted share and quota.  Deficit is
  counted in queries, so weights divide throughput, not batch counts.
* **Per-tenant dispatch workers**: DRR grants run on one worker thread
  per tenant, never on the granting caller's thread, so one tenant's
  retry backoff or fault storm never stalls another's submit path.  The
  scheduler lock is held only for queue and quota bookkeeping.

On the card every worker launches on its thread's current stream, the
default stream (the port gives no thread a stream of its own): kernels
of all tenants, registry promotions and table frees are ordered on one
stream, so a demoted table's block is reused only after every kernel
queued before the free.  A dispatch pins the tenant's table version
(``TableRegistry.acquire``) and the lease is released when the batch
resolves, which is after the part's CUDA event (the result is on the
host), never at enqueue.

The noisy-neighbour bench (``serve/bench_multitenant.py``) measures the
isolation: a victim tenant absorbs a 4x burst and a seeded
``FaultPlan`` while every other tenant's availability and p99 are
compared with its solo baseline.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque

from ..obs.flight import FLIGHT
from ..utils.profiling import note_swallowed
from .buckets import Buckets
from .engine import EngineClosed, LoadShed
from .registry import TableRegistry
from .router import SchemeRouter

#: default deficit-round-robin quantum (queries credited per round at
#: weight 1.0): one cap-sized batch per round for the default ladder
QUANTUM = 128


@dataclasses.dataclass
class TenantSpec:
    """One tenant's serving contract.

    ``table`` registers a new table under ``name`` at ``add_tenant``
    time; ``table_name`` instead points at an existing registry name
    (two tenants MAY serve one table).  ``weight`` is the DRR share;
    ``max_in_flight`` bounds dispatched-but-unresolved batches (the
    quota that stops a burst from taking the device); ``max_queue_depth``
    with ``shed`` arms tenant-level admission control, and ``slo_s`` /
    ``shed`` also arm the engines' p99 admission.  ``plan`` is an
    optional per-tenant ``FaultPlan`` (its injector is private to this
    tenant's engines)."""
    name: str
    table: object = None
    table_name: str | None = None
    weight: float = 1.0
    slo_s: float | None = None
    max_in_flight: int = 4
    max_queue_depth: int | None = None
    shed: bool = False
    cap: int = 128
    plan: object = None
    retry: object = None
    breaker_failures: int = 5
    breaker_reset_s: float = 30.0
    probe: bool = True

    def __post_init__(self):
        if self.weight <= 0:
            raise ValueError("weight must be > 0 (got %r)"
                             % (self.weight,))
        if self.max_in_flight < 1:
            raise ValueError("max_in_flight must be >= 1 (got %d)"
                             % self.max_in_flight)


class _PendingBatch:
    __slots__ = ("batch", "keys_for", "arrival", "future")

    def __init__(self, batch, keys_for, arrival, future):
        self.batch = batch
        self.keys_for = keys_for
        self.arrival = arrival
        self.future = future


class TenantFuture:
    """Result handle for one tenant batch: queued (DRR backlog) ->
    dispatched (engine future in flight) -> resolved (value or error).

    ``result()`` pumps the scheduler while queued: within a tenant,
    batches dispatch and resolve FIFO, so waiting on a queued batch
    first resolves the tenant's older in-flight ones (freeing quota)
    until this one dispatches."""

    __slots__ = ("_sched", "_tenant", "_routed", "_lease", "_value",
                 "_exc", "_state")

    def __init__(self, sched, tenant):
        self._sched = sched
        self._tenant = tenant
        self._routed = None
        self._lease = None
        self._value = None
        self._exc = None
        self._state = "queued"

    @property
    def tenant(self) -> str:
        return self._tenant.name

    @property
    def decision(self):
        """The routing decision that served this batch (None until
        dispatched)."""
        return getattr(self._routed, "decision", None)

    def done(self) -> bool:
        return self._state == "resolved"

    def _resolve(self) -> None:
        """Resolve the engine future (its part's event has passed when
        ``result()`` returns), then release the table lease.  Stores
        value or error, never raises (errors surface at ``result()``)."""
        t = self._tenant
        with t.elock:
            if self._state == "resolved":
                return
            if self._state != "dispatched":
                raise RuntimeError("cannot resolve a queued batch")
            try:
                self._value = self._routed.result()
            except Exception as e:
                self._exc = e
            self._state = "resolved"
        if self._lease is not None:
            self._lease.release()
            self._lease = None
        self._sched._on_resolved(t, self)

    def result(self):
        while self._state == "queued":
            self._sched.pump()
            if self._state != "queued":
                break
            head = self._sched._oldest_in_flight(self._tenant)
            if head is not None and head is not self:
                head._resolve()      # frees quota; FIFO within tenant
            else:
                time.sleep(2e-4)     # grant is on the tenant's worker
        if self._state == "dispatched":
            self._resolve()
        if self._exc is not None:
            raise self._exc
        return self._value


class _Tenant:
    """Scheduler-side state for one tenant."""

    __slots__ = ("spec", "router", "lease0", "queue", "grants",
                 "inflight", "in_flight", "deficit", "submitted",
                 "dispatched", "shed_batches", "shed_queries",
                 "quota_defers", "errors", "elock", "cv", "stopped",
                 "worker")

    def __init__(self, spec, router, lease0):
        self.spec = spec
        self.router = router
        self.lease0 = lease0          # warmup-time pin (released after)
        self.queue = deque()          # _PendingBatch, FIFO (pre-grant)
        self.grants = deque()         # DRR-granted, awaiting the worker
        self.inflight = deque()       # dispatched unresolved futures
        self.in_flight = 0
        self.deficit = 0.0
        self.submitted = 0
        self.dispatched = 0
        self.shed_batches = 0
        self.shed_queries = 0
        self.quota_defers = 0
        self.errors = 0
        self.elock = threading.RLock()  # serializes THIS tenant's engines
        self.cv = threading.Condition()  # wakes THIS tenant's worker
        self.stopped = False
        self.worker = None

    @property
    def name(self) -> str:
        return self.spec.name


class TenantRouter:
    """Per-tenant ``SchemeRouter``s + registry residency + DRR dispatch.

    Args:
      registry: the ``TableRegistry`` to serve from (None = a new one
        on the card; ``budget_bytes`` / ``prf_method`` configure it).
      quantum: DRR credit (queries) granted per round at weight 1.0.

    ``add_tenant(spec)`` builds the tenant's stack; ``submit(name,
    batch, keys_for, arrival=None)`` enqueues one batch and returns a
    ``TenantFuture`` (or raises ``LoadShed`` when the tenant's own
    admission control rejects it, never because of another tenant's
    state).  Dispatch order across tenants is deficit round robin; each
    dispatch pins the tenant's table version for the life of the batch,
    so LRU eviction never demotes a table under a query in flight.
    """

    def __init__(self, registry: TableRegistry | None = None, *,
                 budget_bytes: int | None = None, prf_method: int = 0,
                 quantum: int = QUANTUM):
        self.registry = registry if registry is not None else \
            TableRegistry(budget_bytes, prf_method=prf_method)
        self.quantum = float(quantum)
        self.tenants = {}             # name -> _Tenant
        self._ladders = {}            # (n, e, cap) -> (Buckets, knobs)
        self._closed = False          # close() ran; submit rejects
        self._lock = threading.RLock()
        try:
            from ..obs.metrics import register_tenants
            register_tenants(self)
        except Exception as e:  # observability must never break serving
            note_swallowed("serve.tenant.register_metrics", e)

    # -------------------------------------------------------- tenants

    def add_tenant(self, spec: TenantSpec, *, version: int | None = None
                   ) -> "_Tenant":
        """Register (or attach to) the tenant's table and build its
        router over the registry's prepared servers.  Shapes that
        collide with an existing tenant's share its bucket ladder (the
        identical ``Buckets`` instance)."""
        with self._lock:
            if spec.name in self.tenants:
                raise ValueError("tenant %r already added" % spec.name)
            table_name = spec.table_name or spec.name
            if spec.table is not None:
                self.registry.register(table_name, spec.table,
                                       version=version)
            # hold a pin across router construction: warmup and probe
            # dispatches must not race an eviction of this very table
            lease = self.registry.acquire(table_name, version=version)
            ladder, knobs = self._ladder(lease.servers, spec.cap)
            injector = (spec.plan.injector()
                        if spec.plan is not None else None)
            router = SchemeRouter(
                None, servers=lease.servers, cap=spec.cap,
                buckets=ladder,
                max_in_flight=int(knobs.get("max_in_flight", 2)),
                ewma_alpha=float(knobs.get("ewma_alpha", 0.25)),
                probe=spec.probe, slo_s=spec.slo_s,
                max_queue_depth=spec.max_queue_depth, shed=spec.shed,
                injector=injector, retry=spec.retry,
                breaker_failures=spec.breaker_failures,
                breaker_reset_s=spec.breaker_reset_s,
                supervise=True, tenant=spec.name)
            t = _Tenant(spec, router, lease)
            t.lease0.release()        # steady state pins per dispatch
            t.worker = threading.Thread(
                target=self._worker, args=(t,), daemon=True,
                name="dpf-tenant-%s" % spec.name)
            t.worker.start()
            self.tenants[spec.name] = t
            FLIGHT.record("tenant", action="add", tenant=spec.name,
                          table=table_name, weight=spec.weight,
                          max_in_flight=spec.max_in_flight)
            return t

    def _ladder(self, servers, cap: int):
        """One bucket ladder per (N, E, cap) shape, shared by every
        tenant whose shape collides (their per-bucket costs compare):
        the tuned router ladder of the shape on the servers' device,
        else ``Buckets.default_sizes(cap)``."""
        srv = next(iter(servers.values()))
        key = (srv.table_num_entries, srv.table_effective_entry_size,
               int(cap))
        hit = self._ladders.get(key)
        if hit is not None:
            return hit
        knobs = None
        try:
            from ..tune.serve_tune import lookup_router_knobs
            shape = type("Shape", (), {
                "n": key[0], "entry_size": key[1],
                "prf_method": srv.prf_method, "device": srv.device})()
            knobs = lookup_router_knobs(shape, cap)
        except Exception as e:  # a tuned ladder is an optimization only
            note_swallowed("serve.tenant.ladder_lookup", e)
        buckets = Buckets(knobs["buckets"] if knobs
                          else Buckets.default_sizes(cap))
        self._ladders[key] = (buckets, knobs or {})
        return self._ladders[key]

    def router(self, name: str) -> SchemeRouter:
        return self.tenants[name].router

    # --------------------------------------------------------- submit

    def submit(self, name: str, batch: int, keys_for, *,
               arrival: int | None = None) -> TenantFuture:
        """Enqueue one batch for ``name``; DRR decides when it
        dispatches.  Tenant-level admission runs here: over
        ``max_queue_depth`` with ``shed=True`` the batch is rejected
        (``LoadShed``), decided from THIS tenant's queue alone.  Engine
        sheds and faults during the dispatch surface on the returned
        future's ``result()``."""
        with self._lock:
            if self._closed:
                raise EngineClosed(
                    "TenantRouter is closed — submit after close()")
            t = self.tenants[name]
            depth = len(t.queue) + t.in_flight
            if (t.spec.shed and t.spec.max_queue_depth is not None
                    and depth >= t.spec.max_queue_depth):
                t.shed_batches += 1
                t.shed_queries += batch
                FLIGHT.record("shed", engine="tenant-sched",
                              tenant=name, batch=batch,
                              reason="tenant_queue_depth",
                              pending=depth,
                              max_queue_depth=t.spec.max_queue_depth)
                raise LoadShed(
                    "tenant %r admission rejected the batch "
                    "(depth=%d >= %d)"
                    % (name, depth, t.spec.max_queue_depth))
            fut = TenantFuture(self, t)
            t.queue.append(_PendingBatch(batch, keys_for, arrival, fut))
            t.submitted += 1
        self.pump()
        return fut

    # ------------------------------------------------------ scheduling

    def pump(self) -> int:
        """Run deficit-round-robin grant rounds until every queued batch
        is granted or quota-blocked; returns the batches granted.  Each
        round credits every backlogged tenant under its quota ``quantum
        * weight`` queries and grants its head batches while they fit.
        A grant reserves the tenant's quota and hands the batch to the
        tenant's worker; the scheduler lock is never held across engine
        work."""
        total = 0
        woken = []
        with self._lock:
            while True:
                eligible = [t for t in self.tenants.values() if t.queue]
                if not eligible:
                    break
                progress = False
                blocked = 0
                for t in eligible:
                    if t.in_flight >= t.spec.max_in_flight:
                        t.quota_defers += 1
                        blocked += 1
                        continue
                    t.deficit += self.quantum * t.spec.weight
                    while (t.queue
                           and t.queue[0].batch <= t.deficit
                           and t.in_flight < t.spec.max_in_flight):
                        pb = t.queue.popleft()
                        t.deficit -= pb.batch
                        t.in_flight += 1   # reserved at grant time
                        t.grants.append(pb)
                        if t not in woken:
                            woken.append(t)
                        progress = True
                        total += 1
                    if not t.queue:
                        t.deficit = 0.0   # no banked credit while idle
                if not progress and blocked == len(eligible):
                    break                 # all backlog is quota-blocked
        for t in woken:
            with t.cv:
                t.cv.notify()
        return total

    def _worker(self, t: "_Tenant") -> None:
        """Per-tenant dispatch loop: runs DRR grants under the tenant's
        OWN engine lock on the tenant's OWN thread."""
        while True:
            with t.cv:
                while not t.grants and not t.stopped:
                    t.cv.wait()
                if t.stopped and not t.grants:
                    return
            self._drain_grants(t)

    def _drain_grants(self, t: "_Tenant") -> None:
        freed = 0
        with t.elock:
            while t.grants:
                if not self._dispatch(t, t.grants.popleft()):
                    freed += 1
        if freed:
            with self._lock:
                t.in_flight = max(0, t.in_flight - freed)
            self.pump()               # freed quota: grant more backlog

    def _dispatch(self, t: "_Tenant", pb: _PendingBatch) -> bool:
        """One DRR-granted dispatch through the tenant's router (on the
        tenant's worker under ``t.elock``).  Pins the table version for
        the batch's life; engine sheds and faults resolve the future
        with the error instead of raising here (another tenant must
        never see this tenant's failure).  Returns False when the grant
        died here (the caller releases its quota)."""
        fut = pb.future
        try:
            lease = self.registry.acquire(t.spec.table_name
                                          or t.spec.name)
            try:
                if (t.router.injector is not None
                        and pb.arrival is not None):
                    t.router.injector.begin_arrival(pb.arrival)
                routed = t.router.submit_resilient(pb.batch,
                                                   pb.keys_for)
            except BaseException:
                lease.release()
                raise
        except Exception as e:
            if isinstance(e, LoadShed):
                t.shed_batches += 1
                t.shed_queries += pb.batch
            else:
                t.errors += 1
            fut._exc = e
            fut._state = "resolved"
            return False
        fut._routed = routed
        fut._lease = lease
        fut._state = "dispatched"
        t.inflight.append(fut)
        t.dispatched += 1
        return True

    def _oldest_in_flight(self, t: "_Tenant"):
        # list() snapshots atomically under the GIL: the tenant's
        # worker appends to t.inflight without holding self._lock
        for f in list(t.inflight):
            if not f.done():
                return f
        return None

    def _on_resolved(self, t: "_Tenant", fut: TenantFuture) -> None:
        with self._lock:
            try:
                t.inflight.remove(fut)
            except ValueError:
                pass
            t.in_flight = max(0, t.in_flight - 1)
        self.pump()                   # freed quota: dispatch backlog

    # -------------------------------------------------------- plumbing

    def drain(self) -> None:
        """Dispatch and resolve every outstanding batch."""
        while True:
            self.pump()
            pending = []
            with self._lock:
                for t in self.tenants.values():
                    pending.extend(f for f in list(t.inflight)
                                   if not f.done())
                backlog = any(t.queue or t.grants
                              for t in self.tenants.values())
            if not pending and not backlog:
                return
            for f in pending:
                f._resolve()
            if not pending:
                time.sleep(2e-4)      # grants are on tenant workers

    def close(self) -> None:
        """Stop the per-tenant dispatch workers (outstanding grants are
        drained first).  A later ``submit`` raises ``EngineClosed``.
        Idempotent."""
        self.drain()
        with self._lock:
            self._closed = True
        for t in self.tenants.values():
            with t.cv:
                t.stopped = True
                t.cv.notify()
        for t in self.tenants.values():
            if t.worker is not None:
                t.worker.join(timeout=5.0)

    def stats(self) -> dict:
        """Per-tenant scheduler and router diagnostics (benchmark
        records embed it), plus the registry's residency snapshot."""
        with self._lock:
            out = {"quantum": self.quantum, "tenants": {}}
            for name, t in self.tenants.items():
                out["tenants"][name] = {
                    "weight": t.spec.weight,
                    "max_in_flight": t.spec.max_in_flight,
                    "submitted": t.submitted,
                    "dispatched": t.dispatched,
                    "shed_batches": t.shed_batches,
                    "shed_queries": t.shed_queries,
                    "quota_defers": t.quota_defers,
                    "errors": t.errors,
                    "queue_depth": len(t.queue),
                    "granted_pending": len(t.grants),
                    "in_flight": t.in_flight,
                    "router": t.router.stats(),
                }
            out["registry"] = self.registry.stats()
            return out

    def __repr__(self):
        return ("TenantRouter(%d tenants, quantum=%g)"
                % (len(self.tenants), self.quantum))
