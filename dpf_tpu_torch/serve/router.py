"""Runtime cost-model scheme router: pick the construction per batch.

Port of ``dpf_tpu/serve/router.py``.  The fastest construction changes
with the batch size a burst delivers, so ``SchemeRouter`` switches
constructions at runtime by a live cost model:

* One prepared server and ``ServingEngine`` per construction (binary
  GGM, radix-4, sqrt-N) over the SAME table, all sharing one bucket
  ladder so their per-bucket costs compare.
* A cost model ``(construction, bucket) -> EWMA seconds``, seeded from
  startup probe dispatches (``ServingEngine.probe``: CUDA events on the
  card) and updated by the observed service time of every routed batch.
* ``route(batch)`` picks the cheapest construction for the batch's
  bucket once every available construction has an estimate; until then
  it falls back to the sticky construction (``resolve_sticky``: the
  binary-tree heuristic, ``routed_from="heuristic"``; the tuning cache
  that ``dpf_tpu`` consults first is not ported yet).  The router's
  breakers, cost table and route counts export as metrics
  (``obs.metrics.register_router``).

Per-construction circuit breakers, retries with failover and the
engine supervisor (``serve/faults.py``) keep a failing construction's
traffic on the healthy ones.  Every routed answer is a plain engine
result over that construction's keys, so it stays equality-gateable
against ``DPF.eval_cpu``.  Keys are construction-specific: callers
``route`` first, mint keys for ``decision.construction``
(``router.server(label)`` mints them), then ``submit(decision, keys)``.
"""

from __future__ import annotations

import time

from ..core.expand import DeadlineExceeded
from ..obs.flight import FLIGHT
from ..obs.tracer import span
from ..utils.profiling import EngineCounters, note_swallowed
from .buckets import Buckets
from .engine import EngineClosed, LoadShed, ServingEngine
from .faults import (CircuitBreaker, EngineDead, EngineSupervisor,
                     RetryPolicy)

#: construction labels the router can serve, in race order
LABELS = ("logn", "radix4", "sqrtn")


def build_servers(table, labels=LABELS, *, prf_method: int,
                  device=None) -> dict:
    """One prepared ``api.DPF`` per construction label over ``table`` on
    ``device`` (None = CUDA): the one construction-spelling map (label
    -> ctor arguments)."""
    from ..api import DPF
    from ..utils.config import EvalConfig
    servers = {}
    for lb in labels:
        if lb == "radix4":
            srv = DPF(config=EvalConfig(prf_method=prf_method, radix=4),
                      device=device)
        elif lb == "sqrtn":
            srv = DPF(prf=prf_method, scheme="sqrtn", device=device)
        elif lb == "logn":
            srv = DPF(prf=prf_method, device=device)
        else:
            raise ValueError("unknown construction %r (one of %s)"
                             % (lb, ", ".join(LABELS)))
        srv.eval_init(table)
        servers[lb] = srv
    return servers


def resolve_sticky(n: int, entry_size: int, prf_method: int, cap: int,
                   available=LABELS) -> tuple:
    """(construction label, resolved_from) of the sticky fallback: the
    one spelling of that rule, shared by the router and the load
    benchmark's baseline.  ``dpf_tpu`` consults the tuning cache first;
    the port has none yet, so the answer is ``heuristic_scheme``'s,
    with ``resolved_from = "heuristic"``."""
    from ..tune.search import heuristic_scheme
    hs = heuristic_scheme(n)
    label = "radix4" if hs["radix"] == 4 else hs["scheme"]
    if label not in available:
        label = tuple(available)[0]
    return label, "heuristic"


class RouteDecision:
    """One routing answer: which construction serves this batch, and
    why (``routed_from``: "cost-model" once the model has an estimate
    for every construction at this bucket, else the sticky fallback's
    own provenance, "heuristic"; "explore" and "failover" as
    ``SchemeRouter.route`` says)."""
    __slots__ = ("construction", "routed_from", "bucket", "batch")

    def __init__(self, construction, routed_from, bucket, batch):
        self.construction = construction
        self.routed_from = routed_from
        self.bucket = bucket
        self.batch = batch

    def __repr__(self):
        return ("RouteDecision(%s, from=%s, bucket=%d, batch=%d)"
                % (self.construction, self.routed_from, self.bucket,
                   self.batch))


class RoutedFuture:
    """Engine future + the cost-model feedback loop: ``result()``
    resolves the underlying dispatch and folds the observed service
    time (submit→result, per dispatched chunk) back into the router's
    EWMA for (construction, bucket)."""
    __slots__ = ("_router", "_fut", "decision", "_t0", "_chunks",
                 "_observed")

    def __init__(self, router, fut, decision, t0, chunks):
        self._router = router
        self._fut = fut
        self.decision = decision
        self._t0 = t0
        self._chunks = chunks
        self._observed = False

    def done(self) -> bool:
        return self._fut.done()

    def result(self):
        try:
            out = self._fut.result()
        except (LoadShed, DeadlineExceeded, EngineClosed):
            raise               # admission decisions, not engine faults
        except Exception as e:
            self._router._note_failure(self.decision.construction, e)
            raise
        if not self._observed:
            self._observed = True
            dt = (time.perf_counter() - self._t0) / max(1, self._chunks)
            self._router._observe(self.decision.construction,
                                  self.decision.bucket, dt)
            self._router._note_success(self.decision.construction)
        return out


class SchemeRouter:
    """Serve one table through per-construction engines, routed live.

    Args:
      table: the [N, E] int32 table (uploaded once per construction —
        each has its own device layout: bit-reversed, radix-4 mixed
        order, or natural for sqrt-N).
      prf: PRF id shared by all constructions.
      constructions: subset of ``LABELS`` to race (default all three).
      cap / buckets / max_in_flight: the shared engine knobs (one
        ladder for every engine — per-bucket costs must compare); None
        buckets = the default /2 ladder under ``cap`` (``dpf_tpu``
        consults its tuned router ladder first; not ported yet).
      ewma_alpha: weight of each new observation in the cost model.
      probe: measure one warmed dispatch per (construction, bucket) at
        startup to seed the cost model (compile cost is paid here, like
        ``warmup``).  ``probe=False`` starts cold: routing falls back
        to the sticky construction until observations accumulate.
      slo_s / max_queue_depth / shed: per-engine admission control.
      injector: optional ``faults.FaultInjector`` threaded into every
        engine.
      retry: default ``faults.RetryPolicy`` for ``submit_resilient``.
      breaker_failures / breaker_reset_s: per-construction circuit
        breaker — ``breaker_failures`` consecutive engine faults open
        it (excluded from routing); after ``breaker_reset_s`` a
        half-open re-probe (``ServingEngine.probe``) decides whether it
        re-closes.
      supervise: rebuild a dead engine over its prepared server in a
        background thread (``faults.EngineSupervisor``) while the
        router serves degraded on the remaining constructions.
      device: where ``build_servers`` puts the servers (None = CUDA);
        prepared ``servers`` keep their own.

    ``routed_from`` is the provenance of the most recent routing
    decision ("cost-model", "heuristic", "explore" or "failover");
    per-decision provenance rides on ``RouteDecision``.
    """

    def __init__(self, table, *, prf=None, constructions=None,
                 cap: int | None = None, buckets=None,
                 max_in_flight: int = 2, ewma_alpha: float = 0.25,
                 warmup: bool = True, probe: bool = True,
                 probe_reps: int = 1, slo_s: float | None = None,
                 max_queue_depth: int | None = None, shed: bool = False,
                 servers: dict | None = None, injector=None,
                 retry: RetryPolicy | None = None,
                 breaker_failures: int = 5,
                 breaker_reset_s: float = 30.0,
                 supervise: bool = False,
                 tenant: str | None = None, device=None):
        from ..api import DPF
        if not 0 < ewma_alpha <= 1:
            raise ValueError("ewma_alpha must be in (0, 1] (got %r)"
                             % (ewma_alpha,))
        labels = tuple(constructions if constructions is not None
                       else (servers.keys() if servers else LABELS))
        for lb in labels:
            if lb not in LABELS:
                raise ValueError("unknown construction %r (one of %s)"
                                 % (lb, ", ".join(LABELS)))
        if not labels:
            raise ValueError("need at least one construction")
        self.constructions = labels
        self.ewma_alpha = float(ewma_alpha)
        if servers is not None:
            # prepared servers shared across routers (one table upload
            # per construction)
            missing = [lb for lb in labels if lb not in servers]
            if missing:
                raise ValueError("servers missing constructions %s"
                                 % (missing,))
            self._servers = {lb: servers[lb] for lb in labels}
            self.prf_method = self._servers[labels[0]].prf_method
        else:
            self.prf_method = DPF.DEFAULT_PRF if prf is None else prf
            self._servers = build_servers(table, labels,
                                          prf_method=self.prf_method,
                                          device=device)
        any_srv = self._servers[labels[0]]
        self.n = any_srv.table_num_entries
        self.entry_size = any_srv.table_effective_entry_size
        cap = int(cap or min(any_srv.BATCH_SIZE, 512))
        self.buckets = (buckets if isinstance(buckets, Buckets)
                        else Buckets(buckets if buckets is not None
                                     else Buckets.default_sizes(cap)))
        self.injector = injector
        self.retry = retry
        self.tenant = tenant    # owning tenant (metrics/flight labels)
        if injector is not None and tenant is not None:
            injector.tenant = tenant
        # kept for EngineSupervisor rebuilds: a fresh engine must get
        # the SAME admission knobs (and tenant label) as the one it
        # replaces
        self._engine_kw = dict(max_in_flight=max_in_flight,
                               max_queue_depth=max_queue_depth,
                               slo_s=slo_s, shed=shed, tenant=tenant)
        self.engines = {
            lb: ServingEngine(srv, buckets=self.buckets, label=lb,
                              injector=injector, **self._engine_kw)
            for lb, srv in self._servers.items()}
        # ---- recovery machinery: per-construction breaker + counters
        self.recovery = EngineCounters()

        def _opened(_lb=None):
            # inc(), not +=: breakers trip from rebuild threads and
            # RoutedFuture.result() callers concurrently
            self.recovery.inc("breaker_opens")
        self.breakers = {
            lb: CircuitBreaker(failures=breaker_failures,
                               reset_s=breaker_reset_s,
                               on_open=_opened, name=lb, tenant=tenant)
            for lb in labels}
        self.supervisor = (EngineSupervisor(self) if supervise
                           else None)
        # ---- sticky fallback
        self._costs = {}            # (label, bucket) -> EWMA seconds
        self._obs_age = {}          # (label, bucket) -> routes at this
        #                             bucket since that label was last
        #                             OBSERVED (exploration clock)
        self._arrivals = {}         # bucket -> (last_t, EWMA gap s)
        self.sticky, self.sticky_resolved_from = resolve_sticky(
            self.n, self.entry_size, self.prf_method, self.buckets.max,
            available=self.constructions)
        self.routed_from = self.sticky_resolved_from
        self.route_counts = {lb: 0 for lb in labels}
        self.routed_from_counts = {}
        try:
            from ..obs.metrics import register_router
            register_router(self)
        except Exception as e:  # observability must never break serving
            note_swallowed("serve.router.register_metrics", e,
                           self.recovery)
        if warmup or probe:
            self.warmup(probe=probe, probe_reps=probe_reps)

    # -------------------------------------------------------- cost model

    #: routes at a bucket before a never-re-observed construction gets
    #: one exploration dispatch: the EWMA only updates for the routed
    #: construction, so a single inflated observation (client deferred
    #: result(), a load transient) would otherwise lock a construction
    #: out of the argmin FOREVER — periodic re-measurement bounds the
    #: staleness at ~EXPLORE_EVERY batches per bucket.  256 keeps the
    #: exploration tax ~1% of routes (an explore dispatches a possibly
    #: slower construction mid-burst, which shows up directly in p99)
    #: while still re-measuring within seconds under load
    EXPLORE_EVERY = 256

    def _observe(self, label: str, bucket: int, seconds: float):
        """Fold one observed per-dispatch service time into the EWMA."""
        key = (label, bucket)
        cur = self._costs.get(key)
        self._costs[key] = (seconds if cur is None else
                            self.ewma_alpha * seconds
                            + (1 - self.ewma_alpha) * cur)
        self._obs_age[key] = 0

    def cost(self, label: str, bucket: int) -> float | None:
        """Current per-dispatch estimate (seconds), None when unknown."""
        return self._costs.get((label, bucket))

    def cost_table(self) -> dict:
        """The live EWMA cost model as a plain serializable dict:
        ``{"construction@bucket": seconds}`` — the same key spelling
        ``stats()["cost_model_ms"]`` uses (values here stay in SECONDS,
        un-rounded: the machine-readable export the load benchmark's
        record embeds)."""
        return {"%s@%d" % (lb, bk): s
                for (lb, bk), s in sorted(self._costs.items())}

    def seed_costs(self, table: dict) -> int:
        """Re-seed the cost model from a ``cost_table()``-shaped dict
        (string ``"label@bucket"`` or tuple ``(label, bucket)`` keys).
        Entries for constructions this router does not serve are
        skipped; returns the number of entries applied.  Seeded values
        land exactly like probe observations — the EWMA updates from
        live traffic afterwards, so a stale snapshot self-corrects at
        the same rate a poisoned probe would."""
        applied = 0
        for key, s in dict(table).items():
            if isinstance(key, str):
                lb, bk = key.rsplit("@", 1)
                key = (lb, int(bk))
            lb, bk = str(key[0]), int(key[1])
            if lb not in self.constructions:
                continue
            self._costs[(lb, bk)] = float(s)
            self._obs_age[(lb, bk)] = 0
            applied += 1
        return applied

    # ----------------------------------------------------------- routing

    def _available(self, exclude=()) -> tuple:
        """Constructions routing may use right now: not excluded, and
        circuit breaker closed.  Visiting an open breaker runs its
        half-open re-probe when ``reset_s`` has elapsed — recovery is
        checked on the routing path itself, no background poller.  When
        every construction is excluded/open the router DEGRADES rather
        than refuses: all non-excluded constructions are returned (a
        guess at a broken engine still beats a guaranteed error)."""
        avail = []
        for lb in self.constructions:
            if lb in exclude:
                continue
            br = self.breakers[lb]
            if not br.available() and br.should_probe():
                self._probe_breaker(lb)
            if br.available():
                avail.append(lb)
        if not avail:
            avail = [lb for lb in self.constructions
                     if lb not in exclude] or list(self.constructions)
        return tuple(avail)

    def _probe_breaker(self, lb: str) -> None:
        """Half-open re-probe: one timed dispatch per bucket through the
        (possibly rebuilt) engine.  Success refreshes the cost model for
        every bucket AND closes the breaker; failure re-opens it (fresh
        timer) and, on ``EngineDead``, wakes the supervisor."""
        try:
            for size, dt in self.engines[lb].probe(reps=1).items():
                self._observe(lb, size, dt)
        except Exception as e:
            self.breakers[lb].record_failure()
            if isinstance(e, EngineDead) and self.supervisor is not None:
                self.supervisor.notify(lb)
        else:
            self.breakers[lb].record_success()

    def _note_failure(self, lb: str, exc: BaseException) -> None:
        """Engine fault bookkeeping shared by submit/result paths."""
        self.breakers[lb].record_failure()
        if isinstance(exc, EngineDead) and self.supervisor is not None:
            self.supervisor.notify(lb)

    def _note_success(self, lb: str) -> None:
        self.breakers[lb].record_success()

    def dispatch_kernel_info(self, lb: str, bucket: int) -> dict:
        """The per-dispatch kernel decision the construction's server
        would resolve at this bucket: ``kernel_impl`` (``"fused"`` or
        ``"dispatch"``) plus, when the resolver reports them,
        ``kernel_resolved_from`` and ``row_chunk_effective`` (the K4
        grid step); route events carry it.  Empty dict when the server
        exposes no resolution."""
        try:
            eng = self.engines.get(lb)
            rk = getattr(getattr(eng, "_server", None),
                         "resolved_eval_knobs", None)
            if callable(rk):
                kn = rk(bucket)
                info = {"kernel_impl": kn.get("kernel_impl")}
                for extra in ("kernel_resolved_from",
                              "row_chunk_effective",
                              "chunk_leaves_effective"):
                    if kn.get(extra) is not None:
                        info[extra] = kn[extra]
                return info
        except Exception as e:  # diagnostics must never break routing
            note_swallowed("serve.router.dispatch_kernel", e)
        return {}

    def dispatch_kernel(self, lb: str, bucket: int) -> str | None:
        """The bare ``kernel_impl`` of :meth:`dispatch_kernel_info`: the
        ``kernel`` label of the cost-table metric series."""
        return self.dispatch_kernel_info(lb, bucket).get("kernel_impl")

    # ----------------------------------------- arrival-rate estimator

    def note_arrival(self, bucket: int, t: float | None = None) -> None:
        """Feed one arrival at ``bucket`` into the live per-bucket
        arrival-rate estimator: an EWMA over inter-arrival gaps (same
        ``ewma_alpha`` as the cost model).  ``route`` calls this on
        every batch; ``t`` defaults to ``time.monotonic()`` — tests and
        replays pass explicit timestamps, making the estimate a pure
        function of the arrival sequence."""
        if t is None:
            t = time.monotonic()
        prev = self._arrivals.get(bucket)
        if prev is None:
            self._arrivals[bucket] = (t, None)
            return
        last_t, gap = prev
        new_gap = max(t - last_t, 1e-9)
        if gap is not None:
            new_gap = (self.ewma_alpha * new_gap
                       + (1 - self.ewma_alpha) * gap)
        self._arrivals[bucket] = (t, new_gap)

    def arrival_rate(self, bucket: int) -> float | None:
        """EWMA arrivals/second at ``bucket`` (None until two arrivals
        have been seen there)."""
        rec = self._arrivals.get(bucket)
        return None if rec is None or rec[1] is None else 1.0 / rec[1]

    def arrival_rates(self) -> dict:
        """The live per-bucket arrival-rate estimate ``{bucket: Hz}``
        (what ``registry.GranulePrefetcher`` sizes its page-ins by; the
        offline twin over a whole trace is ``loadgen.bucket_rates``);
        buckets seen fewer than twice are omitted."""
        return {bk: 1.0 / gap
                for bk, (_, gap) in sorted(self._arrivals.items())
                if gap is not None}

    def route(self, batch: int, exclude=()) -> RouteDecision:
        """Pick the construction for a ``batch``-query arrival.

        Cost-model routing needs an estimate for EVERY available
        construction at the batch's bucket (comparing a measured
        construction against unmeasured ones would lock onto whichever
        happened to be observed first); anything less falls back to the
        sticky construction (the heuristic; ``routed_from`` says so).
        Every ~``EXPLORE_EVERY`` routes at a bucket, the construction
        whose estimate is stalest gets the batch instead of the argmin
        (``routed_from="explore"``) so its EWMA re-measures and a
        poisoned estimate self-corrects.

        ``exclude`` names constructions this call must avoid (failover
        after their engine faulted); open circuit breakers are excluded
        automatically.  When the sticky winner itself is unavailable
        the cheapest available construction answers instead with
        ``routed_from="failover"``.
        """
        if batch < 1:
            raise ValueError("batch must be >= 1 (got %d)" % batch)
        with span("route", batch=batch):
            bucket = (self.buckets.bucket_for(batch)
                      if batch <= self.buckets.max else self.buckets.max)
            self.note_arrival(bucket)
            avail = self._available(exclude)
            costs = {lb: self._costs.get((lb, bucket)) for lb in avail}
            if all(c is not None for c in costs.values()):
                for lb in avail:
                    self._obs_age[(lb, bucket)] = (
                        self._obs_age.get((lb, bucket), 0) + 1)
                stalest = max(avail,
                              key=lambda lb: self._obs_age[(lb, bucket)])
                if self._obs_age[(stalest, bucket)] >= self.EXPLORE_EVERY:
                    label, routed_from = stalest, "explore"
                    # reset the clock at ROUTE time, not observation
                    # time: with deferred result() every in-flight route
                    # at this bucket would otherwise re-trigger the same
                    # explore — a window-sized storm of the
                    # possibly-slowest construction mid-burst
                    self._obs_age[(stalest, bucket)] = 0
                else:
                    label = min(costs, key=costs.get)
                    routed_from = "cost-model"
            elif self.sticky in avail:
                label, routed_from = (self.sticky,
                                      self.sticky_resolved_from)
            else:
                # sticky winner is down: cheapest available estimate,
                # else first available — provenance says failover
                known = {lb: c for lb, c in costs.items()
                         if c is not None}
                label = (min(known, key=known.get) if known
                         else avail[0])
                routed_from = "failover"
            self.routed_from = routed_from
            self.route_counts[label] += 1
            self.routed_from_counts[routed_from] = (
                self.routed_from_counts.get(routed_from, 0) + 1)
            # the winning construction's per-dispatch kernel decision
            # (impl + searched/halved provenance) — fault/latency
            # attribution joins on it
            kinfo = self.dispatch_kernel_info(label, bucket)
            ev = {"construction": label, "routed_from": routed_from,
                  "bucket": bucket, "batch": batch,
                  "kernel_impl": kinfo.get("kernel_impl"),
                  "costs_ms": {lb: (None if c is None
                                    else round(c * 1e3, 4))
                               for lb, c in costs.items()}}
            for extra in ("kernel_resolved_from", "row_chunk_effective",
                          "chunk_leaves_effective"):
                if kinfo.get(extra) is not None:
                    ev[extra] = kinfo[extra]
            if self.injector is not None:
                # the arrival index FaultInjector events carry too —
                # the join key for fault -> route attribution
                ev["arrival"] = self.injector.arrival
            if self.tenant is not None:
                ev["tenant"] = self.tenant
            FLIGHT.record("route", **ev)
            return RouteDecision(label, routed_from, bucket, batch)

    def submit(self, decision: RouteDecision, keys) -> RoutedFuture:
        """Dispatch ``keys`` (minted for ``decision.construction`` —
        ``server(label).gen``) through that construction's engine;
        returns a ``RoutedFuture`` whose resolution feeds the observed
        service time back into the cost model.  Engine faults (anything
        but the ``LoadShed``/``DeadlineExceeded`` admission decisions)
        count against the construction's circuit breaker before
        re-raising; ``EngineDead`` additionally wakes the supervisor."""
        engine = self.engines[decision.construction]
        chunks = len(engine.buckets.chunks(len(keys)))
        t0 = time.perf_counter()
        try:
            fut = engine.submit(keys)
        except (LoadShed, DeadlineExceeded, EngineClosed):
            raise               # admission decisions, not engine faults
        except Exception as e:
            self._note_failure(decision.construction, e)
            raise
        return RoutedFuture(self, fut, decision, t0, chunks)

    def submit_resilient(self, batch: int, keys_for, *, retry=None,
                         exclude=()) -> RoutedFuture:
        """Route + submit with retry AND construction failover.

        ``keys_for(label)`` mints/fetches the keys for a construction
        (keys are construction-specific, so failover must re-mint).
        Each attempt routes fresh — ``EngineDead`` (and any breaker
        opened by earlier failures) excludes that construction, so the
        retry lands on a healthy engine over the same table; transient
        faults retry the same construction after the policy's backoff.
        Counts ``recovery.retries`` per re-attempt and
        ``recovery.failovers`` when the construction changed.
        ``LoadShed``/``DeadlineExceeded`` propagate immediately (never
        retried).  The returned future resolves the SUCCESSFUL submit;
        failures surfacing later in ``result()`` are the caller's to
        handle (resolution happens outside this call's scope).
        """
        policy = retry or self.retry or RetryPolicy()
        excluded = set(exclude)
        last_label = None
        attempt = 0
        while True:
            attempt += 1
            decision = self.route(batch, exclude=excluded)
            failed_over = (last_label is not None
                           and decision.construction != last_label)
            if failed_over:
                self.recovery.inc("failovers")
                fev = dict(frm=last_label, to=decision.construction,
                           batch=batch, attempt=attempt)
                if self.tenant is not None:
                    fev["tenant"] = self.tenant
                FLIGHT.record("failover", **fev)
            last_label = decision.construction
            try:
                if attempt == 1:
                    return self.submit(decision,
                                       keys_for(decision.construction))
                # re-attempts get their own span ("failover" when the
                # construction changed) so recovery time is attributable
                with span("failover" if failed_over else "retry",
                          attempt=attempt,
                          construction=decision.construction):
                    return self.submit(decision,
                                       keys_for(decision.construction))
            except (LoadShed, DeadlineExceeded, EngineClosed):
                raise
            except Exception as e:
                if (not policy.retryable(e)
                        or attempt >= policy.max_attempts):
                    raise
                self.recovery.inc("retries")
                rev = dict(construction=decision.construction,
                           batch=batch, attempt=attempt,
                           error=type(e).__name__)
                if self.tenant is not None:
                    rev["tenant"] = self.tenant
                FLIGHT.record("retry", **rev)
                if isinstance(e, EngineDead):
                    # dead engines don't heal within a backoff window:
                    # fail over NOW, no sleep
                    excluded.add(decision.construction)
                    if len(excluded) >= len(self.constructions):
                        excluded.clear()   # everything down: retry all
                        policy.sleep(attempt)
                else:
                    policy.sleep(attempt)

    # ---------------------------------------------------------- plumbing

    def server(self, label: str):
        """The prepared ``api.DPF`` serving one construction (also the
        key-minting client and the scalar-oracle reference for it)."""
        return self._servers[label]

    def warmup(self, probe: bool = True, probe_reps: int = 1) -> None:
        """Precompile every (construction, bucket) program; with
        ``probe`` also seed the cost model from one timed dispatch each
        (``ServingEngine.probe``)."""
        for lb, engine in self.engines.items():
            engine.warmup()
            if probe:
                for size, dt in engine.probe(reps=probe_reps).items():
                    self._observe(lb, size, dt)

    def drain(self) -> None:
        """Resolve every outstanding dispatch across all engines."""
        for engine in self.engines.values():
            engine.drain()

    def close(self) -> None:
        """Drain, then decommission every engine: in-flight work
        completes, and any later ``submit`` is rejected with the
        engine's ``EngineClosed`` (passed through untouched — a closed
        engine is a decision, not a fault, so it never counts against
        a breaker).  Outstanding supervisor rebuilds are joined first
        so a rebuilt engine cannot resurrect a closed construction."""
        if self.supervisor is not None:
            self.supervisor.join()
        for engine in self.engines.values():
            engine.close()

    def reset_counters(self) -> None:
        """Zero routing counts and every engine's counters (bench reps
        measure fresh); the LEARNED state — the cost model and sticky
        resolution — is kept."""
        for engine in self.engines.values():
            engine.stats.reset()
        self.recovery.reset()
        self.route_counts = {lb: 0 for lb in self.constructions}
        self.routed_from_counts = {}

    def counters(self) -> EngineCounters:
        """All engines' counters merged into one record
        (``EngineCounters.merge``), plus the router-level recovery
        events (retries/failovers/breaker opens/restarts) — the
        router-level SLO view."""
        agg = EngineCounters()
        for engine in self.engines.values():
            agg.merge(engine.stats)
        agg.merge(self.recovery)
        return agg

    def stats(self) -> dict:
        """Routing + serving diagnostics for benchmark records."""
        out = {
            "constructions": list(self.constructions),
            "sticky": self.sticky,
            "sticky_resolved_from": self.sticky_resolved_from,
            "routed_from": self.routed_from,
            "route_counts": dict(self.route_counts),
            "routed_from_counts": dict(self.routed_from_counts),
            "cost_model_ms": {
                "%s@%d" % (lb, bk): round(s * 1e3, 4)
                for (lb, bk), s in sorted(self._costs.items())},
            "buckets": list(self.buckets.sizes),
            "arrival_rate_hz": {
                "%d" % bk: round(hz, 4)
                for bk, hz in self.arrival_rates().items()},
            "counters": self.counters().as_dict(),
            "per_engine": {lb: e.stats.as_dict()
                           for lb, e in self.engines.items()},
            "breakers": {lb: br.as_dict()
                         for lb, br in self.breakers.items()},
        }
        if self.supervisor is not None:
            out["supervisor"] = {
                "failed_rebuilds": self.supervisor.failed_rebuilds,
                "rebuilding": list(self.supervisor.rebuilding())}
        if self.injector is not None:
            out["faults"] = self.injector.stats()
        return out

    def __repr__(self):
        return ("SchemeRouter(n=%d, constructions=%s, sticky=%s/%s, "
                "routed=%s)" % (self.n, list(self.constructions),
                                self.sticky, self.sticky_resolved_from,
                                dict(self.route_counts)))
