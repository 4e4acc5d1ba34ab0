"""Seeded fault injection and the recovery machinery it exercises.

Port of ``dpf_tpu/serve/faults.py``; every seeded decision is the JAX
package's for the same plan and seed.

**Injection**: ``FaultPlan`` (a list of ``FaultSpec``) plus a seed mints
a ``FaultInjector`` consulted at the engine's injection points (before
each dispatch, on each resolved result, before each warmup or probe
run).  Six kinds, each targetable by construction x bucket x
arrival-index window with a per-consult probability: ``dispatch_error``,
``compile_error`` (on the card: a warmup or probe run that fails),
``latency`` (a straggler sleep), ``corrupt_shares`` (resolved rows
bit-flipped; the equality gate must catch every one), ``engine_death``
(the engine object is poisoned until the supervisor rebuilds it) and
``host_drop`` (``engine_death`` for a whole serving host, whose
heartbeats fail too).  Each consult draws from
``np.random.default_rng((seed, spec_index, arrival + 1, consult))``, a
pure function of the targeting coordinates, so a plan replayed over a
trace injects the identical faults.

**Recovery**: ``RetryPolicy`` (bounded attempts, exponential backoff
with seeded jitter; ``submit_with_retry``), ``CircuitBreaker`` (K
consecutive failures open it; a half-open re-probe after ``reset_s``)
and ``EngineSupervisor`` (rebuilds a dead engine over the same prepared
server, re-warms it, and swaps it in).  A rebuild builds the same CUDA
engine again: nothing here moves a server to the CPU or to a plain
version.
"""

from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np

from ..core.expand import DeadlineExceeded
from ..obs.flight import FLIGHT
from ..obs.tracer import span
from .engine import LoadShed, ServingEngine

#: fault kinds a FaultSpec can name
KINDS = ("dispatch_error", "compile_error", "latency", "corrupt_shares",
         "engine_death", "host_drop")


class FaultError(RuntimeError):
    """Base class of every injected fault (so harnesses can tell an
    injected failure from a genuine one)."""


class InjectedDispatchError(FaultError):
    """An injected per-dispatch failure (``kind="dispatch_error"``)."""


class InjectedCompileError(FaultError):
    """An injected warmup/precompile failure (``kind="compile_error"``)."""


class EngineDead(FaultError):
    """The engine object is poisoned (``kind="engine_death"``): every
    dispatch raises until the supervisor rebuilds a fresh engine."""


class HostDropped(EngineDead):
    """A whole serving host died (``kind="host_drop"``): every engine on
    it is gone at once and its heartbeats stop.  Subclasses
    ``EngineDead`` so engine-level recovery (router exclusion,
    supervisor notify) applies unchanged; ``dpf_tpu``'s cluster tier
    (``parallel/cluster.py``, not ported yet) also takes the host out
    of its scatter plan."""


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One targeted fault stream.

    ``construction``/``bucket`` of None match anything; ``start``/
    ``stop`` bound the arrival-index window (stop exclusive, None =
    open-ended); ``p`` is the per-consult firing probability;
    ``max_fires`` bounds total fires (``engine_death`` is implicitly
    once).  ``latency_s`` only applies to ``kind="latency"``."""
    kind: str
    construction: str | None = None
    bucket: int | None = None
    start: int = 0
    stop: int | None = None
    p: float = 1.0
    latency_s: float = 0.05
    max_fires: int | None = None

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError("unknown fault kind %r (one of %s)"
                             % (self.kind, ", ".join(KINDS)))
        if not 0.0 <= self.p <= 1.0:
            raise ValueError("p must be in [0, 1] (got %r)" % (self.p,))

    def matches(self, label: str | None, bucket: int | None,
                arrival: int) -> bool:
        if self.construction is not None and label != self.construction:
            return False
        if self.bucket is not None and bucket != self.bucket:
            return False
        if arrival < self.start:
            return False
        return self.stop is None or arrival < self.stop

    def as_dict(self) -> dict:
        return {k: v for k, v in dataclasses.asdict(self).items()
                if v is not None}

    @classmethod
    def from_dict(cls, d: dict) -> "FaultSpec":
        """Inverse of ``as_dict`` (``as_dict`` drops None fields, so a
        round-trip restores the dataclass defaults for them)."""
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in fields})


class FaultPlan:
    """An immutable list of ``FaultSpec`` plus the seed that makes every
    injection decision reproducible.  ``injector()`` mints the runtime
    object the engines consult.  ``as_dict``/``from_dict`` round-trip
    the full plan, so a committed chaos-style bench record (which embeds
    ``record["faults"]["plan"]``) names an exactly replayable fault
    sequence."""

    def __init__(self, specs=(), seed: int = 0):
        self.specs = tuple(specs)
        self.seed = int(seed)

    def injector(self) -> "FaultInjector":
        return FaultInjector(self)

    def as_dict(self) -> dict:
        return {"seed": self.seed,
                "specs": [s.as_dict() for s in self.specs]}

    @classmethod
    def from_dict(cls, d: dict) -> "FaultPlan":
        return cls(specs=[FaultSpec.from_dict(s)
                          for s in d.get("specs", ())],
                   seed=d.get("seed", 0))


class FaultInjector:
    """Runtime fault oracle, consulted at the engine injection points.

    The harness calls ``begin_arrival(j)`` before each arrival's
    submit; every consult then decides by a seeded hash of
    (spec, arrival, consult-count) — deterministic, order-independent
    across specs, replayable.  ``injected`` counts fires per kind;
    ``corruptions`` lists (construction, arrival) per corrupted batch
    so the bench can prove 0 bit-gate escapes.
    """

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self.arrival = -1             # -1 = outside any arrival (warmup)
        self.tenant = None            # set by TenantRouter (flight label)
        self.injected = {k: 0 for k in KINDS}
        self.corruptions = []         # (construction, arrival)
        self._consults = {}           # (spec_idx, arrival) -> count
        self._fires = {}              # spec_idx -> total fires
        self._dead = set()            # id(engine) of poisoned engines
        self._lock = threading.Lock()

    def begin_arrival(self, j: int) -> None:
        self.arrival = int(j)

    # ------------------------------------------------------ decisions

    def _fires_left(self, idx: int, spec: FaultSpec) -> bool:
        # death faults poison persistent state — once is the event
        cap = (1 if spec.kind in ("engine_death", "host_drop")
               else spec.max_fires)
        return cap is None or self._fires.get(idx, 0) < cap

    def _decide(self, idx: int, spec: FaultSpec) -> bool:
        """One deterministic draw for (spec, current arrival, consult
        count).  Repeated consults at the same arrival (multi-chunk
        batches, retries) draw independently, so a retry CAN succeed
        against a probabilistic fault."""
        key = (idx, self.arrival)
        with self._lock:
            consult = self._consults.get(key, 0)
            self._consults[key] = consult + 1
        if spec.p >= 1.0:
            fired = True
        else:
            rng = np.random.default_rng(
                (self.plan.seed, idx, self.arrival + 1, consult))
            fired = bool(rng.random() < spec.p)
        if fired:
            with self._lock:
                if not self._fires_left(idx, spec):
                    return False
                self._fires[idx] = self._fires.get(idx, 0) + 1
                self.injected[spec.kind] += 1
        return fired

    def _firing(self, kinds, label, bucket):
        for idx, spec in enumerate(self.plan.specs):
            if (spec.kind in kinds and self._fires_left(idx, spec)
                    and spec.matches(label, bucket, self.arrival)
                    and self._decide(idx, spec)):
                # flight-record every fire with the SAME arrival index
                # the route decision carries — the join key that
                # attributes a fault to the decision that placed it
                ev = dict(fault=spec.kind, construction=label,
                          bucket=bucket, arrival=self.arrival)
                if self.tenant is not None:
                    ev["tenant"] = self.tenant
                FLIGHT.record("fault", **ev)
                yield spec

    # ----------------------------------------------- injection points

    def on_dispatch(self, engine, bucket: int) -> None:
        """Consulted by ``ServingEngine.submit`` immediately before each
        chunk's device dispatch.  May sleep (latency), poison the engine
        (engine_death -> ``EngineDead``), or raise
        ``InjectedDispatchError``; the engine's existing partial-unwind
        handles either exception."""
        label = getattr(engine, "label", None)
        if id(engine) in self._dead:
            raise EngineDead("engine %r is dead (injected)" % (label,))
        for spec in self._firing(("engine_death", "host_drop"), label,
                                 bucket):
            self._dead.add(id(engine))
            if spec.kind == "host_drop":
                raise HostDropped(
                    "host %r dropped at arrival %d (injected)"
                    % (label, self.arrival))
            raise EngineDead("engine %r killed at arrival %d (injected)"
                             % (label, self.arrival))
        for spec in self._firing(("latency",), label, bucket):
            time.sleep(spec.latency_s)
        for _ in self._firing(("dispatch_error",), label, bucket):
            raise InjectedDispatchError(
                "dispatch failed at arrival %d on %r (injected)"
                % (self.arrival, label))

    def on_result(self, engine, bucket: int, out):
        """Consulted by ``ServingEngine._resolve_one`` on the resolved
        host rows: a firing corrupt spec returns a bit-flipped COPY (the
        XOR keeps the corruption silent-looking — right shape/dtype,
        wrong value — exactly what the bit gate must catch)."""
        label = getattr(engine, "label", None)
        for _ in self._firing(("corrupt_shares",), label, bucket):
            bad = np.array(out, copy=True)
            if bad.size:
                bad.flat[0] ^= np.int32(1 << 7)
            self.corruptions.append((label, self.arrival))
            return bad
        return out

    def on_warmup(self, engine, bucket: int) -> None:
        """Consulted before each warmup/probe precompile dispatch: a
        dead engine stays dead, and compile_error specs fire here."""
        label = getattr(engine, "label", None)
        if id(engine) in self._dead:
            raise EngineDead("engine %r is dead (injected)" % (label,))
        for _ in self._firing(("compile_error",), label, bucket):
            raise InjectedCompileError(
                "precompile failed for %r bucket %d (injected)"
                % (label, bucket))

    def on_heartbeat(self, engine) -> None:
        """Consulted by a cluster tier's liveness sweep (``dpf_tpu``'s
        ``ClusterRouter.check_hosts``): a ``host_drop`` spec fires here
        too — with ``bucket=None`` targeting, heartbeats and dispatches
        share the spec — and an already-dropped host's heartbeat keeps
        failing, so host loss is detectable between dispatches."""
        label = getattr(engine, "label", None)
        if id(engine) in self._dead:
            raise HostDropped("host %r is down (injected)" % (label,))
        for _ in self._firing(("host_drop",), label, None):
            self._dead.add(id(engine))
            raise HostDropped(
                "host %r dropped at arrival %d (injected, heartbeat)"
                % (label, self.arrival))

    def is_dead(self, engine) -> bool:
        return id(engine) in self._dead

    def stats(self) -> dict:
        return {"injected": dict(self.injected),
                "corrupted_batches": len(self.corruptions)}


# --------------------------------------------------------------- retry

@dataclasses.dataclass
class RetryPolicy:
    """Bounded retries with exponential backoff and seeded jitter.

    ``max_attempts`` counts the first try; backoff before attempt k+1
    is ``backoff_s * backoff_mult**(k-1) * (1 + jitter * u)`` with u
    drawn from a seeded rng (deterministic sleep schedule under the
    seed).  ``LoadShed`` and ``DeadlineExceeded`` are never retryable:
    admission control and deadlines are *decisions*, not faults —
    retrying them would defeat the mechanisms (and double-count sheds).
    """
    max_attempts: int = 3
    backoff_s: float = 0.005
    backoff_mult: float = 2.0
    jitter: float = 0.5
    seed: int = 0

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError("max_attempts must be >= 1 (got %d)"
                             % self.max_attempts)
        self._rng = np.random.default_rng(self.seed)

    def retryable(self, exc: BaseException) -> bool:
        if isinstance(exc, (LoadShed, DeadlineExceeded)):
            return False
        return isinstance(exc, Exception)

    def backoff(self, attempt: int) -> float:
        """Backoff (seconds) after failed attempt ``attempt`` (1-based)."""
        base = self.backoff_s * self.backoff_mult ** max(0, attempt - 1)
        return base * (1.0 + self.jitter * float(self._rng.random()))

    def sleep(self, attempt: int) -> None:
        dt = self.backoff(attempt)
        if dt > 0:
            time.sleep(dt)


def submit_with_retry(submit, policy: RetryPolicy, stats=None):
    """Run ``submit()`` under ``policy``: on a retryable failure, back
    off and re-try (counting ``stats.retries``) up to ``max_attempts``.
    The callable must be retry-safe — ``ServingEngine.submit``'s
    partial-unwind guarantees the engine is, so wrapping it (or a
    whole-batch resubmit) directly is sound."""
    attempt = 0
    while True:
        attempt += 1
        try:
            return submit()
        except BaseException as e:
            if (not policy.retryable(e)
                    or attempt >= policy.max_attempts):
                raise
            if stats is not None:
                if hasattr(stats, "inc"):
                    stats.inc("retries")
                else:
                    stats.retries += 1
            policy.sleep(attempt)


# ------------------------------------------------------------- breaker

class CircuitBreaker:
    """Per-construction circuit breaker (serve/router.py).

    ``failures`` CONSECUTIVE failures trip closed -> open: the router
    then excludes the construction from the cost-model argmin, so its
    traffic fails over to the healthy engines over the same table.
    After ``reset_s`` the next availability check moves open ->
    half_open exactly once (``should_probe`` returns True); the router
    re-probes via the existing ``ServingEngine.probe`` and reports the
    outcome — success closes the breaker, failure re-opens it with a
    fresh timer.  Any observed SUCCESS closes the breaker from any
    state (real traffic succeeding is stronger evidence than any
    probe).  ``transitions`` records (elapsed_s, state) for the bench.
    """

    STATES = ("closed", "open", "half_open")

    def __init__(self, failures: int = 3, reset_s: float = 30.0,
                 on_open=None, name: str | None = None,
                 tenant: str | None = None):
        if failures < 1:
            raise ValueError("failures must be >= 1 (got %d)" % failures)
        self.failures = int(failures)
        self.reset_s = float(reset_s)
        self.name = name              # construction label (flight events)
        self.tenant = tenant          # owning tenant (flight events)
        self.state = "closed"
        self.consecutive = 0
        self.opened_at = None
        self.on_open = on_open        # callback(breaker) on closed->open
        self.opens = 0
        self._t0 = time.monotonic()
        self.transitions = [(0.0, "closed")]

    def _to(self, state: str) -> None:
        if state == self.state:
            return
        if state == "open":
            self.opened_at = time.monotonic()
            self.opens += 1
        prev = self.state
        self.state = state
        self.transitions.append(
            (round(time.monotonic() - self._t0, 4), state))
        ev = dict(breaker=self.name or "breaker", frm=prev, to=state,
                  consecutive_failures=self.consecutive)
        if self.tenant is not None:
            ev["tenant"] = self.tenant
        FLIGHT.record("breaker", **ev)
        if state == "open" and self.on_open is not None:
            self.on_open(self)

    def record_failure(self) -> str:
        self.consecutive += 1
        if self.state == "half_open":
            self._to("open")          # probe failed: fresh timer
        elif self.state == "closed" and self.consecutive >= self.failures:
            self._to("open")
        elif self.state == "open":
            self.opened_at = time.monotonic()   # still failing: re-arm
        return self.state

    def record_success(self) -> str:
        self.consecutive = 0
        self._to("closed")
        return self.state

    def available(self) -> bool:
        """True when routing may use this construction (closed)."""
        return self.state == "closed"

    def should_probe(self) -> bool:
        """True exactly once per open period after ``reset_s`` elapsed;
        transitions open -> half_open as a side effect."""
        if (self.state == "open" and self.opened_at is not None
                and time.monotonic() - self.opened_at >= self.reset_s):
            self._to("half_open")
            return True
        return self.state == "half_open"

    def as_dict(self) -> dict:
        return {"state": self.state, "opens": self.opens,
                "consecutive_failures": self.consecutive,
                "transitions": [list(t) for t in self.transitions]}

    def __repr__(self):
        return ("CircuitBreaker(state=%s, consecutive=%d/%d, opens=%d)"
                % (self.state, self.consecutive, self.failures,
                   self.opens))


# ---------------------------------------------------------- supervisor

class EngineSupervisor:
    """Detect-and-rebuild for a router's per-construction engines.

    ``notify(label)`` (the router calls it when a submit raises
    ``EngineDead``, or a half-open probe finds a dead engine) rebuilds
    that construction's engine over the SAME prepared server — table
    upload, tuned knobs, and bucket ladder are all reused — and
    re-warms it, by default in a background thread so the router keeps
    serving degraded on the healthy constructions meanwhile.  On
    success the new engine (old counters merged in, so history
    survives the swap) replaces the dead one and
    ``recovery.engine_restarts`` moves; the breaker stays open until
    its half-open re-probe observes the rebuilt engine working.  A
    failed rebuild (injected compile fault, dead-again engine) leaves
    the old engine in place — the next probe failure notifies again.
    """

    def __init__(self, router, background: bool = True):
        self._router = router
        self.background = bool(background)
        self._rebuilding = set()
        self._threads = []
        self._lock = threading.Lock()
        self.failed_rebuilds = 0

    def notify(self, label: str) -> bool:
        """Request a rebuild of ``label``'s engine; returns False when a
        rebuild for it is already in flight."""
        with self._lock:
            if label in self._rebuilding:
                return False
            self._rebuilding.add(label)
        if self.background:
            t = threading.Thread(target=self._rebuild, args=(label,),
                                 name="dpf-rebuild-%s" % label,
                                 daemon=True)
            self._threads.append(t)
            t.start()
        else:
            self._rebuild(label)
        return True

    def _rebuild(self, label: str) -> None:
        r = self._router
        try:
            with span("rebuild", construction=label):
                old = r.engines[label]
                fresh = ServingEngine(r.server(label), buckets=r.buckets,
                                      label=label, injector=r.injector,
                                      **r._engine_kw)
                fresh.warmup()        # re-warm BEFORE taking traffic
                fresh.stats.merge(old.stats)
                r.engines[label] = fresh
            # inc(), not +=: rebuild threads race result() callers on
            # the shared recovery counters
            r.recovery.inc("engine_restarts")
            FLIGHT.record("rebuild", construction=label, ok=True)
        except Exception as e:
            with self._lock:
                self.failed_rebuilds += 1
            FLIGHT.record("rebuild", construction=label, ok=False,
                          error=type(e).__name__)
        finally:
            with self._lock:
                self._rebuilding.discard(label)

    def join(self, timeout: float | None = None) -> None:
        """Wait for outstanding background rebuilds (bench shutdown)."""
        for t in self._threads:
            t.join(timeout)
        self._threads = [t for t in self._threads if t.is_alive()]

    def rebuilding(self) -> tuple:
        with self._lock:
            return tuple(sorted(self._rebuilding))
