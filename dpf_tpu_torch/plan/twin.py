"""Digital twin of the serve stack: a seeded discrete-event simulator.

The serving tier can only *react* to load; answering "how many engines
does this tenant need to hold p99 under its SLO through tomorrow's
diurnal peak?" needs a model that replays a trace against a candidate
fleet WITHOUT standing the fleet up.  This module is that model: a
discrete-event simulation of ``serve/engine.py`` + ``serve/bench_load.
replay`` driven entirely by a serializable cost table — the same
``(construction, bucket) -> seconds`` map the router's EWMA cost model
learns (``SchemeRouter.cost_table()``) — so a twin run is a pure
function of ``(seed, trace, cost_table, fleet_config)``: bit-identical
event log and summary on every machine, **no device work at all** (the
module imports neither torch nor the rest of the port; a subprocess
that loads it without them proves it).  Port of
``dpf_tpu/plan/twin.py``: the same events and summaries from the same
inputs.

What the twin models, mirroring the real stack piece by piece:

* the **open-loop client** of ``bench_load.replay``: arrivals released
  at their scheduled ``t`` (back-to-back when behind), a single-
  threaded poller holding at most ``window`` unresolved futures,
  per-arrival latency = resolution − *scheduled* arrival;
* the **bucket ladder** (pow2 pad + max-bucket chunking — the ~10
  lines of ``serve/buckets.py`` are reimplemented here standalone and
  parity-tested against the real class);
* **admission control** (``ServingEngine._admit``): queue-depth and
  p99-over-SLO shedding against a bounded latency ring (the real
  ring's nearest-rank quantile, parity-tested against
  ``utils/profiling.quantile``);
* ``max_in_flight`` **backpressure** per simulated device;
* **retry/backoff** (``faults.RetryPolicy``'s exact backoff formula
  with seeded jitter), per-construction **circuit breakers**
  (consecutive-failure trip, ``reset_s`` half-open re-close), and the
  supervised **rebuild delay** after an engine death;
* **faults** replayed from a ``FaultPlan`` dict
  (``FaultPlan.as_dict()``): the injector's decision function — one
  draw of ``np.random.default_rng((seed, spec_idx, arrival+1,
  consult))`` per consult, death kinds capped at one fire — is
  mirrored here exactly and parity-tested against
  ``faults.FaultInjector._decide``.

Two dispatch models, because the cost table measures a *blocking*
dispatch (``ServingEngine.probe``):

* ``dispatch_blocking=True`` (the CPU fidelity model): the dispatch
  call itself consumes the service time in the client thread, as the
  plain versions do on CPU tensors.  The ``--plan`` fidelity gate runs
  it against a CPU server.
* ``dispatch_blocking=False`` (the card's and the fleet's model):
  dispatch is an asynchronous enqueue onto a per-replica serial device
  queue, as a CUDA stream takes the engine's parts; replicas drain in
  parallel, ``max_in_flight`` bounds the per-replica window.  The
  fidelity gate runs it against a server on the card, and the capacity
  planner and autoscaler sweep it, where replicas must overlap.

This module (and the rest of the plan package's pure core) imports
ONLY the stdlib and numpy — never torch, never another package of the
port — so the reproducibility claim is structural, not best-effort.
Flight events are emitted only when ``dpf_tpu_torch.obs.flight`` is
ALREADY loaded (the twin never triggers the package import itself).
"""

from __future__ import annotations

import dataclasses
import heapq  # noqa: F401  (re-exported for planners building event heaps)
import sys
from collections import deque

import numpy as np

#: bounded size of the simulated latency ring — MUST equal
#: utils.profiling.LATENCY_RING (parity-tested) so the twin's p99 shed
#: trigger sees the same window the real engine does
LATENCY_RING = 2048

#: fault kinds the twin replays with timing effect; the remaining real
#: kinds (corrupt_shares, compile_error) are correctness/warmup faults
#: with no steady-state timing signature, so the twin only counts them
TIMED_FAULT_KINDS = ("dispatch_error", "latency", "engine_death",
                     "host_drop")


def _flight(kind: str, **attrs) -> None:
    """Record a flight event IF the flight recorder is already loaded.

    The twin must never import the port's obs itself (the package root
    pulls torch); when a bench/planner process already has it, twin runs
    show up on the same timeline as the real serving events."""
    mod = sys.modules.get("dpf_tpu_torch.obs.flight")
    if mod is not None:
        try:
            mod.FLIGHT.record(kind, **attrs)
        except Exception:
            pass


def quantile(samples, q: float) -> float:
    """Nearest-rank quantile — the exact formula of
    ``utils/profiling.quantile`` (parity-tested), reimplemented so the
    twin's SLO math is the engine's SLO math without importing the
    torch-importing utils package."""
    if not samples:
        raise ValueError("quantile of an empty sample set")
    s = sorted(samples)
    return s[min(len(s) - 1, max(0, int(q * len(s) + 0.5) - 1))]


# ----------------------------------------------------------- cost table


class CostTable:
    """Serializable ``(construction, bucket) -> seconds`` service times.

    The twin's only notion of "how fast is the hardware": one blocking-
    dispatch cost per (construction, bucket), exactly what
    ``SchemeRouter.cost_table()`` exports from its live EWMA model (or
    ``tune.serve_tune.cached_cost_table`` recovers from the tuning
    cache).  Keys serialize as ``"label@bucket"`` — the same spelling
    ``SchemeRouter.stats()["cost_model_ms"]`` uses — so a table embedded
    in a benchmark record is directly auditable against the router's.

    A bucket with no exact entry is estimated from the nearest measured
    bucket of the same construction, scaled linearly by size (bucket
    cost is dominated by the padded batch's device work).
    """

    def __init__(self, costs, overhead_s: float = 0.0):
        self._costs = {}
        for key, s in dict(costs).items():
            if isinstance(key, str):
                lb, bk = key.rsplit("@", 1)
                key = (lb, int(bk))
            self._costs[(str(key[0]), int(key[1]))] = float(s)
        if not self._costs:
            raise ValueError("cost table is empty")
        #: fixed per-batch host overhead (decode/pack), added once per
        #: submitted batch on top of the per-chunk device costs
        self.overhead_s = float(overhead_s)

    def labels(self) -> tuple:
        return tuple(sorted({lb for lb, _ in self._costs}))

    def buckets(self, label: str) -> tuple:
        return tuple(sorted(bk for lb, bk in self._costs if lb == label))

    def service_s(self, label: str, bucket: int) -> float:
        """Service seconds for one blocking dispatch at ``bucket``."""
        hit = self._costs.get((label, bucket))
        if hit is not None:
            return hit
        measured = self.buckets(label)
        if not measured:
            raise KeyError("no costs for construction %r" % (label,))
        nearest = min(measured, key=lambda b: abs(b - bucket))
        return self._costs[(label, nearest)] * (bucket / nearest)

    def as_dict(self) -> dict:
        d = {"%s@%d" % k: v for k, v in sorted(self._costs.items())}
        if self.overhead_s:
            d["overhead_s"] = self.overhead_s
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "CostTable":
        d = dict(d)
        overhead = float(d.pop("overhead_s", 0.0))
        return cls(d, overhead_s=overhead)

    def __repr__(self):
        return "CostTable(%d entries, labels=%s)" % (
            len(self._costs), list(self.labels()))


# ---------------------------------------------------------- fleet config


@dataclasses.dataclass
class FleetConfig:
    """One candidate fleet, fully serializable (twin inputs must be
    auditable from a committed record).

    ``replicas`` maps construction label -> engine-replica count.
    ``bucket_sizes`` is the shared ladder (pow2, like
    ``serve/buckets.py``); ``window`` is the open-loop client's
    unresolved-future bound (``bench_load.replay``'s knob, NOT an
    engine knob).  ``rebuild_s`` is the supervised-rebuild delay after
    an injected engine death (None = dead engines stay dead);
    ``spinup_s`` is the warmup delay before a scaled-up replica takes
    traffic.  ``host_slots`` converts engines to hosts for the
    capacity planner (engines per host)."""
    replicas: dict
    bucket_sizes: tuple = (64, 128, 256, 512)
    max_in_flight: int = 2
    window: int = 8
    max_queue_depth: int | None = None
    slo_s: float | None = None
    shed: bool = False
    dispatch_blocking: bool = True
    retry_max_attempts: int = 3
    retry_backoff_s: float = 0.005
    retry_backoff_mult: float = 2.0
    retry_jitter: float = 0.5
    breaker_failures: int = 5
    breaker_reset_s: float = 30.0
    rebuild_s: float | None = None
    spinup_s: float = 0.2
    host_slots: int = 4
    # ---- HBM paging (the big-table tier): when a replica's share of
    # the table exceeds its device budget, every full-domain dispatch
    # must page the missing bytes host->device; the stall per dispatch
    # is missing_bytes / page_gbps, discounted by prefetch_overlap
    # (the fraction the GranulePrefetcher hides behind in-flight
    # compute).  table_bytes=0 or hbm_bytes_per_replica=None = no
    # paging modeled (the pre-bigtable behavior, field-for-field).
    table_bytes: int = 0
    hbm_bytes_per_replica: int | None = None
    page_gbps: float = 8.0
    prefetch_overlap: float = 0.0

    def __post_init__(self):
        self.replicas = {str(k): int(v)
                         for k, v in dict(self.replicas).items()}
        sizes = sorted({int(s) for s in self.bucket_sizes})
        for s in sizes:
            if s < 1 or (s & (s - 1)) != 0:
                raise ValueError("bucket sizes must be powers of two "
                                 ">= 1 (got %r)" % (s,))
        self.bucket_sizes = tuple(sizes)
        if self.max_in_flight < 1:
            raise ValueError("max_in_flight must be >= 1")
        if self.window < 1:
            raise ValueError("window must be >= 1")
        if self.table_bytes < 0:
            raise ValueError("table_bytes must be >= 0")
        if self.page_gbps <= 0:
            raise ValueError("page_gbps must be > 0")
        if not 0 <= self.prefetch_overlap <= 1:
            raise ValueError("prefetch_overlap must be in [0, 1] "
                             "(got %r)" % (self.prefetch_overlap,))

    # -- the ~10 lines of serve/buckets.py the twin needs, standalone
    #    (parity-tested against the real Buckets)

    @property
    def max_bucket(self) -> int:
        return self.bucket_sizes[-1]

    def bucket_for(self, b: int) -> int:
        """Smallest bucket >= b (``Buckets.bucket_for``)."""
        if b < 1:
            raise ValueError("batch must be >= 1 (got %d)" % b)
        for s in self.bucket_sizes:
            if s >= b:
                return s
        raise ValueError("batch %d exceeds the largest bucket %d"
                         % (b, self.max_bucket))

    def chunks(self, b: int) -> list:
        """Max-bucket spans + remainder (``Buckets.chunks``)."""
        if b < 1:
            raise ValueError("batch must be >= 1 (got %d)" % b)
        spans, lo = [], 0
        while b - lo > self.max_bucket:
            spans.append((lo, lo + self.max_bucket))
            lo += self.max_bucket
        spans.append((lo, b))
        return spans

    def paging_stall_s(self) -> float:
        """Host->device paging stall per full-domain dispatch (0.0
        when paging is not modeled).  A full-domain eval touches every
        table row, so the bytes that don't fit in the replica's device
        budget must stream in on EVERY dispatch:
        ``missing / page_gbps``, discounted by ``prefetch_overlap``."""
        if self.table_bytes == 0 or self.hbm_bytes_per_replica is None:
            return 0.0
        missing = max(0, self.table_bytes - self.hbm_bytes_per_replica)
        return (missing / (self.page_gbps * (1 << 30))
                * (1.0 - self.prefetch_overlap))

    def total_replicas(self) -> int:
        return sum(self.replicas.values())

    def hosts(self) -> int:
        """Hosts needed at ``host_slots`` engines per host."""
        return -(-self.total_replicas() // self.host_slots)

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["bucket_sizes"] = list(self.bucket_sizes)
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "FleetConfig":
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in fields})


# ------------------------------------------------------------ fault mirror


class FaultMirror:
    """The FaultInjector decision function, replayed from a plan dict.

    Mirrors ``serve/faults.FaultInjector`` exactly for the decision
    math (parity-tested against it): each consult draws from
    ``np.random.default_rng((seed, spec_idx, arrival + 1, consult))``,
    ``p >= 1.0`` short-circuits the draw, death kinds
    (engine_death/host_drop) fire at most once, ``max_fires`` bounds
    the rest.  Takes ``FaultPlan.as_dict()`` — a plain dict — so this
    module never imports the torch-importing serve package."""

    _DEFAULTS = dict(construction=None, bucket=None, start=0, stop=None,
                     p=1.0, latency_s=0.05, max_fires=None)

    def __init__(self, plan: dict | None):
        plan = plan or {}
        self.seed = int(plan.get("seed", 0))
        self.specs = [dict(self._DEFAULTS, **s)
                      for s in plan.get("specs", ())]
        self.arrival = -1
        self.injected = {}
        self._consults = {}           # (spec_idx, arrival) -> count
        self._fires = {}              # spec_idx -> total fires

    def begin_arrival(self, j: int) -> None:
        self.arrival = int(j)

    def _matches(self, spec: dict, label, bucket) -> bool:
        if (spec["construction"] is not None
                and label != spec["construction"]):
            return False
        if spec["bucket"] is not None and bucket != spec["bucket"]:
            return False
        if self.arrival < spec["start"]:
            return False
        return spec["stop"] is None or self.arrival < spec["stop"]

    def _fires_left(self, idx: int, spec: dict) -> bool:
        cap = (1 if spec["kind"] in ("engine_death", "host_drop")
               else spec["max_fires"])
        return cap is None or self._fires.get(idx, 0) < cap

    def _decide(self, idx: int, spec: dict) -> bool:
        key = (idx, self.arrival)
        consult = self._consults.get(key, 0)
        self._consults[key] = consult + 1
        if spec["p"] >= 1.0:
            fired = True
        else:
            rng = np.random.default_rng(
                (self.seed, idx, self.arrival + 1, consult))
            fired = bool(rng.random() < spec["p"])
        if fired:
            if not self._fires_left(idx, spec):
                return False
            self._fires[idx] = self._fires.get(idx, 0) + 1
            self.injected[spec["kind"]] = (
                self.injected.get(spec["kind"], 0) + 1)
        return fired

    def firing(self, kinds, label, bucket) -> list:
        """Specs of ``kinds`` firing at the current (label, bucket,
        arrival) — the twin's ``_firing``, eagerly materialized."""
        out = []
        for idx, spec in enumerate(self.specs):
            if (spec["kind"] in kinds and self._fires_left(idx, spec)
                    and self._matches(spec, label, bucket)
                    and self._decide(idx, spec)):
                out.append(spec)
        return out


# ----------------------------------------------------------- sim pieces


class _SimBreaker:
    """CircuitBreaker over virtual time (same closed/open/half_open
    machine as ``faults.CircuitBreaker``, ``time.monotonic`` replaced
    by the sim clock)."""

    __slots__ = ("failures", "reset_s", "state", "consecutive",
                 "opened_at", "opens")

    def __init__(self, failures: int, reset_s: float):
        self.failures = int(failures)
        self.reset_s = float(reset_s)
        self.state = "closed"
        self.consecutive = 0
        self.opened_at = None
        self.opens = 0

    def record_failure(self, now: float) -> None:
        self.consecutive += 1
        if self.state == "half_open":
            self.state, self.opened_at = "open", now
        elif (self.state == "closed"
              and self.consecutive >= self.failures):
            self.state, self.opened_at = "open", now
            self.opens += 1
        elif self.state == "open":
            self.opened_at = now

    def record_success(self) -> None:
        self.consecutive = 0
        self.state = "closed"

    def available(self, now: float) -> bool:
        if (self.state == "open" and self.opened_at is not None
                and now - self.opened_at >= self.reset_s):
            self.state = "half_open"   # re-probe is free in the twin:
            #                            the next success re-closes it
        return self.state in ("closed", "half_open")


class _SimReplica:
    """One simulated engine replica: a serial device queue plus the
    liveness/accounting the fleet model needs."""

    __slots__ = ("label", "rid", "free_t", "inflight", "alive",
                 "draining", "rebuild_at", "busy_s", "alive_spans")

    def __init__(self, label: str, rid: int, born_t: float):
        self.label = label
        self.rid = rid
        self.free_t = born_t        # device available from here
        self.inflight = deque()     # unresolved chunk completion times
        self.alive = True
        self.draining = False
        self.rebuild_at = None
        self.busy_s = 0.0
        self.alive_spans = [[born_t, None]]   # engine-hours integral

    def kill(self, now: float, rebuild_s: float | None) -> None:
        self.alive = False
        self.inflight.clear()
        if self.alive_spans and self.alive_spans[-1][1] is None:
            self.alive_spans[-1][1] = now
        self.rebuild_at = (None if rebuild_s is None
                           else now + rebuild_s)

    def revive(self, now: float) -> None:
        self.alive = True
        self.rebuild_at = None
        self.free_t = max(self.free_t, now)
        self.alive_spans.append([now, None])

    def retire(self, now: float) -> None:
        """Scale-down drain: stop taking work; engine-hours run until
        the queue empties (``free_t``)."""
        self.draining = True
        if self.alive_spans and self.alive_spans[-1][1] is None:
            self.alive_spans[-1][1] = max(now, self.free_t)
        self.alive = False

    def engine_seconds(self, end_t: float) -> float:
        total = 0.0
        for a, b in self.alive_spans:
            total += (end_t if b is None else min(b, end_t)) - a
        return max(0.0, total)


class _Ring:
    """The engine's bounded latency ring (LATENCY_RING samples,
    circular overwrite) — the p99 source of the shed trigger."""

    __slots__ = ("samples", "pos")

    def __init__(self):
        self.samples = []
        self.pos = 0

    def note(self, s: float) -> None:
        if len(self.samples) < LATENCY_RING:
            self.samples.append(s)
        else:
            self.samples[self.pos] = s
            self.pos = (self.pos + 1) % LATENCY_RING

    def p99(self) -> float | None:
        if not self.samples:
            return None
        return quantile(self.samples, 0.99)


class PlannerStats:
    """Process-wide planning counters, exported as ``dpf_plan_*``
    metrics by ``obs.metrics.register_planner`` (the bench registers
    the module singleton ``PLAN_STATS``)."""

    def __init__(self):
        self.twin_runs = 0
        self.sim_arrivals = 0
        self.sim_sheds = 0
        self.sweeps = 0
        self.scale_ups = 0
        self.scale_downs = 0
        self.last_p99_ms = None
        self.last_replicas = None


#: the singleton obs.metrics watches (module-owned, so the weakref
#: registration idiom keeps it alive for the process lifetime)
PLAN_STATS = PlannerStats()


# ------------------------------------------------------------ the twin


class TwinResult:
    """One twin run: the full event log plus derived summary stats.

    ``events`` is a list of plain dicts in simulation order — the
    bit-reproducibility surface (same inputs, identical list).
    ``summary()`` derives the SLO/availability/engine-hours record the
    planner and the fidelity gate consume."""

    def __init__(self, events, lats, ring, served, sheds, shed_q,
                 failed, makespan_s, total_q, route_counts, injected,
                 replicas, fleet, autoscale_log):
        self.events = events
        self.lats = lats
        self._ring = ring
        self.served = served
        self.sheds = sheds
        self.shed_queries = shed_q
        self.failed = failed
        self.makespan_s = makespan_s
        self.total_queries = total_q
        self.route_counts = route_counts
        self.injected = injected
        self._replicas = replicas
        self._fleet = fleet
        self.autoscale_log = autoscale_log

    def p(self, q: float) -> float | None:
        return quantile(self.lats, q) if self.lats else None

    def engine_hours(self) -> float:
        end = self.makespan_s
        return sum(r.engine_seconds(end)
                   for r in self._replicas) / 3600.0

    def summary(self) -> dict:
        n_ans = self.served + self.failed
        lat_ms = {
            "p50_ms": None, "p95_ms": None, "p99_ms": None,
            "max_ms": None}
        if self.lats:
            ms = sorted(x * 1e3 for x in self.lats)
            lat_ms = {
                "p50_ms": round(quantile(ms, 0.50), 3),
                "p95_ms": round(quantile(ms, 0.95), 3),
                "p99_ms": round(quantile(ms, 0.99), 3),
                "max_ms": round(ms[-1], 3)}
        offered = self.served + self.failed + self.sheds
        return {
            "arrivals": offered,
            "served": self.served,
            "failed": self.failed,
            "shed_batches": self.sheds,
            "shed_queries": self.shed_queries,
            "shed_rate": (round(self.sheds / offered, 4)
                          if offered else 0.0),
            "availability": (round(self.served / n_ans, 4)
                             if n_ans else 1.0),
            "makespan_s": round(self.makespan_s, 4),
            "qps": (int((self.total_queries - self.shed_queries)
                        / self.makespan_s)
                    if self.makespan_s > 0 else 0),
            **lat_ms,
            "engine_hours": round(self.engine_hours(), 6),
            "route_counts": dict(self.route_counts),
            "faults_injected": dict(self.injected),
            "replicas_final": {
                lb: sum(1 for r in self._replicas
                        if r.label == lb and r.alive)
                for lb in self._fleet.replicas},
            "autoscale": {
                "ups": sum(1 for e in self.autoscale_log
                           if e["action"] == "up"),
                "downs": sum(1 for e in self.autoscale_log
                             if e["action"] == "down"),
                "log": list(self.autoscale_log)},
        }


def _as_arrivals(trace) -> list:
    """Normalize a trace into [(t, batch)] — accepts ``loadgen.
    Arrival`` duck-types, (t, batch) pairs, or {"t": .., "batch": ..}
    dicts (the serialized spelling a record embeds)."""
    out = []
    for a in trace:
        if hasattr(a, "t") and hasattr(a, "batch"):
            out.append((float(a.t), int(a.batch)))
        elif isinstance(a, dict):
            out.append((float(a["t"]), int(a["batch"])))
        else:
            t, b = a
            out.append((float(t), int(b)))
    return out


def simulate(trace, cost_table, fleet, *, seed: int = 0,
             fault_plan: dict | None = None, autoscaler=None,
             record_events: bool = True) -> TwinResult:
    """Run the digital twin: replay ``trace`` against ``fleet`` with
    service times from ``cost_table``.

    Pure function of ``(seed, trace, cost_table, fleet, fault_plan,
    autoscaler)``: no wall clock, no global state, every random draw
    seeded — two calls with equal inputs return identical ``events``
    lists and summaries.  ``fault_plan`` is a ``FaultPlan.as_dict()``
    dict; ``autoscaler`` an ``autoscale.AutoscalePolicy`` (or any
    object with its ``decide``/``decide_every_s`` surface) evaluated
    over virtual time.
    """
    if isinstance(cost_table, dict):
        cost_table = CostTable.from_dict(cost_table)
    arrivals = _as_arrivals(trace)
    injector = FaultMirror(fault_plan)
    retry_rng = np.random.default_rng((int(seed), 0x5e77))
    events = []

    def ev(_k, **attrs):
        if record_events:
            events.append({"k": _k, **attrs})

    # ---- fleet state -------------------------------------------------
    replicas = []
    for lb, count in sorted(fleet.replicas.items()):
        for i in range(count):
            replicas.append(_SimReplica(lb, len(replicas), 0.0))
    breakers = {lb: _SimBreaker(fleet.breaker_failures,
                                fleet.breaker_reset_s)
                for lb in fleet.replicas}
    ring = _Ring()
    outstanding = deque()       # (submit_t, sched_t, completion_t)
    lats = []
    served = failed = sheds = shed_q = 0
    route_counts = {lb: 0 for lb in fleet.replicas}
    autoscale_log = []
    as_state = {"last_decide": 0.0, "last_change": -1e9,
                "busy_mark": 0.0, "next_rid": len(replicas)}

    def total_busy():
        return sum(r.busy_s for r in replicas)

    def alive_of(lb):
        return [r for r in replicas if r.label == lb and r.alive]

    def revive_due(now):
        for r in replicas:
            if (not r.alive and not r.draining
                    and r.rebuild_at is not None
                    and now >= r.rebuild_at):
                r.revive(now)
                ev("rebuild", t=now, label=r.label, rid=r.rid)

    def backoff_s(attempt):
        # RetryPolicy.backoff with the policy's seeded-jitter shape;
        # the twin uses its own seeded stream (the real policy's rng
        # order depends on wall-clock thread interleaving)
        base = (fleet.retry_backoff_s
                * fleet.retry_backoff_mult ** max(0, attempt - 1))
        return base * (1.0 + fleet.retry_jitter
                       * float(retry_rng.random()))

    def maybe_autoscale(now):
        if autoscaler is None:
            return
        if now - as_state["last_decide"] < autoscaler.decide_every_s:
            return
        dt = now - as_state["last_decide"]
        as_state["last_decide"] = now
        n_alive = sum(1 for r in replicas if r.alive)
        busy = total_busy()
        util = ((busy - as_state["busy_mark"]) / (dt * n_alive)
                if n_alive and dt > 0 else 0.0)
        as_state["busy_mark"] = busy
        action = autoscaler.decide(
            util=util, p99_s=ring.p99(), slo_s=fleet.slo_s,
            replicas=n_alive,
            since_change_s=now - as_state["last_change"])
        if action is None:
            return
        if action == "up":
            # replicate the construction with the most traffic so far
            lb = max(route_counts, key=lambda l: (route_counts[l], l))
            r = _SimReplica(lb, as_state["next_rid"], now)
            r.free_t = now + fleet.spinup_s
            as_state["next_rid"] += 1
            replicas.append(r)
            PLAN_STATS.scale_ups += 1
        else:
            # retire the emptiest alive replica, respecting min bound
            cands = [r for r in replicas if r.alive]
            if len(cands) <= 1:
                return
            r = min(cands, key=lambda x: (x.free_t, x.rid))
            r.retire(now)
            PLAN_STATS.scale_downs += 1
        as_state["last_change"] = now
        entry = {"t": round(now, 6), "action": action,
                 "label": r.label, "rid": r.rid,
                 "replicas": sum(1 for x in replicas if x.alive),
                 "util": round(util, 4)}
        autoscale_log.append(entry)
        ev("autoscale", **entry)
        _flight("plan_autoscale", **entry)

    # ---- the open-loop client (bench_load.replay over virtual time) --
    now = 0.0

    def resolve_oldest():
        nonlocal now
        sub_t, sched_t, comp_t = outstanding.popleft()
        now = max(now, comp_t)
        lats.append(now - sched_t)
        ring.note(now - sub_t)

    for j, (at, batch) in enumerate(arrivals):
        while now < at:
            if outstanding:
                resolve_oldest()
            else:
                now = at
        while len(outstanding) >= fleet.window:
            resolve_oldest()
        revive_due(now)
        maybe_autoscale(now)
        injector.begin_arrival(j)
        PLAN_STATS.sim_arrivals += 1
        submit_t = now

        # ---- admission control (ServingEngine._admit) ----------------
        over_depth = (fleet.max_queue_depth is not None
                      and len(outstanding) >= fleet.max_queue_depth)
        over_slo = False
        if fleet.slo_s is not None and outstanding:
            p99 = ring.p99()
            over_slo = p99 is not None and p99 > fleet.slo_s
        if fleet.shed and (over_depth or over_slo):
            sheds += 1
            shed_q += batch
            PLAN_STATS.sim_sheds += 1
            ev("shed", j=j, t=now, batch=batch,
               reason="queue_depth" if over_depth else "p99_over_slo")
            continue
        while (fleet.max_queue_depth is not None
               and len(outstanding) >= fleet.max_queue_depth):
            resolve_oldest()

        # ---- route + dispatch with retry/failover --------------------
        attempt = 0
        excluded = set()
        comp_t = None
        while True:
            attempt += 1
            avail = [lb for lb in sorted(fleet.replicas)
                     if lb not in excluded and alive_of(lb)
                     and breakers[lb].available(now)]
            if not avail:
                avail = [lb for lb in sorted(fleet.replicas)
                         if lb not in excluded and alive_of(lb)]
            if not avail:
                failed += 1
                ev("fail", j=j, t=now, batch=batch,
                   reason="no_alive_replica")
                break
            bucket0 = fleet.bucket_for(min(batch, fleet.max_bucket))
            label = min(avail,
                        key=lambda lb: cost_table.service_s(lb,
                                                            bucket0))
            rep = min(alive_of(label), key=lambda r: (r.free_t, r.rid))
            try:
                comp_t, now = _dispatch(rep, batch, fleet, cost_table,
                                        injector, label, now)
            except _SimFault as f:
                now = f.now
                breakers[label].record_failure(now)
                if f.kind in ("engine_death", "host_drop"):
                    rep.kill(now, fleet.rebuild_s)
                    ev("death", j=j, t=now, label=label, rid=rep.rid,
                       kind=f.kind)
                    if not alive_of(label):
                        excluded.add(label)
                if attempt >= fleet.retry_max_attempts:
                    failed += 1
                    ev("fail", j=j, t=now, batch=batch,
                       reason=f.kind, attempts=attempt)
                    break
                if f.kind not in ("engine_death", "host_drop"):
                    now += backoff_s(attempt)
                ev("retry", j=j, t=now, label=label, attempt=attempt,
                   reason=f.kind)
                continue
            breakers[label].record_success()
            route_counts[label] = route_counts.get(label, 0) + 1
            served += 1
            outstanding.append((submit_t, at, comp_t))
            ev("serve", j=j, t=now, label=label, rid=rep.rid,
               batch=batch, comp=comp_t, attempt=attempt)
            break

    while outstanding:
        resolve_oldest()

    makespan = now if arrivals else 0.0
    total_q = sum(b for _, b in arrivals)
    PLAN_STATS.twin_runs += 1
    result = TwinResult(events, lats, ring, served, sheds, shed_q,
                        failed, makespan, total_q, route_counts,
                        injector.injected, replicas, fleet,
                        autoscale_log)
    if lats:
        PLAN_STATS.last_p99_ms = round(quantile(lats, 0.99) * 1e3, 3)
    PLAN_STATS.last_replicas = sum(1 for r in replicas if r.alive)
    _flight("plan_twin", arrivals=len(arrivals), served=served,
            sheds=sheds, failed=failed,
            p99_ms=PLAN_STATS.last_p99_ms)
    return result


class _SimFault(Exception):
    """An injected fault inside a simulated dispatch; carries the sim
    clock at the moment of failure."""

    def __init__(self, kind: str, now: float):
        super().__init__(kind)
        self.kind = kind
        self.now = now


def _dispatch(rep: _SimReplica, batch: int, fleet: FleetConfig,
              cost: CostTable, injector: FaultMirror, label: str,
              now: float) -> tuple:
    """Simulate one ``ServingEngine.submit``: chunk, pad, consult the
    injector at the per-chunk dispatch point, and advance time.

    Returns ``(completion_t, new_now)``.  Raises ``_SimFault`` on an
    injected failure — the caller unwinds exactly like the real
    partial-unwind (the simulated device has no orphaned state to
    clean up)."""
    now += cost.overhead_s
    comp = now
    for lo, hi in fleet.chunks(batch):
        size = fleet.bucket_for(hi - lo)
        # injection points, in FaultInjector.on_dispatch's kind order
        deaths = injector.firing(("engine_death", "host_drop"), label,
                                 size)
        if deaths:
            raise _SimFault(deaths[0]["kind"], now)
        extra = sum(s["latency_s"] for s in
                    injector.firing(("latency",), label, size))
        if injector.firing(("dispatch_error",), label, size):
            raise _SimFault("dispatch_error", now + extra)
        svc = cost.service_s(label, size) + extra + fleet.paging_stall_s()
        rep.busy_s += svc
        if fleet.dispatch_blocking:
            # CPU model: the dispatch call computes synchronously in
            # the client thread (what ServingEngine.probe measured)
            now += svc
            comp = now
            rep.free_t = max(rep.free_t, now)
        else:
            # the card's model: async enqueue onto the replica's serial
            # device queue, max_in_flight bounding the window
            while len(rep.inflight) >= fleet.max_in_flight:
                now = max(now, rep.inflight.popleft())
            start = max(now, rep.free_t)
            done = start + svc
            rep.free_t = done
            rep.inflight.append(done)
            comp = done
    return comp, now
