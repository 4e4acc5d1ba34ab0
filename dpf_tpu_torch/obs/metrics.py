"""Typed metrics registry with OpenMetrics/Prometheus text export.

Port of ``dpf_tpu/obs/metrics.py``.  The serving stack keeps its
counters in ``EngineCounters``, the swallowed-error registry, the
breakers and the router's EWMA cost table; this module gives them one
registry that a scrape reads:

* **Primitives**: ``Counter`` (monotonic), ``Gauge`` (set / inc),
  ``Histogram`` (fixed buckets, cumulative counts).  Label-aware
  (``.labels(construction="logn").inc()``) and thread-safe: rebuild
  threads, tenant workers and ``result()`` callers write concurrently.
* **Collectors**: live objects export through callbacks run at scrape
  time and held by WEAK reference, so a collected engine's series leave
  the next scrape.  ``ServingEngine``, ``SchemeRouter``,
  ``TableRegistry``, ``GranuleStore`` and ``TenantRouter`` register
  themselves when built; the process-wide series (swallowed errors,
  tracer and flight-recorder meta) are registered once at import.  The
  port has no compile cache, so it exports no ``dpf_cache_*`` series.
* **Exports**: ``openmetrics()`` renders the text exposition (``# TYPE``
  / ``# HELP``, ``_total`` counter samples, ``le`` buckets, ``# EOF``)
  and ``snapshot()`` the JSON form benchmark records embed.

The JAX module's ``register_cluster``, ``register_planner`` and
``set_process_index`` wait for the port's multi-GPU and planning items.
"""

from __future__ import annotations

import json
import threading
import weakref

#: default histogram bucket upper bounds (seconds) for serving
#: latencies: the ladder ``EngineCounters`` accumulates into, so
#: ``observe_counts`` folds engine histograms in without resampling
from ..utils.profiling import LATENCY_HIST_BUCKETS_S as LATENCY_BUCKETS_S


def _label_key(labels: dict) -> tuple:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _render_labels(key: tuple, extra: tuple = ()) -> str:
    items = list(key) + list(extra)
    if not items:
        return ""
    return "{%s}" % ",".join('%s="%s"' % (k, str(v).replace('"', r'\"'))
                             for k, v in items)


def _fmt(v) -> str:
    if isinstance(v, float) and v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


class _Metric:
    """Shared label/value plumbing; subclasses define ``kind``."""

    kind = "untyped"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._values = {}            # label key tuple -> state

    def labels(self, **labels) -> "_Child":
        return _Child(self, _label_key(labels))

    def _zero(self):
        return 0.0

    def _get(self, key: tuple):
        with self._lock:
            if key not in self._values:
                self._values[key] = self._zero()
            return self._values[key]

    def samples(self) -> list:
        """[(suffix, label_key, extra_labels, value)] for rendering."""
        with self._lock:
            return [("", k, (), v) for k, v in sorted(self._values.items())]

    def snapshot_value(self, state):
        return state


class _Child:
    __slots__ = ("_m", "_key")

    def __init__(self, metric, key):
        self._m = metric
        self._key = key

    def inc(self, amount=1):
        return self._m.inc(amount, _key=self._key)

    def set(self, value):
        return self._m.set(value, _key=self._key)

    def observe(self, value):
        return self._m.observe(value, _key=self._key)

    @property
    def value(self):
        return self._m._get(self._key)


class Counter(_Metric):
    kind = "counter"

    def inc(self, amount=1, *, _key=()):
        if amount < 0:
            raise ValueError("counters only go up (got %r)" % (amount,))
        with self._lock:
            self._values[_key] = self._values.get(_key, 0.0) + amount

    @property
    def value(self):
        return self._get(())

    def samples(self) -> list:
        with self._lock:
            return [("_total", k, (), v)
                    for k, v in sorted(self._values.items())]


class Gauge(_Metric):
    kind = "gauge"

    def set(self, value, *, _key=()):
        with self._lock:
            self._values[_key] = float(value)

    def inc(self, amount=1, *, _key=()):
        with self._lock:
            self._values[_key] = self._values.get(_key, 0.0) + amount

    @property
    def value(self):
        return self._get(())


class Histogram(_Metric):
    """Fixed-bucket cumulative histogram (+Inf implicit)."""

    kind = "histogram"

    def __init__(self, name, help="", buckets=LATENCY_BUCKETS_S):
        super().__init__(name, help)
        self.buckets = tuple(sorted(float(b) for b in buckets))
        if not self.buckets:
            raise ValueError("need at least one bucket bound")

    def _zero(self):
        return {"counts": [0] * (len(self.buckets) + 1),
                "sum": 0.0, "count": 0}

    def observe(self, value, *, _key=()):
        v = float(value)
        with self._lock:
            st = self._values.setdefault(_key, self._zero())
            i = 0
            while i < len(self.buckets) and v > self.buckets[i]:
                i += 1
            st["counts"][i] += 1
            st["sum"] += v
            st["count"] += 1

    def observe_counts(self, counts, sum_, count, *, _key=()):
        """Fold pre-aggregated per-bucket counts in (the
        ``EngineCounters`` histogram: the engine observes, the registry
        only renders)."""
        with self._lock:
            st = self._values.setdefault(_key, self._zero())
            for i, c in enumerate(counts):
                st["counts"][i] += int(c)
            st["sum"] += float(sum_)
            st["count"] += int(count)

    def samples(self) -> list:
        out = []
        with self._lock:
            for k, st in sorted(self._values.items()):
                acc = 0
                for b, c in zip(self.buckets, st["counts"]):
                    acc += c
                    out.append(("_bucket", k, (("le", _fmt(b)),), acc))
                out.append(("_bucket", k, (("le", "+Inf"),),
                            st["count"]))
                out.append(("_sum", k, (), st["sum"]))
                out.append(("_count", k, (), st["count"]))
        return out

    def snapshot_value(self, state):
        return {"buckets": dict(zip([_fmt(b) for b in self.buckets]
                                    + ["+Inf"], state["counts"])),
                "sum": round(state["sum"], 6), "count": state["count"]}


class MetricsRegistry:
    """Named metrics + weakly-held collectors; render on demand.

    ``counter`` / ``gauge`` / ``histogram`` create-or-return by name
    (re-registration with a different kind raises: one meaning per
    name).  ``register_collector(fn)`` adds a scrape-time callback
    ``fn() -> iterable of (name, kind, help, labels_dict, value)``; a
    callback that raises ``ReferenceError`` or returns None is pruned
    (the convention ``watch()`` uses when its object is gone).
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics = {}
        self._collectors = []

    def _named(self, cls, name, help, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, help, **kw)
            elif not isinstance(m, cls):
                raise ValueError(
                    "metric %r already registered as %s (wanted %s)"
                    % (name, m.kind, cls.kind))
            return m

    def counter(self, name, help="") -> Counter:
        return self._named(Counter, name, help)

    def gauge(self, name, help="") -> Gauge:
        return self._named(Gauge, name, help)

    def histogram(self, name, help="",
                  buckets=LATENCY_BUCKETS_S) -> Histogram:
        return self._named(Histogram, name, help, buckets=buckets)

    def register_collector(self, fn) -> None:
        with self._lock:
            self._collectors.append(fn)

    def watch(self, obj, emit) -> None:
        """Register ``emit(obj) -> samples`` bound to a WEAK reference:
        once ``obj`` is collected the callback prunes itself from the
        next scrape (tests and benches build many short-lived engines;
        strong references here would keep them all)."""
        ref = weakref.ref(obj)

        def _collect():
            o = ref()
            if o is None:
                return None          # prune
            return emit(o)
        self.register_collector(_collect)

    def _collected(self) -> list:
        """Run the collectors (pruning dead ones); returns the dynamic
        sample tuples (name, kind, help, labels, value)."""
        with self._lock:
            collectors = list(self._collectors)
        out, dead = [], []
        for fn in collectors:
            try:
                samples = fn()
            except ReferenceError:
                samples = None
            except Exception as e:   # a broken collector must never
                # break the scrape, but stays diagnosable
                from ..utils.profiling import note_swallowed
                note_swallowed("obs.metrics.collector", e)
                continue
            if samples is None:
                dead.append(fn)
                continue
            out.extend(samples)
        if dead:
            with self._lock:
                self._collectors = [c for c in self._collectors
                                    if c not in dead]
        return out

    def openmetrics(self) -> str:
        """The OpenMetrics/Prometheus text exposition of every static
        metric and collected sample, ``# EOF``-terminated."""
        lines = []
        with self._lock:
            metrics = [self._metrics[k] for k in sorted(self._metrics)]
        families = {}               # name -> (kind, help, [sample line])
        for m in metrics:
            rows = families.setdefault(m.name, (m.kind, m.help, []))[2]
            for suffix, key, extra, v in m.samples():
                rows.append("%s%s%s %s" % (m.name, suffix,
                                           _render_labels(key, extra),
                                           _fmt(v)))
        for name, kind, help, labels, v in self._collected():
            rows = families.setdefault(name, (kind, help, []))[2]
            key = _label_key(labels)
            if kind == "histogram":
                # v: {"buckets": [bounds], "counts": [n+1], "sum", "count"}
                acc = 0
                for b, c in zip(v["buckets"], v["counts"]):
                    acc += c
                    rows.append("%s_bucket%s %s" % (
                        name, _render_labels(key, (("le", _fmt(b)),)),
                        _fmt(acc)))
                rows.append("%s_bucket%s %s" % (
                    name, _render_labels(key, (("le", "+Inf"),)),
                    _fmt(v["count"])))
                rows.append("%s_sum%s %s" % (name, _render_labels(key),
                                             _fmt(v["sum"])))
                rows.append("%s_count%s %s" % (name, _render_labels(key),
                                               _fmt(v["count"])))
                continue
            suffix = "_total" if kind == "counter" else ""
            rows.append("%s%s%s %s" % (name, suffix, _render_labels(key),
                                       _fmt(v)))
        for name in sorted(families):
            kind, help, rows = families[name]
            if help:
                lines.append("# HELP %s %s" % (name, help))
            lines.append("# TYPE %s %s" % (name, kind))
            lines.extend(rows)
        lines.append("# EOF")
        return "\n".join(lines) + "\n"

    def snapshot(self) -> dict:
        """JSON-ready registry dump (benchmark records embed this)."""
        out = {}
        with self._lock:
            metrics = [self._metrics[k] for k in sorted(self._metrics)]
        for m in metrics:
            with m._lock:
                series = {(_render_labels(k) or "()"):
                          m.snapshot_value(v)
                          for k, v in sorted(m._values.items())}
            out[m.name] = {"kind": m.kind, "series": series}
        for name, kind, help, labels, v in self._collected():
            fam = out.setdefault(name, {"kind": kind, "series": {}})
            if isinstance(v, float):
                v = round(v, 6)
            fam["series"][_render_labels(_label_key(labels)) or "()"] = v
        json.dumps(out)              # must stay embeddable
        return out


#: the process registry everything self-registers into
REGISTRY = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    return REGISTRY


def observe_keygen(construction: str, batch: int, seconds: float,
                   registry: MetricsRegistry | None = None) -> None:
    """Record one batched-keygen call: keys made and wall seconds,
    labelled by ``construction`` ("logn.r2" / "logn.r4" / "sqrtn.r2")
    and the batch size.  ``DPF.gen_batch`` calls it on every batch, so
    keys/s per construction is ``dpf_keygen_keys_total /
    dpf_keygen_seconds_sum`` in any scrape."""
    reg = registry or REGISTRY
    labels = {"construction": str(construction), "batch": int(batch)}
    reg.counter(
        "dpf_keygen_keys",
        "DPF keys generated by batched keygen").labels(**labels).inc(
            int(batch))
    reg.counter(
        "dpf_keygen_batches",
        "Batched keygen calls").labels(**labels).inc()
    reg.histogram(
        "dpf_keygen_seconds",
        "Batched keygen wall time per call (s)").labels(
            **labels).observe(float(seconds))


# ----------------------------------------------- first-class exporters

#: EngineCounters fields exported per engine (counter semantics)
_ENGINE_COUNTER_FIELDS = (
    "batches_submitted", "queries_submitted", "dispatches",
    "padded_queries", "deadline_misses", "shed_batches", "shed_queries",
    "retries", "failovers", "breaker_opens", "engine_restarts",
    "swallowed_errors")
_ENGINE_TIME_FIELDS = ("pack_time_s", "dispatch_time_s", "wait_time_s")


def engine_samples(counters, labels: dict) -> list:
    """Sample tuples for one ``EngineCounters`` (shared by the
    per-engine watcher and a router's aggregate)."""
    out = []
    for f in _ENGINE_COUNTER_FIELDS:
        out.append(("dpf_engine_" + f, "counter",
                    "EngineCounters." + f, labels,
                    float(getattr(counters, f))))
    for f in _ENGINE_TIME_FIELDS:
        out.append(("dpf_engine_" + f.replace("_s", "_seconds"),
                    "counter", "EngineCounters." + f, labels,
                    float(getattr(counters, f))))
    out.append(("dpf_engine_in_flight_hwm", "gauge",
                "dispatch-window high-water mark", labels,
                float(counters.in_flight_hwm)))
    for q, name in ((0.5, "p50"), (0.95, "p95"), (0.99, "p99")):
        v = counters.quantile(q)
        if v is not None:
            out.append(("dpf_engine_latency_%s_seconds" % name, "gauge",
                        "latency-ring nearest-rank quantile", labels, v))
    hist = getattr(counters, "latency_histogram", None)
    if callable(hist):
        h = hist()
        if h["count"]:
            out.append(("dpf_engine_latency_seconds", "histogram",
                        "per-batch submit->result latency "
                        "(fixed buckets; ring has exact quantiles)",
                        labels, h))
    return out


def _with_tenant(labels: dict, obj) -> dict:
    """Merge an object's ``tenant`` attribute into a sample's labels:
    the multi-tenant tier (``serve/tenant.py``) stamps routers, engines
    and breakers, so every per-tenant series filters by ``tenant=``."""
    t = getattr(obj, "tenant", None)
    if t is None or "tenant" in labels:
        return labels
    out = dict(labels)
    out["tenant"] = str(t)
    return out


def register_engine(engine, registry: MetricsRegistry | None = None):
    """Export one engine's ``EngineCounters`` as
    ``dpf_engine_*{engine=...}`` series (weakly held; a ``tenant``
    attribute on the engine adds a ``tenant=`` label)."""
    reg = registry or REGISTRY
    label = getattr(engine, "label", None) or "engine-%x" % id(engine)

    def emit(e):
        return engine_samples(e.stats, _with_tenant({"engine": label}, e))
    reg.watch(engine, emit)


def register_router(router, registry: MetricsRegistry | None = None):
    """Export a ``SchemeRouter``'s breaker states, EWMA cost table and
    routing counts as first-class series (weakly held)."""
    reg = registry or REGISTRY
    states = {"closed": 0.0, "open": 1.0, "half_open": 2.0}

    def emit(r):
        out = []
        for lb, br in r.breakers.items():
            out.append(("dpf_breaker_state", "gauge",
                        "0=closed 1=open 2=half_open",
                        {"construction": lb}, states.get(br.state, -1.0)))
            out.append(("dpf_breaker_opens", "counter",
                        "closed->open transitions",
                        {"construction": lb}, float(br.opens)))
        kern_of = getattr(r, "dispatch_kernel", None)
        for (lb, bucket), s in sorted(r._costs.items()):
            labels = {"construction": lb, "bucket": bucket}
            if callable(kern_of):
                # the kernel family the construction dispatches at this
                # bucket ("fused" or "dispatch"), so a cost shift is
                # attributable to kernel selection
                kern = kern_of(lb, bucket)
                if kern is not None:
                    labels["kernel"] = kern
            out.append(("dpf_router_cost_seconds", "gauge",
                        "EWMA per-dispatch cost estimate", labels, s))
        for lb, c in r.route_counts.items():
            out.append(("dpf_router_routes", "counter",
                        "batches routed per construction",
                        {"construction": lb}, float(c)))
        for src, c in r.routed_from_counts.items():
            out.append(("dpf_router_routed_from", "counter",
                        "routing-decision provenance",
                        {"source": src}, float(c)))
        return [(n, k, h, _with_tenant(l, r), v) for n, k, h, l, v in out]
    reg.watch(router, emit)


def register_table_registry(registry_obj,
                            registry: MetricsRegistry | None = None):
    """Export a ``serve.registry.TableRegistry``'s residency state
    (budget and resident bytes, promotion / demotion / eviction
    counters, a residency gauge per (table, version)) as
    ``dpf_registry_*`` series (weakly held)."""
    reg = registry or REGISTRY

    def emit(r):
        out = []
        st = r.stats()
        if st["budget_bytes"] is not None:
            out.append(("dpf_registry_budget_bytes", "gauge",
                        "configured device-residency byte budget", {},
                        float(st["budget_bytes"])))
        out.append(("dpf_registry_resident_bytes", "gauge",
                    "device bytes currently resident", {},
                    float(st["resident_bytes"])))
        for f in ("promotions", "demotions", "evictions",
                  "deferred_demotions", "hits", "misses",
                  "overcommits"):
            out.append(("dpf_registry_" + f, "counter",
                        "TableRegistry residency counter", {},
                        float(st["counters"][f])))
        for row in st["tables"]:
            out.append(("dpf_registry_table_resident", "gauge",
                        "1=device-resident 0=demoted to host RAM",
                        {"table": row["name"],
                         "version": row["version"]},
                        1.0 if row["resident"] else 0.0))
        return out
    reg.watch(registry_obj, emit)


def register_granule_store(store_obj,
                           registry: MetricsRegistry | None = None):
    """Export a ``serve.registry.GranuleStore``'s granule residency (the
    resident-granule gauge and the promotion / demotion / prefetch
    counters) as ``dpf_registry_granule*{store=...}`` series (weakly
    held).  Granule ids ride the flight recorder's ``registry`` events;
    metrics carry the aggregate."""
    reg = registry or REGISTRY

    def emit(s):
        out = []
        st = s.stats()
        lbl = {"store": st["name"]}
        out.append(("dpf_registry_granules_resident", "gauge",
                    "granules currently device-resident", lbl,
                    float(st["granules_resident"])))
        out.append(("dpf_registry_granule_resident_bytes", "gauge",
                    "device bytes resident at granule grain", lbl,
                    float(st["resident_bytes"])))
        if st["budget_bytes"] is not None:
            out.append(("dpf_registry_granule_budget_bytes", "gauge",
                        "configured granule-residency byte budget", lbl,
                        float(st["budget_bytes"])))
        for f in ("promotions", "demotions", "evictions",
                  "deferred_demotions", "hits", "misses", "prefetches",
                  "prefetch_hits", "prefetch_misses", "overcommits"):
            out.append(("dpf_registry_granule_" + f, "counter",
                        "GranuleStore residency counter", lbl,
                        float(st["counters"][f])))
        return out
    reg.watch(store_obj, emit)


def register_tenants(tenant_router,
                     registry: MetricsRegistry | None = None):
    """Export a ``serve.tenant.TenantRouter``'s scheduler state (queue
    depth, in-flight quota use, DRR deficit, weight and the dispatch /
    shed counters) as ``dpf_tenant_*{tenant=...}`` series (weakly
    held).  The per-tenant routers and engines register their own
    series with the ``tenant=`` label."""
    reg = registry or REGISTRY

    def emit(tr):
        out = []
        for name, ts in tr.tenants.items():
            labels = {"tenant": name}
            out.append(("dpf_tenant_weight", "gauge",
                        "weighted-fair scheduling weight", labels,
                        float(ts.spec.weight)))
            out.append(("dpf_tenant_queue_depth", "gauge",
                        "batches pending in the tenant queue", labels,
                        float(len(ts.queue))))
            out.append(("dpf_tenant_in_flight", "gauge",
                        "dispatched-but-unresolved batches", labels,
                        float(ts.in_flight)))
            out.append(("dpf_tenant_deficit", "gauge",
                        "deficit-round-robin credit (queries)", labels,
                        float(ts.deficit)))
            for f in ("submitted", "dispatched", "shed_batches",
                      "shed_queries", "quota_defers"):
                out.append(("dpf_tenant_" + f, "counter",
                            "tenant scheduler counter", labels,
                            float(getattr(ts, f))))
        return out
    reg.watch(tenant_router, emit)


def _process_samples():
    """The process-wide series: the swallowed-error registry and the
    tracer's and flight recorder's meta counters (registered once at
    import)."""
    from ..utils.profiling import swallowed_snapshot
    out = []
    for site, by_cls in swallowed_snapshot().items():
        for cls, n in sorted(by_cls.items()):
            out.append(("dpf_swallowed_errors", "counter",
                        "note_swallowed registry",
                        {"site": site, "cls": cls}, float(n)))
    from . import tracer as _tracer
    t = _tracer.get_tracer()
    if t is not None:
        out.append(("dpf_trace_spans_recorded", "counter",
                    "spans landed in the tracer ring", {},
                    float(t.recorded)))
        out.append(("dpf_trace_spans_dropped", "counter",
                    "spans evicted from the full ring", {},
                    float(t.dropped)))
    from .flight import FLIGHT
    out.append(("dpf_flight_events", "counter",
                "events landed in the flight recorder", {},
                float(FLIGHT.recorded)))
    out.append(("dpf_flight_events_dropped", "counter",
                "events evicted from the full flight ring "
                "(widen with DPF_FLIGHT_RING)", {},
                float(getattr(FLIGHT, "dropped", 0))))
    return out


REGISTRY.register_collector(_process_samples)
