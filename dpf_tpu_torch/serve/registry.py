"""Table registry: named, versioned tables with LRU residency on the card.

Port of ``dpf_tpu/serve/registry.py``.  One process serves many tables,
more table bytes than the card should hold.  The registry arbitrates
which of them are resident; the multi-tenant tier (``serve/tenant.py``)
builds on it:

* **Named and versioned**: ``register(name, table)`` uploads a new
  version (monotonic per name); ``acquire(name)`` answers with the
  latest (or an explicit version), so a tenant rolls a table forward
  while queries in flight finish against the version they started on.
* **Byte-budgeted LRU residency**: each version's prepared servers (one
  ``api.DPF`` per construction, ``router.build_servers``) hold the table
  on the device while it is hot.  ``budget_bytes`` bounds the resident
  bytes: registering or promoting past it demotes the least recently
  used unpinned version, which is ``DPF.eval_free`` (the device tensor
  is dropped; each server keeps its padded host table), and a later
  ``acquire`` promotes it again with ``eval_init`` over that same host
  table, so its shares are bit-identical.
* **Pinned versions**: ``acquire`` returns a ``TableLease`` that pins
  the version: a pinned version is never demoted under queries in
  flight.  Pressure marks it ``demote_pending`` and the demotion runs at
  the last release.  The tenant tier releases a lease only after the
  batch's result is back on the host (its part's CUDA event), never at
  enqueue.
* **Observable**: every promotion, demotion, eviction and overcommit is
  a ``FLIGHT.record("registry", ...)`` event and a counter, exported as
  ``dpf_registry_*`` metrics (``obs.metrics.register_table_registry``);
  a promotion's event also carries its wall ``seconds`` (the host
  permutes and the uploads, which the registry lock serializes with
  every other tenant's ``acquire``).

The budget counts the padded bytes of every construction's layout (each
construction uploads its own permutation of the table), so the
resident-bytes gauge is what the device holds: on the card each
promotion or demotion moves ``torch.cuda.memory_allocated()`` by the
version's ``nbytes``.  Every copy runs on the current stream of the
calling thread, which for every thread of the port is the default
stream: a freed table's block is reused only after the kernels queued
before the free, so no ``record_stream`` is needed.

``GranuleStore`` pages one table at a finer grain (row granules), with
``GranulePrefetcher`` promoting cold granules between arrivals.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from ..obs.flight import FLIGHT
from ..utils.profiling import note_swallowed
from .router import LABELS, build_servers

#: registry counter names (all monotonic)
COUNTER_NAMES = ("registrations", "promotions", "demotions", "evictions",
                 "deferred_demotions", "hits", "misses", "overcommits")


class TableVersion:
    """One registered (name, version): the host table, its prepared
    per-construction servers, and its residency state."""

    __slots__ = ("name", "version", "table", "servers", "nbytes",
                 "resident", "pins", "demote_pending", "last_used")

    def __init__(self, name, version, table, servers):
        self.name = name
        self.version = int(version)
        self.table = table            # caller's [N, E] host table
        self.servers = servers        # label -> prepared api.DPF
        # padded device bytes across every construction layout
        self.nbytes = sum(int(s.table.nbytes) for s in servers.values())
        self.resident = True
        self.pins = 0
        self.demote_pending = False
        self.last_used = 0            # registry LRU sequence

    @property
    def key(self) -> tuple:
        return (self.name, self.version)

    def __repr__(self):
        return ("TableVersion(%s@v%d, %.1f MiB, %s%s, pins=%d)"
                % (self.name, self.version, self.nbytes / 2 ** 20,
                   "resident" if self.resident else "host-ram",
                   ", demote_pending" if self.demote_pending else "",
                   self.pins))


class TableLease:
    """A pinned acquisition of one table version (context manager).

    While held, the version stays on the device: queries dispatched
    through ``servers`` complete against the pinned upload even when
    eviction pressure arrives (the demotion waits for the last
    release).  ``release`` is idempotent.
    """

    __slots__ = ("_registry", "_tv", "_released")

    def __init__(self, registry, tv):
        self._registry = registry
        self._tv = tv
        self._released = False

    @property
    def name(self) -> str:
        return self._tv.name

    @property
    def version(self) -> int:
        return self._tv.version

    @property
    def servers(self) -> dict:
        return self._tv.servers

    def server(self, label: str):
        return self._tv.servers[label]

    def release(self) -> None:
        if not self._released:
            self._released = True
            self._registry._release(self._tv)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.release()
        return False


class TableRegistry:
    """Thread-safe named/versioned table store with LRU residency.

    Args:
      budget_bytes: total device bytes the registry may keep resident
        (None = unbounded).  Registering or promoting past the budget
        demotes LRU unpinned versions first; when everything else is
        pinned the registry OVERCOMMITS (serving traffic in flight
        beats enforcing the budget) and counts it.
      labels: construction labels each version prepares (``LABELS`` by
        default: the router's full race).
      prf_method: PRF id shared by every prepared server.
      device: where the servers evaluate (None = CUDA; ``"cpu"`` runs
        the kernels' plain versions).
    """

    def __init__(self, budget_bytes: int | None = None, *,
                 labels=LABELS, prf_method: int = 0, device=None):
        self.budget_bytes = (None if budget_bytes is None
                             else int(budget_bytes))
        self.labels = tuple(labels)
        self.prf_method = int(prf_method)
        self.device = device
        self._tables = {}         # name -> {version -> TableVersion}
        self._lock = threading.RLock()
        self._seq = 0             # LRU clock
        self.counters = {k: 0 for k in COUNTER_NAMES}
        try:
            from ..obs.metrics import register_table_registry
            register_table_registry(self)
        except Exception as e:  # observability must never break serving
            note_swallowed("serve.registry.register_metrics", e)

    # ----------------------------------------------------- registration

    def register(self, name: str, table, version: int | None = None
                 ) -> TableVersion:
        """Upload ``table`` as a new version of ``name`` (the next
        version number when None).  Makes budget room FIRST (the new
        upload is the hottest thing in the process), then builds one
        prepared server per construction."""
        table = np.asarray(table)
        with self._lock:
            versions = self._tables.setdefault(name, {})
            if version is None:
                version = max(versions, default=0) + 1
            version = int(version)
            if version in versions:
                raise ValueError("table %r version %d already registered"
                                 % (name, version))
            self._ensure_budget(self._estimate_bytes(table))
            servers = build_servers(table, self.labels,
                                    prf_method=self.prf_method,
                                    device=self.device)
            tv = TableVersion(name, version, table, servers)
            self._touch(tv)
            versions[version] = tv
            self.counters["registrations"] += 1
            self._event("register", tv)
            return tv

    def _estimate_bytes(self, table) -> int:
        """Device bytes ``register`` will occupy: each construction's
        padded int32 layout (``DPF.eval_init``'s power-of-two pad)."""
        n, e = table.shape
        if n & (n - 1) != 0:
            n = 1 << n.bit_length()
        return n * e * 4 * len(self.labels)

    # ------------------------------------------------------- residency

    def acquire(self, name: str, version: int | None = None
                ) -> TableLease:
        """Pin (and, when cold, promote) a version; the latest when
        ``version`` is None.  Returns a ``TableLease``."""
        with self._lock:
            tv = self._get(name, version)
            if tv.resident:
                self.counters["hits"] += 1
            else:
                self.counters["misses"] += 1
                self._promote(tv)
            tv.pins += 1
            self._touch(tv)
            return TableLease(self, tv)

    def demote(self, name: str, version: int | None = None) -> bool:
        """Drop a version's device residency (the host tables stay).  A
        pinned version only gets ``demote_pending`` (queries in flight
        finish against the pinned upload; the demotion runs at the last
        release).  Returns True when the demotion happened now."""
        with self._lock:
            tv = self._get(name, version)
            return self._demote(tv, action="demote")

    def _get(self, name, version) -> TableVersion:
        versions = self._tables.get(name)
        if not versions:
            raise KeyError("no table registered as %r" % (name,))
        if version is None:
            version = max(versions)
        if version not in versions:
            raise KeyError("table %r has no version %s (have %s)"
                           % (name, version, sorted(versions)))
        return versions[version]

    def _touch(self, tv) -> None:
        self._seq += 1
        tv.last_used = self._seq

    def _promote(self, tv) -> None:
        """Upload a demoted version again: ``eval_init`` over the SAME
        padded host table each server kept, so its shares are
        bit-identical."""
        self._ensure_budget(tv.nbytes, keep=tv)
        t0 = time.perf_counter()
        for srv in tv.servers.values():
            srv.eval_init(srv.table)
        tv.resident = True
        tv.demote_pending = False
        self.counters["promotions"] += 1
        self._event("promote", tv,
                    seconds=round(time.perf_counter() - t0, 6))

    def _demote(self, tv, action: str) -> bool:
        if not tv.resident:
            return False
        if tv.pins > 0:
            if not tv.demote_pending:
                tv.demote_pending = True
                self.counters["deferred_demotions"] += 1
                self._event("demote_deferred", tv)
            return False
        for srv in tv.servers.values():
            srv.eval_free()
        tv.resident = False
        tv.demote_pending = False
        self.counters["demotions"] += 1
        if action == "evict":
            self.counters["evictions"] += 1
        self._event(action, tv)
        return True

    def _ensure_budget(self, need: int, keep=None) -> None:
        """Demote LRU resident unpinned versions until ``need`` more
        bytes fit; overcommit (counted) when everything left is
        pinned."""
        if self.budget_bytes is None:
            return
        while self.resident_bytes + need > self.budget_bytes:
            victims = [tv for tv in self._versions()
                       if tv.resident and tv.pins == 0
                       and tv is not keep]
            if not victims:
                self.counters["overcommits"] += 1
                FLIGHT.record("registry", action="overcommit",
                              need_bytes=int(need),
                              resident_bytes=self.resident_bytes,
                              budget_bytes=self.budget_bytes)
                return
            self._demote(min(victims, key=lambda tv: tv.last_used),
                         action="evict")

    def _release(self, tv) -> None:
        with self._lock:
            tv.pins = max(0, tv.pins - 1)
            if tv.pins == 0 and tv.demote_pending:
                self._demote(tv, action="demote")

    # -------------------------------------------------------- plumbing

    def _versions(self):
        for versions in self._tables.values():
            yield from versions.values()

    @property
    def resident_bytes(self) -> int:
        with self._lock:
            return sum(tv.nbytes for tv in self._versions()
                       if tv.resident)

    def _event(self, action: str, tv, **extra) -> None:
        FLIGHT.record("registry", action=action, table=tv.name,
                      version=tv.version, bytes=tv.nbytes,
                      pins=tv.pins, resident_bytes=self.resident_bytes,
                      **extra)

    def stats(self) -> dict:
        """JSON-ready registry snapshot (benchmark records embed it)."""
        with self._lock:
            return {
                "budget_bytes": self.budget_bytes,
                "resident_bytes": self.resident_bytes,
                "counters": dict(self.counters),
                "tables": [{"name": tv.name, "version": tv.version,
                            "bytes": tv.nbytes,
                            "resident": tv.resident, "pins": tv.pins,
                            "demote_pending": tv.demote_pending}
                           for tv in sorted(self._versions(),
                                            key=lambda t: t.key)],
            }

    def __repr__(self):
        st = self.stats()
        return ("TableRegistry(%d tables, %.1f/%s MiB resident)"
                % (len(st["tables"]), st["resident_bytes"] / 2 ** 20,
                   "inf" if self.budget_bytes is None
                   else "%.1f" % (self.budget_bytes / 2 ** 20)))

    def granule_store(self, name: str, version: int | None = None, *,
                      granule: int, budget_bytes: int | None = None
                      ) -> "GranuleStore":
        """Granule-level residency over one registered version's table,
        on the registry's device.  The store pages the binary tree's
        permuted layout (``expand.permute_table`` of the ``logn``
        server's padded host table), the layout a partial evaluation
        over a leaf range contracts."""
        from ..core import expand
        with self._lock:
            tv = self._get(name, version)
            srv = tv.servers["logn"]
            perm = expand.permute_table(
                np.asarray(srv.table, dtype=np.int32))
            return GranuleStore(perm, granule,
                                budget_bytes=budget_bytes,
                                name="%s@v%d" % (tv.name, tv.version),
                                device=self.device)


# --------------------------------------------------- granule residency

#: granule-store counter names (all monotonic)
GRANULE_COUNTER_NAMES = ("promotions", "demotions", "evictions",
                         "deferred_demotions", "hits", "misses",
                         "prefetches", "prefetch_hits",
                         "prefetch_misses", "overcommits")


class GranuleLease:
    """A pinned acquisition of one device-resident granule (context
    manager), the granule-level twin of ``TableLease``: while held the
    granule is not demoted; pressure marks it ``demote_pending`` and the
    demotion runs at the last release.  ``release`` is idempotent and
    drops the lease's reference to the device buffer, so a demoted
    granule's memory is freed even while a released lease object
    lives on."""

    __slots__ = ("_store", "row0", "table", "_released")

    def __init__(self, store, row0, table):
        self._store = store
        self.row0 = row0
        self.table = table            # the device-resident [granule, E]
        self._released = False

    def release(self) -> None:
        if not self._released:
            self._released = True
            self.table = None
            self._store._release(self.row0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.release()
        return False


class GranuleStore:
    """Granule-level device residency for one permuted table.

    ``TableRegistry`` arbitrates between whole tables; this store
    arbitrates WITHIN one, for a table larger than its device budget.
    The host master copy stays in host RAM; granules (contiguous
    ``granule``-row slices) are promoted to the device on demand
    (``lease``), ahead of demand (``prefetch``, driven by
    ``GranulePrefetcher``), and demoted LRU-first under ``budget_bytes``
    pressure.  A promotion copies the SAME host rows every time
    (``torch.from_numpy(rows).to(device)``, a copy the host waits for),
    so a granule that crosses an eviction comes back bit-identical.

    Pinning follows the registry's lease rule: a leased granule is never
    demoted (pressure defers to the last release, counted as
    ``deferred_demotions``); when every resident granule is pinned the
    store overcommits rather than stall serving (counted).  Thread-safe;
    every transition is a ``FLIGHT.record("registry", granule=...)``
    event and a counter, exported as ``dpf_registry_granule*`` metrics
    (``obs.metrics.register_granule_store``).
    """

    def __init__(self, table_perm, granule: int, *,
                 budget_bytes: int | None = None, name: str = "table",
                 device=None):
        from ..api import resolve_device
        tbl = np.asarray(table_perm, dtype=np.int32)
        n = tbl.shape[0]
        granule = int(granule)
        if granule < 1 or n % granule:
            raise ValueError("granule %d must divide %d rows"
                             % (granule, n))
        self.name = str(name)
        self.device = resolve_device(device)
        self.granule = granule
        self.n, self.entry_size = tbl.shape
        self._host = np.ascontiguousarray(tbl)   # host-RAM master copy
        self.row0s = tuple(range(0, n, granule))
        self.granule_bytes = granule * self.entry_size * 4
        self.budget_bytes = (None if budget_bytes is None
                             else int(budget_bytes))
        self._resident = {}        # row0 -> device [granule, E]
        self._pins = {}            # row0 -> pin count
        self._demote_pending = set()
        self._prefetched = set()   # resident via prefetch, not yet hit
        self._last_used = {}       # row0 -> LRU sequence
        self._seq = 0
        self._page_s = None        # EWMA seconds per promotion
        self._lock = threading.RLock()
        self.counters = {k: 0 for k in GRANULE_COUNTER_NAMES}
        try:
            from ..obs.metrics import register_granule_store
            register_granule_store(self)
        except Exception as e:  # observability must never break serving
            note_swallowed("serve.registry.register_granule_metrics", e)

    # ------------------------------------------------------- residency

    def lease(self, row0: int) -> GranuleLease:
        """Pin granule ``row0`` on the device (promoting a cold one on
        demand) and return its ``GranuleLease``.  A hit on a granule a
        prefetch brought in counts ``prefetch_hits``; a demand promotion
        counts ``prefetch_misses`` (the prefetcher's scoreboard)."""
        with self._lock:
            if row0 in self._resident:
                self.counters["hits"] += 1
                if row0 in self._prefetched:
                    self._prefetched.discard(row0)
                    self.counters["prefetch_hits"] += 1
            else:
                self.counters["misses"] += 1
                self.counters["prefetch_misses"] += 1
                self._promote(row0, prefetch=False)
            self._pins[row0] = self._pins.get(row0, 0) + 1
            self._touch(row0)
            return GranuleLease(self, row0, self._resident[row0])

    def prefetch(self, row0: int | None = None) -> bool:
        """Promote one cold granule (``row0``, or the lowest cold one)
        into FREE budget; a prefetch never evicts (paging ahead of a
        guess must not displace granules demand is using).  Returns True
        when a promotion happened."""
        with self._lock:
            if row0 is None:
                cold = self.cold_row0s()
                if not cold:
                    return False
                row0 = cold[0]
            if row0 in self._resident:
                return False
            if (self.budget_bytes is not None
                    and self.resident_bytes + self.granule_bytes
                    > self.budget_bytes):
                return False
            self._promote(row0, prefetch=True)
            self._prefetched.add(row0)
            self.counters["prefetches"] += 1
            self._touch(row0)
            return True

    def demote(self, row0: int) -> bool:
        """Drop one granule's device buffer (its rows stay in the host
        master copy).  A pinned granule defers to the last release.
        Returns True when the demotion happened now."""
        with self._lock:
            return self._demote(row0, action="granule_demote")

    def demote_all(self) -> int:
        """Demote every unpinned resident granule (another table claimed
        the device).  Returns how many demoted now."""
        with self._lock:
            return sum(self._demote(r, action="granule_demote")
                       for r in list(self._resident))

    # ------------------------------------------------------- internals

    def _touch(self, row0) -> None:
        self._seq += 1
        self._last_used[row0] = self._seq

    def _promote(self, row0, prefetch: bool) -> None:
        if row0 % self.granule or not 0 <= row0 < self.n:
            raise KeyError("granule row0=%d not in store (granule=%d, "
                           "n=%d)" % (row0, self.granule, self.n))
        self._ensure_budget(self.granule_bytes, keep=row0)
        t0 = time.perf_counter()
        # a pageable copy: the host waits for it, so dt is the page-in
        arr = torch.from_numpy(
            self._host[row0:row0 + self.granule]).to(self.device)
        dt = time.perf_counter() - t0
        self._page_s = (dt if self._page_s is None
                        else 0.25 * dt + 0.75 * self._page_s)
        self._resident[row0] = arr
        self._demote_pending.discard(row0)
        self.counters["promotions"] += 1
        self._event("granule_promote", row0, prefetch=prefetch)

    def _demote(self, row0, action: str) -> bool:
        if row0 not in self._resident:
            return False
        if self._pins.get(row0, 0) > 0:
            if row0 not in self._demote_pending:
                self._demote_pending.add(row0)
                self.counters["deferred_demotions"] += 1
                self._event("granule_demote_deferred", row0)
            return False
        del self._resident[row0]      # device buffer freed with the ref
        self._demote_pending.discard(row0)
        self._prefetched.discard(row0)
        self.counters["demotions"] += 1
        if action == "granule_evict":
            self.counters["evictions"] += 1
        self._event(action, row0)
        return True

    def _ensure_budget(self, need: int, keep=None) -> None:
        if self.budget_bytes is None:
            return
        while self.resident_bytes + need > self.budget_bytes:
            victims = [r for r in self._resident
                       if self._pins.get(r, 0) == 0 and r != keep]
            if not victims:
                self.counters["overcommits"] += 1
                FLIGHT.record("registry", action="granule_overcommit",
                              store=self.name, need_bytes=int(need),
                              resident_bytes=self.resident_bytes,
                              budget_bytes=self.budget_bytes)
                return
            self._demote(min(victims,
                             key=lambda r: self._last_used.get(r, 0)),
                         action="granule_evict")

    def _release(self, row0) -> None:
        with self._lock:
            self._pins[row0] = max(0, self._pins.get(row0, 0) - 1)
            if (self._pins[row0] == 0
                    and row0 in self._demote_pending):
                self._demote(row0, action="granule_demote")

    def _event(self, action: str, row0, **extra) -> None:
        FLIGHT.record("registry", action=action, store=self.name,
                      granule=int(row0),
                      pins=self._pins.get(row0, 0),
                      resident=len(self._resident), **extra)

    # -------------------------------------------------------- plumbing

    @property
    def resident_bytes(self) -> int:
        return len(self._resident) * self.granule_bytes

    def resident_row0s(self) -> tuple:
        with self._lock:
            return tuple(sorted(self._resident))

    def cold_row0s(self) -> tuple:
        with self._lock:
            return tuple(r for r in self.row0s
                         if r not in self._resident)

    @property
    def page_s(self) -> float | None:
        """EWMA seconds per granule promotion (None until measured): how
        the prefetcher sizes its window between arrivals."""
        return self._page_s

    def stats(self) -> dict:
        """JSON-ready store snapshot (benchmark records embed it)."""
        with self._lock:
            return {
                "name": self.name,
                "granule": self.granule,
                "granules": len(self.row0s),
                "granules_resident": len(self._resident),
                "granule_bytes": self.granule_bytes,
                "budget_bytes": self.budget_bytes,
                "resident_bytes": self.resident_bytes,
                "page_s_ewma": self._page_s,
                "counters": dict(self.counters),
            }

    def __repr__(self):
        return ("GranuleStore(%s, %d/%d granules resident, %.1f/%s MiB)"
                % (self.name, len(self._resident), len(self.row0s),
                   self.resident_bytes / 2 ** 20,
                   "inf" if self.budget_bytes is None
                   else "%.1f" % (self.budget_bytes / 2 ** 20)))


class GranulePrefetcher:
    """Pages cold granules in BETWEEN arrivals, so the copy overlaps
    serving instead of landing on a query's critical path.

    ``tick()`` runs in idle gaps (after each batch resolves, or on a
    timer) and promotes up to ``max_per_tick`` cold granules into free
    budget.  With ``rates_fn`` (the router's live per-bucket arrival
    rates, ``SchemeRouter.arrival_rates``, or the offline
    ``loadgen.bucket_rates``) the tick sizes itself to the expected idle
    window: at total rate R the next batch lands in ~1/R s, so it starts
    at most ``slack / R / page_s`` promotions (``GranuleStore.page_s``).
    A prefetch never evicts, so a wrong rate costs only colder granules,
    never thrash."""

    def __init__(self, store: GranuleStore, *, rates_fn=None,
                 max_per_tick: int = 4, slack: float = 0.5):
        if max_per_tick < 1:
            raise ValueError("max_per_tick must be >= 1")
        if not 0 < slack <= 1:
            raise ValueError("slack must be in (0, 1] (got %r)"
                             % (slack,))
        self.store = store
        self.rates_fn = rates_fn
        self.max_per_tick = int(max_per_tick)
        self.slack = float(slack)
        self.ticks = 0
        self.promoted = 0

    def budget_this_tick(self) -> int:
        """How many promotions this tick may start: ``max_per_tick``
        capped to what fits the expected idle window."""
        allowed = self.max_per_tick
        page_s = self.store.page_s
        if self.rates_fn is not None and page_s:
            try:
                total_hz = sum(self.rates_fn().values())
            except Exception as e:  # estimator must never break paging
                note_swallowed("serve.registry.prefetch_rates", e)
                total_hz = 0.0
            if total_hz > 0:
                window = self.slack / total_hz
                allowed = min(allowed, max(1, int(window / page_s)))
        return allowed

    def tick(self) -> int:
        """Promote cold granules (lowest row0 first, the dispatch order)
        into free budget; returns how many promotions happened."""
        self.ticks += 1
        done = 0
        for _ in range(self.budget_this_tick()):
            if not self.store.prefetch():
                break
            done += 1
        self.promoted += done
        return done

    def stats(self) -> dict:
        return {"ticks": self.ticks, "promoted": self.promoted,
                "max_per_tick": self.max_per_tick, "slack": self.slack}
