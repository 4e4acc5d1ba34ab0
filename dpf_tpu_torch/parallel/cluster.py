"""Multi-host serving cluster: a row-sharded table, a scatter/gather
front end and a host-loss recovery state machine (port of
``dpf_tpu/parallel/cluster.py``).

**Sharding.**  The bit-reverse-permuted table splits into ``hosts``
contiguous granules of ``n // hosts`` rows.  Each host wraps its
granules in a ``ClusterShardServer`` whose dispatch runs
``sharded.eval_leaf_range_local`` per granule (the partial evaluation
over just those rows: K2's leaf-range form for the stream ciphers, K1
and K3 for AES) and sums the partials on its device.  Partial shares of
disjoint row ranges sum (wrapping) to the full-table share, so the
``ClusterRouter`` scatters each batch to every covering host and merges
the partials with a wrapping int32 sum, equal to a one-device eval.
Nothing is compiled per granule, so recovery moves granules between
hosts with a copy to the device and nothing else.

**Failures.**  A host loss is seen three ways: a dispatch raising
``HostDropped`` / ``EngineDead`` (``serve/faults.py``'s ``host_drop``
kind injects them), a failed heartbeat (``check_hosts``), or a per-host
``CircuitBreaker`` opening after consecutive transient failures.  All
three reach ``_handle_drop``, which takes the host out of the scatter
plan and answers with ``policy``:

* ``"reshard"`` -- the dead host's granules go round-robin to the
  survivors;
* ``"degrade"`` -- a front-end spare ``LocalHost`` serves them from the
  router's copy of the permuted table;
* ``"auto"`` -- reshard while survivors exist, else degrade.

Each decision is a flight event (``host_drop`` then
``cluster_recovery``), a ``decision_counts`` entry and a cluster
``EngineCounters`` move (reshard -> ``engine_restarts``, degrade ->
``failovers``); ``obs.metrics.register_cluster`` exports them.

Hosts are pluggable: ``LocalHost`` (in-process) and
``cluster_net.RemoteHost`` (a socket client for ``cluster_worker``
processes) implement one protocol, so the router does not know the
transport.  Every host of one machine may share its card.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from ..core import expand, keygen
from ..core.expand import DeadlineExceeded
from ..obs.flight import FLIGHT
from ..serve.engine import LoadShed, ServingEngine
from ..serve.faults import CircuitBreaker, EngineDead, HostDropped
from ..utils.profiling import EngineCounters, note_swallowed

#: recovery decisions a policy can produce
DECISIONS = ("reshard", "degrade")


class HostUnreachable(RuntimeError):
    """A serving host stopped answering (socket death, worker exit, or a
    dead engine seen mid-submit): exclusion, recovery, then a resubmit,
    as for ``HostDropped``."""


class ClusterUnavailable(RuntimeError):
    """The live hosts (and the spare) no longer cover the table: answers
    would be wrong shares, so the router refuses to serve."""


# ------------------------------------------------------------- planning

def granule_rows(n: int, hosts: int) -> int:
    """Rows per granule for an ``n``-row table over ``hosts`` hosts
    (both powers of two, hosts <= n)."""
    if hosts < 1 or (hosts & (hosts - 1)):
        raise ValueError("hosts must be a power of two >= 1 (got %d)"
                         % hosts)
    if n % hosts:
        raise ValueError("hosts (%d) must divide n (%d)" % (hosts, n))
    g = n // hosts
    if g & (g - 1):
        raise ValueError("granule %d is not a power of two (n=%d)"
                         % (g, n))
    return g


def make_plan(n: int, hosts: int) -> dict:
    """Initial assignment: host i owns rows [i*g, (i+1)*g) of the
    PERMUTED table; {"host<i>": (row0,)}."""
    g = granule_rows(n, hosts)
    return {"host%d" % i: (i * g,) for i in range(hosts)}


def reshard_plan(lost, survivors) -> dict:
    """``lost`` granule row0s round-robin over ``survivors`` (ordered
    labels): {label: (row0, ...)} of ADDITIONS."""
    if not survivors:
        raise ValueError("no survivors to reshard onto")
    out = {lb: [] for lb in survivors}
    for i, row0 in enumerate(sorted(lost)):
        out[survivors[i % len(survivors)]].append(row0)
    return {lb: tuple(v) for lb, v in out.items() if v}


# ---------------------------------------------------------- shard server

class ClusterShardServer:
    """One host's table slice behind ``ServingEngine``'s server protocol.

    Holds (row0, device granule) shards of the bit-reverse-permuted
    table on ``device`` (None = the card); a dispatch evaluates each
    granule's partial share (``sharded.eval_leaf_range_local``) and sums
    them on the device without a host sync.  ``add_granules`` is the
    recovery hook: one copy to the device per granule.

    ``budget_bytes`` makes the host PAGED: granules live in a
    ``serve.registry.GranuleStore`` under that device budget, so a host
    may be assigned more table than its device holds; a dispatch leases
    each granule in turn (promoting a cold one) and prefetches the next
    into free budget while the last one's kernels run."""

    scheme = "logn"
    radix = 2

    def __init__(self, table_perm: np.ndarray, row0s, granule: int, *,
                 prf_method: int, batch_size: int = 512,
                 aes_impl: str | None = None,
                 budget_bytes: int | None = None, device=None):
        from ..api import resolve_device
        if table_perm.ndim != 2:
            raise ValueError("table_perm must be [n, entry_size]")
        self._table_perm = table_perm          # shared ref, host memory
        self.n = int(table_perm.shape[0])
        self.entry_size = int(table_perm.shape[1])
        self.granule = int(granule)
        self.prf_method = int(prf_method)
        self.batch_size = self.BATCH_SIZE = int(batch_size)
        self.aes_impl = aes_impl
        self.device = resolve_device(device)
        self.budget_bytes = (None if budget_bytes is None
                             else int(budget_bytes))
        self._shards = []                      # [(row0, device [g, E])]
        self._assigned = []                    # paged mode: row0 list
        self.store = None                      # paged mode: GranuleStore
        if self.budget_bytes is not None:
            from ..serve.registry import GranuleStore
            self.store = GranuleStore(table_perm, self.granule,
                                      budget_bytes=self.budget_bytes,
                                      device=self.device)
        self.add_granules(row0s)

    # the engine's names for the table shape
    @property
    def table_num_entries(self) -> int:
        return self.n

    @property
    def table_effective_entry_size(self) -> int:
        return self.entry_size

    @property
    def paged(self) -> bool:
        return self.store is not None

    def add_granules(self, row0s) -> None:
        """Upload granules [row0, row0 + granule); on a paged host only
        extend the assignment (a granule pages up at its first dispatch,
        so a reshard never overruns the budget)."""
        held = (set(self._assigned) if self.paged
                else {r for r, _ in self._shards})
        for row0 in row0s:
            row0 = int(row0)
            if row0 % self.granule or not 0 <= row0 < self.n:
                raise ValueError("row0 %d not a granule boundary (g=%d)"
                                 % (row0, self.granule))
            if row0 in held:
                continue
            if self.paged:
                self._assigned.append(row0)
            else:
                sl = np.ascontiguousarray(
                    self._table_perm[row0:row0 + self.granule])
                self._shards.append((row0,
                                     torch.from_numpy(sl).to(self.device)))
            held.add(row0)
        self._shards.sort(key=lambda t: t[0])
        self._assigned.sort()

    def set_granules(self, row0s) -> None:
        """Replace the held granules (hot-standby promotion)."""
        self._shards = []
        if self.paged:
            self._assigned = []
            self.store.demote_all()
        self.add_granules(row0s)

    @property
    def granules(self) -> tuple:
        if self.paged:
            return tuple(self._assigned)
        return tuple(r for r, _ in self._shards)

    def _decode_batch(self, keys) -> keygen.PackedKeys:
        pk = (keys if isinstance(keys, keygen.PackedKeys)
              else keygen.decode_keys_batched(keys))
        if pk.n != self.n:
            raise ValueError("keys for n=%d but table has n=%d"
                             % (pk.n, self.n))
        return pk

    def _stage_packed(self, pk, size: int | None = None, stage=None):
        from ..api import stage_packed
        return stage_packed(pk, size, stage, False)

    def resolved_eval_knobs(self, batch: int) -> dict:
        """The granule evaluation's chunk for one batch size."""
        return {"chunk_leaves": expand.clamp_chunk(0, self.granule, batch),
                "granules": len(self.granules)}

    def _dispatch_packed(self, pk) -> torch.Tensor:
        """Sum of this host's granule partials ([size, E] int32 on the
        device, no host sync).  Paged mode walks the assignment in row
        order: lease (fault in when cold), dispatch, release, then
        prefetch the next granule."""
        from ..api import StagedKeys, _logn_planes, upload
        from .sharded import eval_leaf_range_local
        if not (self._assigned if self.paged else self._shards):
            raise RuntimeError("shard server holds no granules")
        staged = (pk if isinstance(pk, StagedKeys)
                  else self._stage_packed(pk))
        cw1, cw2, last = _logn_planes(upload(staged, self.device),
                                      staged.size)
        chunk = self.resolved_eval_knobs(staged.size)["chunk_leaves"]

        def eval_one(row0, tbl, out):
            part = eval_leaf_range_local(
                cw1, cw2, last, tbl, row0, prf_method=self.prf_method,
                chunk_leaves=chunk, n_total=self.n, aes_impl=self.aes_impl)
            return part if out is None else out + part

        out = None
        if self.paged:
            for i, row0 in enumerate(self._assigned):
                lease = self.store.lease(row0)
                try:
                    out = eval_one(row0, lease.table, out)
                finally:
                    lease.release()
                if i + 1 < len(self._assigned):
                    self.store.prefetch(self._assigned[i + 1])
            return out
        for row0, tbl in self._shards:
            out = eval_one(row0, tbl, out)
        return out


# --------------------------------------------------------------- hosts

class LocalHost:
    """In-process serving host: a ``ClusterShardServer`` behind a
    ``ServingEngine`` labelled with the host name (fault specs target
    it).  The node protocol (``submit`` / ``heartbeat`` /
    ``add_granules`` / ``counters`` / ``stats``) that
    ``cluster_net.RemoteHost`` mirrors over sockets."""

    def __init__(self, label: str, server: ClusterShardServer, *,
                 process_index: int | None = None, buckets=None,
                 injector=None, **engine_kw):
        self.label = label
        self.process_index = process_index
        self.server = server
        self._injector = injector
        self.engine = ServingEngine(server, buckets=buckets, label=label,
                                    injector=injector, **engine_kw)
        # per-host series carry the host's own process index
        self.engine.process_index = process_index

    def submit(self, pk):
        return self.engine.submit(pk)

    def heartbeat(self) -> dict:
        """Liveness probe; raises ``HostDropped`` when this host is
        (injected-)dead."""
        if self._injector is not None:
            self._injector.on_heartbeat(self.engine)
        return {"host": self.label, "granules": self.server.granules,
                "in_flight": self.engine.in_flight}

    def add_granules(self, row0s) -> None:
        self.server.add_granules(row0s)

    @property
    def granules(self) -> tuple:
        return self.server.granules

    def counters(self) -> EngineCounters:
        return self.engine.stats

    def stats(self) -> dict:
        return {"granules": list(self.server.granules),
                "counters": self.engine.stats.as_dict()}

    def warmup(self) -> None:
        self.engine.warmup()

    def drain(self) -> None:
        self.engine.drain()

    def close(self) -> None:
        pass


# -------------------------------------------------------------- future

class ClusterFuture:
    """Merged result of one scattered batch: ``result()`` gathers every
    host's partial and sums them (wrapping int32).  A host loss seen
    while gathering runs recovery and re-serves the whole batch on the
    recovered cluster, at most ``max_retries`` times."""

    def __init__(self, router, pk, parts):
        self._router = router
        self._pk = pk
        self._parts = parts          # [(label, engine future)]
        self._value = None

    def done(self) -> bool:
        return self._value is not None

    def result(self):
        if self._value is not None:
            return self._value
        r = self._router
        parts, attempt = self._parts, 0
        while True:
            try:
                self._value = r._merge(self._gather(parts))
                return self._value
            except (HostDropped, EngineDead, HostUnreachable):
                attempt += 1
                if attempt > r.max_retries:
                    raise
                parts = r._scatter(self._pk)   # recovered coverage

    def _gather(self, parts):
        out = []
        for lb, fut in parts:
            try:
                out.append(fut.result())
                self._router._note_ok(lb)
            except (LoadShed, DeadlineExceeded):
                raise                # decisions, not faults
            except (HostDropped, EngineDead, HostUnreachable) as e:
                self._router._handle_drop(lb, e)
                raise
            except Exception as e:
                if self._router._note_failure(lb, e):
                    raise HostUnreachable(
                        "host %r breaker opened: %s" % (lb, e)) from e
                raise
        return out


# -------------------------------------------------------------- router

class ClusterRouter:
    """Scatter/gather front end over serving hosts.

    Args (``dpf_tpu``'s): nodes (``LocalHost`` / ``RemoteHost``, unique
    labels); granule (``granule_rows(n, hosts)``); table_perm (the full
    permuted table in host memory, for ``degrade``; None restricts
    recovery to ``reshard``); policy (``"reshard"``, ``"degrade"``,
    ``"auto"``); injector (``faults.FaultInjector``, consulted by
    heartbeats through each node); breaker_failures / breaker_reset_s
    (per-host breakers; one opening is a host loss); max_retries
    (whole-batch re-serves after recoveries); standby (build and warm
    the front-end spare now, on a placeholder granule, so a degrade
    costs one copy to the device); device (the spare's device, None =
    the card).

    ``hosts`` / ``assignment`` / ``host_state`` / ``decision_counts`` /
    ``counters`` are what ``obs.metrics.register_cluster`` exports."""

    def __init__(self, nodes, *, granule: int, table_perm=None,
                 policy: str = "auto", injector=None,
                 breaker_failures: int = 3, breaker_reset_s: float = 30.0,
                 max_retries: int = 2, spare_engine_kw=None,
                 prf_method: int | None = None, standby: bool = False,
                 device=None):
        if policy not in DECISIONS + ("auto",):
            raise ValueError("policy must be reshard|degrade|auto "
                             "(got %r)" % (policy,))
        nodes = list(nodes)
        self.hosts = {node.label: node for node in nodes}
        if len(self.hosts) != len(nodes):
            raise ValueError("duplicate host labels")
        self.granule = int(granule)
        self._table_perm = table_perm
        self.policy = policy
        self.injector = injector
        self.max_retries = int(max_retries)
        self._spare_engine_kw = dict(spare_engine_kw or {})
        first = nodes[0]
        self.n = first.server.n if hasattr(first, "server") else first.n
        if prf_method is None:  # remote nodes carry no server object
            prf_method = getattr(getattr(first, "server", None),
                                 "prf_method", None)
        self._prf_method = prf_method
        self._device = device
        self._all_granules = frozenset(range(0, self.n, self.granule))
        self._assign = {lb: tuple(node.granules)
                        for lb, node in self.hosts.items()}
        self._down = set()
        self._lock = threading.RLock()
        self.spare = None
        self.recovery = EngineCounters()
        self.decision_counts = {d: 0 for d in DECISIONS}
        self.breakers = {
            lb: CircuitBreaker(failures=breaker_failures,
                               reset_s=breaker_reset_s, name=lb,
                               on_open=self._on_breaker_open)
            for lb in self.hosts}
        covered = set()
        for g in self._assign.values():
            covered.update(g)
        if covered != set(self._all_granules):
            raise ValueError("initial assignment does not tile the "
                             "table: missing %s"
                             % sorted(self._all_granules - covered))
        if standby:
            self.spare = self._build_spare((0,))
        try:
            from ..obs.metrics import register_cluster
            register_cluster(self)
        except Exception as e:  # observability must never break serving
            note_swallowed("cluster.register_metrics", e, self.recovery)

    # ------------------------------------------------------ construction

    @classmethod
    def local(cls, table, hosts: int = 2, *, prf_method=None,
              oracle=None, buckets=None, injector=None,
              engine_kw=None, host_budget_bytes=None, device=None,
              **router_kw) -> "ClusterRouter":
        """An all-in-process cluster over ``table``: every host on
        ``device`` (None = the card; hosts of one machine share it).
        ``oracle`` (an ``api.DPF``) supplies ``prf_method`` when not
        given; the tuning cache's cluster knobs (``serve_tune.
        lookup_cluster_knobs``) fill the bucket ladder and window unless
        ``buckets`` pins them; ``host_budget_bytes`` makes every host
        paged."""
        from ..api import resolve_device
        device = resolve_device(device)
        if prf_method is None:
            if oracle is not None:
                prf_method = oracle.prf_method
            else:
                from ..api import DPF
                prf_method = DPF.DEFAULT_PRF
        tbl = np.ascontiguousarray(np.asarray(table, dtype=np.int32))
        n = tbl.shape[0]
        g = granule_rows(n, hosts)
        perm = expand.permute_table(tbl)
        kw = dict(engine_kw or {})
        if buckets is None:
            from ..tune.serve_tune import lookup_cluster_knobs
            knobs = lookup_cluster_knobs(
                n=n, entry_size=tbl.shape[1], hosts=hosts,
                prf_method=prf_method, cap=kw.get("cap", 512),
                device=device)
            if knobs:
                buckets = knobs["buckets"]
                kw.setdefault("max_in_flight", knobs["max_in_flight"])
        kw.pop("cap", None)
        nodes = []
        plan = sorted(make_plan(n, hosts).items(),
                      key=lambda kv: int(kv[0][4:]))
        for i, (lb, row0s) in enumerate(plan):
            srv = ClusterShardServer(perm, row0s, g, prf_method=prf_method,
                                     budget_bytes=host_budget_bytes,
                                     device=device)
            nodes.append(LocalHost(lb, srv, process_index=i,
                                   buckets=buckets, injector=injector,
                                   **kw))
        router_kw.setdefault("spare_engine_kw", dict(kw, buckets=buckets))
        return cls(nodes, granule=g, table_perm=perm, injector=injector,
                   device=device, **router_kw)

    # ---------------------------------------------------------- serving

    def submit(self, keys) -> ClusterFuture:
        """Scatter one batch to every covering host (keys decode once,
        here); returns the merged future.  A host loss seen while
        scattering runs recovery and raises ``HostUnreachable``
        (``submit_resilient`` retries)."""
        pk = (keys if isinstance(keys, keygen.PackedKeys)
              else keygen.decode_keys_batched(keys))
        return ClusterFuture(self, pk, self._scatter(pk))

    def _scatter(self, pk) -> list:
        plan = self._scatter_plan()
        FLIGHT.record(
            "scatter", hosts=sorted(lb for lb, _ in plan),
            batch=pk.batch,
            arrival=getattr(self.injector, "arrival", None),
            granules={lb: len(node.granules) for lb, node in plan})
        parts = []
        for lb, node in plan:
            try:
                parts.append((lb, node.submit(pk)))
            except (LoadShed, DeadlineExceeded):
                raise                # decisions, not faults
            except (HostDropped, EngineDead, HostUnreachable) as e:
                self._handle_drop(lb, e)
                raise HostUnreachable(
                    "host %r lost mid-scatter (recovered; resubmit): %s"
                    % (lb, e)) from e
            except Exception as e:
                if self._note_failure(lb, e):
                    raise HostUnreachable(
                        "host %r breaker opened mid-scatter: %s"
                        % (lb, e)) from e
                raise
        return parts

    def submit_resilient(self, keys) -> ClusterFuture:
        """``submit`` with bounded retries across host-loss recoveries."""
        attempt = 0
        while True:
            try:
                return self.submit(keys)
            except (HostDropped, EngineDead, HostUnreachable):
                attempt += 1
                if attempt > self.max_retries:
                    raise
                self.recovery.inc("retries")

    def _scatter_plan(self) -> list:
        """(label, node) pairs covering the table: the live hosts plus
        the spare once it holds assigned granules."""
        with self._lock:
            plan = [(lb, node) for lb, node in self.hosts.items()
                    if lb not in self._down and node.granules]
            if self.spare is not None and self._assign.get("spare"):
                plan.append(("spare", self.spare))
            covered = set()
            for _, node in plan:
                covered.update(node.granules)
        missing = self._all_granules - covered
        if missing:
            raise ClusterUnavailable(
                "no live host covers granule rows %s"
                % sorted(missing)[:4])
        return plan

    def _merge(self, parts):
        """Wrapping int32 sum of the hosts' partial shares."""
        out = np.array(parts[0], dtype=np.int32, copy=True)
        with np.errstate(over="ignore"):
            for p in parts[1:]:
                out += np.asarray(p, dtype=np.int32)
        return out

    # --------------------------------------------------------- liveness

    def check_hosts(self) -> dict:
        """Heartbeat every host not down, running recovery for any that
        fails (loss is seen between dispatches too).  {label: state}."""
        for lb, node in list(self.hosts.items()):
            if lb in self._down:
                continue
            try:
                node.heartbeat()
            except (HostDropped, EngineDead, HostUnreachable) as e:
                self._handle_drop(lb, e)
            except Exception as e:
                self._note_failure(lb, e)
        return {lb: self.host_state(lb) for lb in self.hosts}

    def _note_ok(self, lb: str) -> None:
        br = self.breakers.get(lb)
        if br is not None and lb not in self._down:
            br.record_success()

    def _note_failure(self, lb: str, e) -> bool:
        """Count a transient failure on ``lb``'s breaker; True when it is
        now open (its callback already ran recovery)."""
        br = self.breakers.get(lb)
        if br is None:
            return False
        return br.record_failure() == "open"

    def _on_breaker_open(self, breaker) -> None:
        lb = breaker.name
        if lb in self.hosts and lb not in self._down:
            self._handle_drop(lb, HostUnreachable(
                "host %r breaker opened after %d consecutive failures"
                % (lb, breaker.consecutive)))

    # --------------------------------------------------------- recovery

    def _handle_drop(self, lb: str, err) -> None:
        """Exclude the host, then answer the loss by ``policy``;
        idempotent per host and serialized under the router lock."""
        with self._lock:
            if lb in self._down or lb not in self.hosts:
                return
            self._down.add(lb)
            arrival = getattr(self.injector, "arrival", None)
            FLIGHT.record("host_drop", host=lb, arrival=arrival,
                          error=type(err).__name__, detail=str(err))
            br = self.breakers.get(lb)
            while br is not None and br.state != "open":
                br.record_failure()   # loss confirmed: pin the breaker
            lost = self._assign.get(lb, ())
            self._assign[lb] = ()
            survivors = [s for s in self.hosts if s not in self._down]
            decision = self.policy
            if decision == "auto":
                decision = "reshard" if survivors else "degrade"
            try:
                if decision == "reshard":
                    self._reshard(lost, survivors)
                else:
                    self._degrade(lost)
            except Exception as e:
                FLIGHT.record("cluster_recovery", host=lb,
                              decision=decision, ok=False,
                              error=type(e).__name__)
                raise ClusterUnavailable(
                    "recovery (%s) for host %r failed: %s"
                    % (decision, lb, e)) from e
            self.decision_counts[decision] += 1
            FLIGHT.record("cluster_recovery", host=lb, decision=decision,
                          granules=sorted(lost), arrival=arrival,
                          survivors=survivors, ok=True)

    def _reshard(self, lost, survivors) -> None:
        adds = reshard_plan(lost, survivors)
        for s_lb, row0s in adds.items():
            self.hosts[s_lb].add_granules(row0s)
            self._assign[s_lb] = tuple(
                sorted(set(self._assign[s_lb]) | set(row0s)))
        self.recovery.inc("engine_restarts")

    def _build_spare(self, row0s) -> LocalHost:
        if self._table_perm is None:
            raise ClusterUnavailable(
                "degrade needs the front-end table (table_perm=None)")
        if self._prf_method is None:
            raise ClusterUnavailable(
                "degrade needs prf_method (pass it to the router "
                "when hosts are remote)")
        srv = ClusterShardServer(self._table_perm, row0s, self.granule,
                                 prf_method=self._prf_method,
                                 device=self._device)
        kw = dict(self._spare_engine_kw)
        buckets = kw.pop("buckets", None)
        spare = LocalHost("spare", srv, buckets=buckets,
                          injector=self.injector, **kw)
        spare.warmup()
        return spare

    def _degrade(self, lost) -> None:
        if self.spare is None:
            self.spare = self._build_spare(lost)
        elif not self._assign.get("spare"):
            # promote the hot standby: its placeholder granule swaps for
            # the dead host's ones
            self.spare.server.set_granules(lost)
        else:
            self.spare.add_granules(lost)
        self._assign["spare"] = tuple(
            sorted(set(self._assign.get("spare", ())) | set(lost)))
        self.recovery.inc("failovers")

    # ---------------------------------------------------- observability

    def host_state(self, lb: str) -> str:
        """"live", "degraded" (breaker not closed, not confirmed down) or
        "down"."""
        if lb == "spare":
            return "live" if (self.spare is not None
                              and self._assign.get("spare")) else "down"
        if lb in self._down:
            return "down"
        br = self.breakers.get(lb)
        if br is not None and br.state != "closed":
            return "degraded"
        return "live"

    @property
    def assignment(self) -> dict:
        with self._lock:
            return {lb: tuple(g) for lb, g in self._assign.items()}

    def counters(self) -> EngineCounters:
        """Every host's engine counters, the spare's and the router's
        recovery events, merged."""
        agg = EngineCounters()
        for node in self.hosts.values():
            try:
                agg.merge(node.counters())
            except Exception as e:  # a dead host keeps no books
                note_swallowed("cluster.peer_unreachable", e,
                               self.recovery)
        if self.spare is not None:
            agg.merge(self.spare.counters())
        agg.merge(self.recovery)
        return agg

    def stats(self) -> dict:
        return {
            "hosts": {lb: self.host_state(lb) for lb in self.hosts},
            "assignment": {lb: list(g)
                           for lb, g in self.assignment.items()},
            "down": sorted(self._down),
            "decision_counts": dict(self.decision_counts),
            "counters": self.counters().as_dict(),
            "breakers": {lb: br.as_dict()
                         for lb, br in self.breakers.items()},
            "spare_granules": (list(self.spare.granules)
                               if self.spare is not None else []),
        }

    # ------------------------------------------------------- lifecycle

    def warmup(self) -> None:
        for lb, node in self.hosts.items():
            if lb not in self._down:
                node.warmup()

    def drain(self) -> None:
        for lb, node in self.hosts.items():
            if lb in self._down:
                continue
            try:
                node.drain()
            except Exception as e:  # a dying host must not block the rest
                note_swallowed("cluster.drain", e, self.recovery)
        if self.spare is not None:
            self.spare.drain()

    def close(self) -> None:
        for node in self.hosts.values():
            try:
                node.close()
            except Exception as e:
                note_swallowed("cluster.close", e, self.recovery)


# ------------------------------------------------- batch-PIR group routing

class ClusterPIRRouter:
    """Bin-sharded batch-PIR over hosts with routing by size group.

    Bins are laid out by descending padded size (a layout both sides
    derive) and split contiguously over hosts, balanced by padded rows;
    each host runs an ordinary ``apps.batch_pir.PrivateLookupServer``
    over its bins.  ``routed=True`` sends each size group's keys only to
    the hosts whose bins cover it; ``routed=False`` sends every group to
    every host (which drops foreign bins).  Both give the same per-bin
    answers; ``dispatch_counts`` records the deliveries.
    ``scheme="auto"`` is refused: hosts and the client must derive the
    same constructions from the arguments alone."""

    def __init__(self, table, bins, hosts: int = 2, *, prf=None,
                 radix: int = 2, scheme: str = "logn",
                 routed: bool = True, device=None):
        from ..apps.batch_pir import PrivateLookupServer, _pad_pow2
        if scheme == "auto":
            raise ValueError(
                "ClusterPIRRouter needs a concrete scheme: 'auto' "
                "resolves per-group constructions from the tuning "
                "cache keyed by group size, which differs between a "
                "host's bin slice and the client's global view")
        if hosts < 1:
            raise ValueError("hosts must be >= 1 (got %d)" % hosts)
        self.routed = bool(routed)
        self.bins = [sorted(b) for b in bins]
        padded = [_pad_pow2(max(1, len(b))) for b in self.bins]
        order = sorted(range(len(self.bins)),
                       key=lambda i: (-padded[i], i))
        target = sum(padded) / hosts
        shards: list[list[int]] = [[] for _ in range(hosts)]
        h = acc = 0
        for bi in order:
            if h < hosts - 1 and acc >= target * (h + 1) and shards[h]:
                h += 1
            shards[h].append(bi)
            acc += padded[bi]
        self._hosts = []           # [(label, server, global bin idxs)]
        for i, idxs in enumerate(shards):
            srv = (PrivateLookupServer(
                       np.asarray(table), [self.bins[bi] for bi in idxs],
                       prf=prf, radix=radix, scheme=scheme, device=device)
                   if idxs else None)
            self._hosts.append(("pirhost%d" % i, srv, tuple(idxs)))
        self.group_sizes = tuple(sorted(set(padded), reverse=True))
        self._padded = padded
        self.owners = {
            n: [lb for lb, _, idxs in self._hosts
                if any(padded[bi] == n for bi in idxs)]
            for n in self.group_sizes}
        self.dispatch_counts = {lb: 0 for lb, _, _ in self._hosts}
        self.entry_size = int(np.asarray(table).shape[1])

    def host_groups(self, label: str) -> tuple:
        """Padded sizes of the size groups ``label``'s bins cover."""
        for lb, _, idxs in self._hosts:
            if lb == label:
                return tuple(sorted({self._padded[bi] for bi in idxs},
                                    reverse=True))
        raise KeyError(label)

    def answer(self, keys_per_bin) -> np.ndarray:
        """Per-bin answer shares ``[n_bins, E]`` for one round
        (``PrivateLookupServer.answer``'s contract)."""
        if len(keys_per_bin) != len(self.bins):
            raise ValueError("expected one key per bin (%d), got %d"
                             % (len(self.bins), len(keys_per_bin)))
        out = np.zeros((len(self.bins), self.entry_size), dtype=np.int32)
        total = 0
        for lb, srv, idxs in self._hosts:
            if self.routed:
                if not idxs:
                    continue
                delivered = len({self._padded[bi] for bi in idxs})
            else:
                delivered = len(self.group_sizes)
            self.dispatch_counts[lb] += delivered
            total += delivered
            if srv is None or not idxs:
                continue
            ans = srv.answer([keys_per_bin[bi] for bi in idxs])
            out[list(idxs)] = np.asarray(ans)
        FLIGHT.record(
            "pir_scatter", routed=self.routed, dispatches=total,
            hosts={lb: len(idxs) for lb, _, idxs in self._hosts},
            groups=len(self.group_sizes))
        return out

    def stats(self) -> dict:
        return {
            "routed": self.routed,
            "group_sizes": list(self.group_sizes),
            "owners": {int(n): list(lbs)
                       for n, lbs in self.owners.items()},
            "bins_per_host": {lb: len(idxs)
                              for lb, _, idxs in self._hosts},
            "dispatch_counts": dict(self.dispatch_counts),
        }
