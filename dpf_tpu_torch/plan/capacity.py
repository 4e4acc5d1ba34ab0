"""Fleet capacity planner: minimal engines/hosts meeting an SLO.

Given a trace, an SLO, and a fingerprint's cost table
(``SchemeRouter.cost_table()`` live, or ``tune.serve_tune.
cached_cost_table`` from the tuning cache), sweep replica counts
through the digital twin (``plan/twin.py``) and report the smallest
fleet that holds p99 under the SLO with an acceptable shed rate —
plus headroom curves (required replicas at scaled offered loads, via
``loadgen.scale_rate``-style time compression applied here to keep the
module free of torch).  Port of ``dpf_tpu/plan/capacity.py``.

Planner invariants (gated in the ``--plan`` record):

* **monotone in offered load** — more qps never plans fewer engines.
  The sweep enforces this by construction (a running max over
  ascending load scales), so a non-monotone twin artifact can never
  leak into a sizing decision.
* hosts = ceil(engines / host_slots) (``FleetConfig.hosts``).

Pure stdlib+numpy, like the twin: the planner does no device work.
The one device call is ``detect_hbm_budget``, imported lazily.
"""

from __future__ import annotations

import dataclasses

from .twin import CostTable, FleetConfig, PLAN_STATS, simulate


def _scale_trace(trace, factor: float) -> list:
    """Compress arrival times by ``factor`` (> 1 = hotter), keeping
    batches — the twin-side equivalent of ``loadgen.scale_rate``
    (kept here, duplicated in spirit, so the planner never imports the
    torch-importing serve package)."""
    if factor <= 0:
        raise ValueError("factor must be > 0 (got %r)" % (factor,))
    out = []
    for a in trace:
        if hasattr(a, "t"):
            out.append((float(a.t) / factor, int(a.batch)))
        elif isinstance(a, dict):
            out.append((float(a["t"]) / factor, int(a["batch"])))
        else:
            t, b = a
            out.append((float(t) / factor, int(b)))
    return out


#: fallback per-host HBM byte budget when neither the caller nor the
#: device probe supplies one (a mid-range accelerator host; the point
#: of the default is a usable memory floor, not precision — real plans
#: pass the probed or provisioned figure)
DEFAULT_HBM_BYTES = 16 << 30


def detect_hbm_budget(device=None) -> int | None:
    """Per-host HBM byte budget probed from ``device`` (None = the card;
    ``utils.compat.device_memory_stats`` -> ``bytes_limit``, the card's
    total memory); None on a CPU device, where there is no device
    ceiling to plan around.  On the card a failed probe raises.  The
    only call of the plan package that touches torch, and it is
    imported here, so the planner itself stays free of it."""
    from ..utils.compat import device_memory_stats
    st = device_memory_stats(device)
    if not st:
        return None
    limit = st.get("bytes_limit") or st.get("bytes_reservable_limit")
    return int(limit) if limit else None


def min_hosts_for_memory(table_bytes: int,
                         hbm_bytes_per_host: int) -> int:
    """The memory floor: hosts needed just to HOLD ``table_bytes`` of
    table at ``hbm_bytes_per_host`` each (the 2D/cluster tiers shard
    the table across hosts, so fleet HBM is hosts x per-host budget).
    Monotone in table bytes by construction (a ceil of a ratio)."""
    if table_bytes < 0:
        raise ValueError("table_bytes must be >= 0")
    if hbm_bytes_per_host < 1:
        raise ValueError("hbm_bytes_per_host must be >= 1")
    return max(1, -(-int(table_bytes) // int(hbm_bytes_per_host)))


@dataclasses.dataclass
class PlanResult:
    """One planned point: the minimal passing fleet and its twin run."""
    replicas: int
    hosts: int
    met_slo: bool
    summary: dict

    def as_dict(self) -> dict:
        return {"replicas": self.replicas, "hosts": self.hosts,
                "met_slo": self.met_slo, "summary": self.summary}


def required_replicas(trace, cost_table, *, label: str, slo_s: float,
                      fleet_kw: dict | None = None, seed: int = 0,
                      max_replicas: int = 16,
                      max_shed_rate: float = 0.0,
                      dispatch_blocking: bool = False) -> PlanResult:
    """Smallest replica count of ``label`` whose twin run meets the
    SLO (p99 <= slo_s and shed_rate <= max_shed_rate and no failed
    arrivals) on ``trace``.

    Sweeps 1..max_replicas ascending and stops at the first pass; when
    nothing passes, returns the ``max_replicas`` run with
    ``met_slo=False`` (the caller sees the planner saturated rather
    than a silent cap).  Uses the fleet (async-dispatch) twin model by
    default — replicas must overlap to matter.
    """
    if isinstance(cost_table, dict):
        cost_table = CostTable.from_dict(cost_table)
    fleet_kw = dict(fleet_kw or {})
    fleet_kw.setdefault("slo_s", slo_s)
    last = None
    for r in range(1, max_replicas + 1):
        fleet = FleetConfig(replicas={label: r},
                            dispatch_blocking=dispatch_blocking,
                            **fleet_kw)
        res = simulate(trace, cost_table, fleet, seed=seed,
                       record_events=False)
        PLAN_STATS.sweeps += 1
        s = res.summary()
        p99 = s["p99_ms"]
        ok = (p99 is not None and p99 <= slo_s * 1e3
              and s["shed_rate"] <= max_shed_rate
              and s["failed"] == 0)
        last = PlanResult(replicas=r, hosts=fleet.hosts(),
                          met_slo=ok, summary=s)
        if ok:
            return last
    return last


def plan_fleet(trace, cost_table, *, label: str, slo_s: float,
               load_scales=(0.5, 1.0, 1.5, 2.0), seed: int = 0,
               fleet_kw: dict | None = None, max_replicas: int = 16,
               max_shed_rate: float = 0.0, host_slots: int = 4,
               table_bytes: int | None = None,
               hbm_bytes_per_host: int | None = None,
               device=None) -> dict:
    """The capacity plan: minimal fleet at the offered load plus the
    headroom curve over ``load_scales``.

    Monotonicity is enforced by construction: replicas at each scale
    are the running max over ascending scales, so "more qps never
    plans fewer engines" holds for every emitted plan — any twin
    noise that would dip the curve is absorbed upward (conservative:
    over-provisioning, never under).

    ``table_bytes`` makes HBM a first-class resource next to compute:
    every curve point's ``hosts`` becomes ``max(throughput hosts,
    memory-floor hosts)`` where the floor is
    ``min_hosts_for_memory(table_bytes, hbm_bytes_per_host)`` — the
    hosts needed just to HOLD the sharded table.  This answers "how
    many hosts for a 10^9-row table at this qps" with a curve that is
    JOINTLY monotone: nondecreasing in offered load (running max) and
    nondecreasing in table bytes (a ceil of a ratio), because a max of
    monotone terms is monotone.  ``hbm_bytes_per_host`` resolves
    explicit > the probe of ``device`` (``detect_hbm_budget``; None =
    the card) > ``DEFAULT_HBM_BYTES`` on a CPU device, with the
    provenance recorded."""
    if isinstance(cost_table, dict):
        cost_table = CostTable.from_dict(cost_table)
    fleet_kw = dict(fleet_kw or {})
    fleet_kw.setdefault("host_slots", host_slots)
    memory = None
    mem_hosts = 0
    if table_bytes is not None:
        if hbm_bytes_per_host is not None:
            hbm, hbm_source = int(hbm_bytes_per_host), "explicit"
        else:
            hbm = detect_hbm_budget(device)
            if hbm is not None:
                hbm_source = "device"
            else:
                hbm, hbm_source = DEFAULT_HBM_BYTES, "default"
        mem_hosts = min_hosts_for_memory(table_bytes, hbm)
        memory = {"table_bytes": int(table_bytes),
                  "hbm_bytes_per_host": hbm,
                  "hbm_source": hbm_source,
                  "hosts_memory_floor": mem_hosts}
    scales = sorted(set(float(s) for s in load_scales) | {1.0})
    curve = []
    running = 0
    for sc in scales:
        scaled = _scale_trace(trace, sc)
        pr = required_replicas(
            scaled, cost_table, label=label, slo_s=slo_s,
            fleet_kw=fleet_kw, seed=seed, max_replicas=max_replicas,
            max_shed_rate=max_shed_rate)
        planned = max(running, pr.replicas)
        running = planned
        hosts_tp = -(-planned // int(fleet_kw["host_slots"]))
        curve.append({
            "load_scale": sc,
            "replicas": planned,
            "replicas_raw": pr.replicas,
            "hosts": max(hosts_tp, mem_hosts),
            "hosts_throughput": hosts_tp,
            "met_slo": pr.met_slo,
            "p99_ms": pr.summary["p99_ms"],
            "shed_rate": pr.summary["shed_rate"],
            "qps": pr.summary["qps"],
        })
    at_one = next(c for c in curve if c["load_scale"] == 1.0)
    monotone = all(
        curve[i]["replicas"] <= curve[i + 1]["replicas"]
        and curve[i]["hosts"] <= curve[i + 1]["hosts"]
        for i in range(len(curve) - 1))
    out = {
        "construction": label,
        "slo_ms": round(slo_s * 1e3, 3),
        "replicas": at_one["replicas"],
        "hosts": at_one["hosts"],
        "met_slo": at_one["met_slo"],
        "headroom_curve": curve,
        "monotone": monotone,   # True by construction; recorded so the
        #                         gate can assert it from the record
    }
    if memory is not None:
        out["memory"] = memory
    return out
