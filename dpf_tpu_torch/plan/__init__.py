"""Capacity planning: the digital twin, the fleet planner, autoscaling.

Port of ``dpf_tpu/plan``.  The package answers fleet-sizing questions
without standing a fleet up: a seeded discrete-event twin of the serve
stack (``twin.py``), a replica-sweep capacity planner
(``capacity.py``), and a reactive autoscale policy evaluated in the
twin AND runnable against real engines (``autoscale.py``).  ``bench_plan.py`` is the
``benchmark --plan`` entry whose headline gate is twin fidelity
against the real open-loop harness on the card.

The pure core (twin/capacity/autoscale) imports only stdlib+numpy —
no torch, no other package of the port — so a twin run is reproducible
with no device work (a subprocess that loads the modules without the
package root, and so without torch, proves it).  Import them via this
package in normal code; the subprocess trick exists only to PROVE the
property.
"""

from .autoscale import AutoscalePolicy, ReplicaPool
from .capacity import plan_fleet, required_replicas
from .twin import (CostTable, FaultMirror, FleetConfig, PLAN_STATS,
                   TwinResult, simulate)

__all__ = [
    "AutoscalePolicy", "CostTable", "FaultMirror", "FleetConfig",
    "PLAN_STATS", "ReplicaPool", "TwinResult", "plan_fleet",
    "required_replicas", "simulate",
]
