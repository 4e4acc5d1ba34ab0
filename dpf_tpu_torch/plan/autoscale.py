"""Reactive autoscaling: scale engine replicas on EWMA-util/p99 signals.

Two halves share one policy:

* ``AutoscalePolicy`` — the pure decision function.  Stdlib-only, no
  clocks: callers feed it (utilization over the last decision window,
  ring p99, SLO, replica count, seconds since the last change) and it
  answers "up" / "down" / None.  The digital twin evaluates it over
  virtual time (``twin.simulate(..., autoscaler=policy)``); the bench's
  autoscale leg gates it against the static peak-sized fleet on
  engine-hours.
* ``ReplicaPool`` — the same policy run against REAL
  ``serve.ServingEngine`` replicas: scale-up builds + warms a fresh
  engine from a factory, scale-down drains via the existing
  ``ServingEngine.drain()`` path and then ``close()``s it (the clean
  post-drain rejection added for exactly this), preemption is the
  engine-death fault arriving through the pool's submit path.  The pool
  drives the port's ``serve.ServingEngine``; all serve imports are lazy
  (inside methods), so importing this module loads no torch — the
  subprocess import test covers it.  Port of
  ``dpf_tpu/plan/autoscale.py``.

Policy shape: scale UP when
EWMA utilization crosses ``high_util`` or ring p99 crosses
``p99_high_frac`` of the SLO; scale DOWN only when utilization is
under ``low_util`` AND p99 is comfortably inside the SLO.  ``cooldown_s``
rate-limits changes (a scale-up's ``spinup_s`` warmup must land before
the next decision can react to it); min/max replica bounds are hard.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class AutoscalePolicy:
    """The pure scale-up/down decision function (see module docstring).

    ``decide_every_s`` is the decision cadence the twin (or a real
    control loop) samples signals at; utilization is EWMA-smoothed here
    with ``ewma_alpha`` so one idle window does not flap the fleet."""
    min_replicas: int = 1
    max_replicas: int = 8
    high_util: float = 0.75
    low_util: float = 0.30
    p99_high_frac: float = 0.9
    p99_low_frac: float = 0.5
    decide_every_s: float = 0.25
    cooldown_s: float = 0.5
    ewma_alpha: float = 0.5

    def __post_init__(self):
        if not 0 < self.ewma_alpha <= 1:
            raise ValueError("ewma_alpha must be in (0, 1]")
        if self.min_replicas < 1 or self.max_replicas < self.min_replicas:
            raise ValueError("need 1 <= min_replicas <= max_replicas")
        self._util_ewma = None

    def decide(self, *, util: float, p99_s: float | None,
               slo_s: float | None, replicas: int,
               since_change_s: float) -> str | None:
        """One decision: "up", "down", or None (hold)."""
        u = max(0.0, float(util))
        self._util_ewma = (u if self._util_ewma is None else
                           self.ewma_alpha * u
                           + (1 - self.ewma_alpha) * self._util_ewma)
        if since_change_s < self.cooldown_s:
            return None
        p99_hot = (p99_s is not None and slo_s is not None
                   and p99_s > self.p99_high_frac * slo_s)
        p99_cool = (p99_s is None or slo_s is None
                    or p99_s < self.p99_low_frac * slo_s)
        if ((self._util_ewma > self.high_util or p99_hot)
                and replicas < self.max_replicas):
            return "up"
        if (self._util_ewma < self.low_util and p99_cool
                and replicas > self.min_replicas):
            return "down"
        return None

    def reset(self) -> None:
        self._util_ewma = None

    def as_dict(self) -> dict:
        return {f.name: getattr(self, f.name)
                for f in dataclasses.fields(self)}


class ReplicaPool:
    """The autoscaler's real-engine leg: a pool of ``ServingEngine``
    replicas over ONE prepared server, scaled by ``AutoscalePolicy``.

    ``factory()`` builds a fresh engine (the caller closes over the
    prepared server + shared bucket ladder, so every replica serves
    the same table through the same programs — scale-up pays warmup,
    not re-upload).  ``submit`` routes to the least-loaded alive
    replica; ``scale_down`` drains the emptiest replica via the
    engine's own ``drain()`` and then ``close()``s it, so a retained
    handle that submits afterwards gets the clean ``EngineClosed``
    rejection instead of racing the teardown.  Engine-seconds are
    integrated over wall time for the engine-hours comparison the
    bench gates.
    """

    def __init__(self, factory, *, policy: AutoscalePolicy,
                 initial: int = 1, clock=None):
        import time as _time
        self._factory = factory
        self.policy = policy
        self._clock = clock or _time.monotonic
        self.replicas = []            # alive engines
        self._born = {}               # id(engine) -> birth time
        self.engine_seconds = 0.0     # integrated over retired engines
        self.scale_ups = 0
        self.scale_downs = 0
        self._busy_mark = 0.0
        self._last_decide = self._clock()
        self._last_change = -1e9
        for _ in range(max(1, int(initial))):
            self._add()

    # ----------------------------------------------------------- sizing

    def _add(self):
        eng = self._factory()
        self._born[id(eng)] = self._clock()
        self.replicas.append(eng)
        return eng

    def scale_up(self):
        """Build + warm one replica (the factory decides warmup)."""
        self.scale_ups += 1
        eng = self._add()
        self._flight("up")
        return eng

    def scale_down(self) -> bool:
        """Drain and close the emptiest replica; False at min size."""
        if len(self.replicas) <= 1:
            return False
        eng = min(self.replicas,
                  key=lambda e: (e.in_flight, len(e._pending)))
        self.replicas.remove(eng)
        eng.drain()                   # in-flight work completes first
        eng.close()                   # post-drain submits -> EngineClosed
        self.engine_seconds += self._clock() - self._born.pop(id(eng))
        self.scale_downs += 1
        self._flight("down")
        return True

    def _flight(self, action: str) -> None:
        import sys
        mod = sys.modules.get("dpf_tpu_torch.obs.flight")
        if mod is not None:
            try:
                mod.FLIGHT.record("plan_autoscale", action=action,
                                  replicas=len(self.replicas),
                                  real=True)
            except Exception:
                pass

    # ----------------------------------------------------------- serving

    def submit(self, keys):
        """Dispatch through the least-loaded alive replica."""
        if not self.replicas:
            raise RuntimeError("replica pool is empty")
        eng = min(self.replicas,
                  key=lambda e: (e.in_flight, len(e._pending)))
        return eng.submit(keys)

    def step(self, *, slo_s: float | None = None) -> str | None:
        """One control-loop tick: sample signals, maybe scale.

        Call from the serving loop (or a timer): no-op until
        ``decide_every_s`` elapsed since the last tick.  Utilization is
        approximated by busy dispatch+wait seconds accumulated across
        replicas over the window (the same signal the twin integrates
        exactly)."""
        now = self._clock()
        dt = now - self._last_decide
        if dt < self.policy.decide_every_s:
            return None
        self._last_decide = now
        busy = sum(e.stats.dispatch_time_s + e.stats.wait_time_s
                   for e in self.replicas)
        util = max(0.0, (busy - self._busy_mark)
                   / (dt * max(1, len(self.replicas))))
        self._busy_mark = busy
        p99s = [e.stats.p99 for e in self.replicas
                if e.stats.p99 is not None]
        action = self.policy.decide(
            util=util, p99_s=max(p99s) if p99s else None, slo_s=slo_s,
            replicas=len(self.replicas),
            since_change_s=now - self._last_change)
        if action == "up":
            self.scale_up()
            self._last_change = now
        elif action == "down":
            if not self.scale_down():
                return None
            self._last_change = now
        return action

    # ---------------------------------------------------------- teardown

    def drain(self) -> None:
        for eng in self.replicas:
            eng.drain()

    def close(self) -> float:
        """Drain + close every replica; returns total engine-seconds
        (retired + still-open replicas integrated to now)."""
        now = self._clock()
        for eng in list(self.replicas):
            eng.drain()
            eng.close()
            self.engine_seconds += now - self._born.pop(id(eng))
        self.replicas = []
        return self.engine_seconds

    def stats(self) -> dict:
        return {"replicas": len(self.replicas),
                "scale_ups": self.scale_ups,
                "scale_downs": self.scale_downs,
                "engine_seconds": round(self.engine_seconds, 4)}
