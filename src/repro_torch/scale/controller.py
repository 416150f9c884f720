"""The autoscaling control loop: sensors -> policy -> pool, with
hysteresis (the port of ``repro.scale.controller``).

``ScaleController`` is deliberately boring machinery: every tick it
samples one ``ScaleSnapshot`` from its sensor, asks the policy for a
desired size, clamps to ``[max(min_members, floor), max_members]``,
and actuates through the pool -- scale-up in bursts of at most
``max_step_up`` members, scale-down strictly one member per tick
(draining is deliberate), both behind a cooldown so a noisy signal
cannot flap the roster.  A roster that fell *below* the floor (workers
died) is restored regardless of what the policy thinks: the resilience
floor outranks load.

Determinism is a design requirement, not an accident: the clock is
injectable and ``step(now=...)`` runs exactly one tick synchronously,
so unit tests drive the whole loop with a fake clock and a fake pool
-- no sleeps, no threads, no wall time.  ``start()`` merely wraps
``step`` in a timer thread for production use.

Every evaluation lands in the bounded ``decisions`` log; every
*action* (and every failed action) additionally lands in the tracer as
a ``scale.decision`` instant, so scaling shows up on the same timeline
as the rounds it reshapes.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import asdict, dataclass

from ..obs.trace import default_tracer
from .policy import (QueueDepthPolicy, ScaleSnapshot, default_cooldown_ms,
                     default_interval_ms, default_max_members,
                     default_min_members)
from .pool import LocalPool, ProvisionError, ReplicaPool


@dataclass
class ScaleDecision:
    """One control-loop evaluation, as logged."""

    t: float
    action: str                 # "up" | "down" | "hold"
    reason: str                 # what drove it ("policy", "floor",
                                # "cooldown", "no-opinion", ...)
    size: int                   # members when the tick started
    target: int                 # clamped desired size
    applied: int = 0            # members actually added (+) / removed (-)
    ok: bool = True
    error: str | None = None


class ScaleController:
    """Deterministic sensor->policy->pool loop with hysteresis."""

    def __init__(self, pool, policy, sensor, *,
                 clock=None, interval_s: float | None = None,
                 cooldown_s: float | None = None,
                 min_members: int | None = None,
                 max_members: int | None = None,
                 max_step_up: int = 4, tracer=None, log_cap: int = 1024):
        self.pool = pool
        self.policy = policy
        self.sensor = sensor
        self.clock = clock if clock is not None else time.monotonic
        self.interval_s = interval_s if interval_s is not None \
            else default_interval_ms() / 1e3
        self.cooldown_s = cooldown_s if cooldown_s is not None \
            else default_cooldown_ms() / 1e3
        self.min_members = min_members if min_members is not None \
            else default_min_members()
        self.max_members = max_members if max_members is not None \
            else default_max_members()
        if self.min_members > self.max_members:
            raise ValueError(f"min_members {self.min_members} above "
                             f"max_members {self.max_members}")
        self.max_step_up = max(1, max_step_up)
        self._tracer = tracer if tracer is not None else default_tracer()
        self.decisions: deque[ScaleDecision] = deque(maxlen=log_cap)
        self.counters = {"ticks": 0, "ups": 0, "downs": 0, "holds": 0,
                         "provisioned": 0, "decommissioned": 0,
                         "errors": 0}
        self._last_action = float("-inf")
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        self._closed = False

    # -- one tick (the unit tests' entry point) -----------------------------

    def step(self, now: float | None = None) -> ScaleDecision:
        """Run exactly one evaluate->actuate tick and return its
        decision.  ``now`` overrides the clock (deterministic tests);
        production ticks let the clock supply it."""
        now = self.clock() if now is None else now
        self.counters["ticks"] += 1
        snap = self.sensor(now)
        size = snap.size
        floor = max(self.min_members, snap.floor)
        want = self.policy.target(snap)
        reason = "policy"
        if size < floor:
            # the roster fell below the resilience floor (deaths, a
            # too-eager operator): restore it regardless of load
            want, reason = floor, "floor"
        elif want is None:
            return self._hold(now, snap, size, size, "no-opinion")
        target = min(max(want, floor), self.max_members)
        if target == size:
            return self._hold(now, snap, size, target, "at-target")
        if now - self._last_action < self.cooldown_s:
            return self._hold(now, snap, size, target, "cooldown")
        if target > size:
            return self._scale(now, snap, size, target, reason, up=True)
        return self._scale(now, snap, size, target, reason, up=False)

    def _hold(self, now, snap, size, target, why) -> ScaleDecision:
        d = ScaleDecision(t=now, action="hold", reason=why, size=size,
                          target=target)
        self.counters["holds"] += 1
        self.decisions.append(d)
        return d

    def _scale(self, now, snap, size, target, reason, *,
               up: bool) -> ScaleDecision:
        applied, err = 0, None
        if up:
            for _ in range(min(target - size, self.max_step_up)):
                try:
                    self.pool.provision()
                    applied += 1
                except ProvisionError as e:
                    err = str(e)
                    break
        else:
            # one member per tick, newest first: drain is deliberate
            members = self.pool.members()
            try:
                if members:
                    self.pool.decommission(members[-1])
                    applied = -1
            except (ProvisionError, TimeoutError) as e:
                err = str(e)
        d = ScaleDecision(t=now, action="up" if up else "down",
                          reason=reason, size=size, target=target,
                          applied=applied, ok=err is None, error=err)
        self.decisions.append(d)
        self.counters["ups" if up else "downs"] += 1
        self.counters["provisioned" if up else "decommissioned"] += \
            abs(applied)
        if err is not None:
            self.counters["errors"] += 1
        if applied != 0 or err is not None:
            self._last_action = now
        tr = self._tracer
        if tr is not None:
            tr.instant("scale.decision", cat="scale", track="scale",
                       action=d.action, reason=d.reason, size=size,
                       target=target, applied=applied, ok=d.ok,
                       backlog=snap.backlog, lat_ewma_ms=snap.lat_ewma_ms)
        return d

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "ScaleController":
        """Run ``step`` every ``interval_s`` on a daemon thread until
        ``close``.  A tick that raises is recorded and the loop keeps
        going -- a flaky sensor must not kill autoscaling."""
        if self._closed:
            raise RuntimeError("controller has been closed")
        if self._thread is not None:
            return self
        self._stop.clear()

        def loop() -> None:
            while not self._stop.wait(self.interval_s):
                try:
                    self.step()
                except Exception as e:      # sensor/pool race at close
                    self.counters["errors"] += 1
                    self.decisions.append(ScaleDecision(
                        t=self.clock(), action="hold", reason="tick-error",
                        size=-1, target=-1, ok=False, error=repr(e)))

        self._thread = threading.Thread(target=loop, name="repro-scale",
                                        daemon=True)
        self._thread.start()
        return self

    def close(self) -> None:
        self._closed = True
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=10)

    def metrics(self) -> dict:
        last = self.decisions[-1] if self.decisions else None
        return {"size": self.pool.size(),
                "min_members": self.min_members,
                "max_members": self.max_members,
                "interval_s": self.interval_s,
                "cooldown_s": self.cooldown_s,
                "policy": self.policy.describe(),
                "pool": self.pool.metrics(),
                "counters": dict(self.counters),
                "last_decision": None if last is None else asdict(last)}

    def decision_log(self) -> list[dict]:
        return [asdict(d) for d in self.decisions]


# -- sensors -----------------------------------------------------------------


def fleet_sensor(fleet):
    """Normalize ``fleet.metrics()`` into ``ScaleSnapshot``s: backlog
    is queued columns across plans, latency the worst plan EWMA, the
    floor the fleet's own ``min_workers``."""

    def sense(now: float) -> ScaleSnapshot:
        m = fleet.metrics()
        plans = list(m["plans"].values())
        lats = [p["lat_ewma_ms"] for p in plans
                if p.get("lat_ewma_ms") is not None]
        hits = sum(p["counters"].get("deadline_hit", 0) for p in plans)
        return ScaleSnapshot(
            t=now, size=m["n_live"],
            backlog=m["queued_calls"]
            + sum(p["queued_cols"] for p in plans),
            inflight=m["inflight_rounds"],
            lat_ewma_ms=max(lats) if lats else None,
            deadline_hits=hits, floor=fleet.min_workers,
            extra={"transport": m["transport"]})

    return sense


def router_sensor(router, endpoint: str):
    """Normalize one endpoint of ``router.metrics()``: backlog is the
    tenant queues' columns, inflight the columns on replicas, latency
    the worst replica plan EWMA.  The floor is 1 -- the router itself
    refuses to drop the last live replica."""

    def sense(now: float) -> ScaleSnapshot:
        ep = router.metrics()["endpoints"][endpoint]
        live = [r for r in ep["replicas"] if not r["draining"]]
        lats = [r["lat_ewma_ms"] for r in live
                if r.get("lat_ewma_ms") is not None]
        hits = sum(tq["counters"].get("deadline_hit", 0)
                   for tq in ep["tenants"].values())
        return ScaleSnapshot(
            t=now, size=len(live),
            backlog=ep["queued_cols"],
            inflight=sum(r["outstanding_cols"] for r in live),
            lat_ewma_ms=max(lats) if lats else None,
            deadline_hits=hits, floor=1,
            extra={"width": ep["width"],
                   "depth_ewma": ep["depth_ewma"]})

    return sense


# -- the one-stop surface ----------------------------------------------------


class Autoscaler:
    """``Autoscaler(fleet_or_router, pool, policy)``: wire a target's
    metrics, a capacity pool and a policy into a running controller.

    The target decides the defaults -- a ``CodedFleet`` gets a
    ``LocalPool`` + ``fleet_sensor`` (members are workers; pair with
    ``grow_encodings=True`` so scale-up re-encodes into capacity), a
    ``Router`` gets a ``ReplicaPool`` + ``router_sensor`` for the
    named ``endpoint`` (members are replica fleets).  The policy
    defaults to ``QueueDepthPolicy`` with the ``REPRO_SCALE_*``
    watermarks.  ``start()`` launches the loop; ``step()`` stays
    available for deterministic, clock-injected use without threads.
    """

    def __init__(self, target, pool=None, policy=None, *,
                 endpoint: str | None = None,
                 n_workers: int | None = None,
                 transport: str | None = None,
                 min_members: int | None = None,
                 max_members: int | None = None,
                 interval_s: float | None = None,
                 cooldown_s: float | None = None,
                 max_step_up: int = 4, clock=None, tracer=None):
        self.target = target
        if hasattr(target, "add_replica"):      # router-shaped
            if endpoint is None:
                raise ValueError("Autoscaler over a Router needs "
                                 "endpoint=<name>")
            pool = pool if pool is not None else ReplicaPool(
                target, endpoint, n_workers=n_workers, transport=transport)
            sensor = router_sensor(target, endpoint)
        elif hasattr(target, "add_worker"):     # fleet-shaped
            pool = pool if pool is not None else LocalPool(target)
            sensor = fleet_sensor(target)
        else:
            raise TypeError(f"cannot autoscale {type(target).__name__}: "
                            f"expected a CodedFleet or Router")
        self.pool = pool
        self.policy = policy if policy is not None else QueueDepthPolicy()
        self.controller = ScaleController(
            self.pool, self.policy, sensor, clock=clock,
            interval_s=interval_s, cooldown_s=cooldown_s,
            min_members=min_members, max_members=max_members,
            max_step_up=max_step_up, tracer=tracer)

    @property
    def decisions(self) -> deque:
        return self.controller.decisions

    def step(self, now: float | None = None) -> ScaleDecision:
        return self.controller.step(now)

    def start(self) -> "Autoscaler":
        self.controller.start()
        return self

    def close(self) -> None:
        self.controller.close()

    def metrics(self) -> dict:
        return self.controller.metrics()

    def decision_log(self) -> list[dict]:
        return self.controller.decision_log()

    def __enter__(self) -> "Autoscaler":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()
