"""Scaling policies: load signals in, a desired pool size out.

A ``ScalingPolicy`` is a pure function of one ``ScaleSnapshot`` (the
controller samples it from ``fleet.metrics()`` / ``router.metrics()``
each tick) returning the pool size it wants, or None for "no
opinion".  Policies hold the watermarks; the controller owns the
hysteresis (cooldowns, min/max clamps, one-member-at-a-time
decommission) -- so a policy can be aggressive and the loop still
won't flap.

Three to start, mirroring how real autoscalers are driven:

* ``QueueDepthPolicy``  -- backlog per member against high/low
  watermarks; sizes the pool to the work actually queued.
* ``LatencySloPolicy``  -- latency EWMA against a target SLO; grows
  while the SLO is violated, shrinks only when latency is comfortably
  inside it *and* the backlog is gone.
* ``SchedulePolicy``    -- deterministic (elapsed-time, size) steps;
  the scheduled/step policy used by tests, benches and planned
  capacity changes.

Defaults for the watermarks come from the ``REPRO_SCALE_*`` env knobs
(strict parsing via ``repro_torch._env.env_int``: garbage fails
loudly).  The port of ``repro.scale.policy``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .._env import env_int

ENV_INTERVAL_MS = "REPRO_SCALE_INTERVAL_MS"
ENV_HIGH = "REPRO_SCALE_HIGH"
ENV_LOW = "REPRO_SCALE_LOW"
ENV_COOLDOWN_MS = "REPRO_SCALE_COOLDOWN_MS"
ENV_MIN_WORKERS = "REPRO_SCALE_MIN_WORKERS"
ENV_MAX_WORKERS = "REPRO_SCALE_MAX_WORKERS"


def default_interval_ms() -> int:
    """Control-loop period: ``REPRO_SCALE_INTERVAL_MS``, else 200."""
    return env_int(ENV_INTERVAL_MS, 200)


def default_high_watermark() -> int:
    """Backlog-per-member scale-up trigger: ``REPRO_SCALE_HIGH``,
    else 8 (columns/calls queued per serving member)."""
    return env_int(ENV_HIGH, 8)


def default_low_watermark() -> int:
    """Backlog-per-member scale-down trigger: ``REPRO_SCALE_LOW``,
    else 1.  May legitimately be 0 (only scale down when idle)."""
    return env_int(ENV_LOW, 1, min=0)


def default_cooldown_ms() -> int:
    """Seconds*1e3 between scale actions: ``REPRO_SCALE_COOLDOWN_MS``,
    else 1000."""
    return env_int(ENV_COOLDOWN_MS, 1000)


def default_min_members() -> int:
    """Pool floor: ``REPRO_SCALE_MIN_WORKERS``, else 1."""
    return env_int(ENV_MIN_WORKERS, 1)


def default_max_members() -> int:
    """Pool ceiling: ``REPRO_SCALE_MAX_WORKERS``, else 16."""
    return env_int(ENV_MAX_WORKERS, 16)


@dataclass
class ScaleSnapshot:
    """One tick's worth of load signal, normalized across fleet- and
    router-shaped sources so policies never touch raw metrics dicts.

    ``backlog`` is queued work not yet on a worker (calls or columns,
    whichever the source counts), ``inflight`` is work already
    dispatched, ``lat_ewma_ms`` the freshest latency EWMA (None before
    any round resolved), ``floor`` the availability floor below which
    the *source* itself starts failing futures (``fleet.min_workers``;
    1 for routers, which refuse to drop the last replica)."""

    t: float
    size: int
    backlog: float = 0.0
    inflight: float = 0.0
    lat_ewma_ms: float | None = None
    deadline_hits: int = 0
    floor: int = 1
    extra: dict = field(default_factory=dict)

    @property
    def backlog_per_member(self) -> float:
        return self.backlog / max(self.size, 1)


class ScalingPolicy:
    """``target(snapshot) -> int | None``: desired pool size, or None
    for no opinion this tick."""

    name = "base"

    def target(self, snap: ScaleSnapshot) -> int | None:
        raise NotImplementedError

    def describe(self) -> dict:
        return {"policy": self.name}


class QueueDepthPolicy(ScalingPolicy):
    """Size the pool to the queued work.

    Above ``high`` backlog per member the target jumps straight to
    ``ceil(backlog / high)`` -- enough members that the *current*
    backlog would sit at the high watermark -- so a load step converges
    in one or two actions instead of creeping up one member per
    cooldown.  At or below ``low`` (with nothing in flight) it shrinks
    one member at a time; draining is deliberate even when growing is
    not.
    """

    name = "queue-depth"

    def __init__(self, high: int | None = None, low: int | None = None):
        self.high = high if high is not None else default_high_watermark()
        self.low = low if low is not None else default_low_watermark()
        if self.low >= self.high:
            raise ValueError(f"low watermark {self.low} must sit below "
                             f"high watermark {self.high}")

    def target(self, snap: ScaleSnapshot) -> int | None:
        per = snap.backlog_per_member
        if per > self.high:
            want = -(-int(snap.backlog) // self.high)   # ceil div
            return max(want, snap.size + 1)
        if per <= self.low and snap.inflight == 0:
            return snap.size - 1
        return None

    def describe(self) -> dict:
        return {"policy": self.name, "high": self.high, "low": self.low}


class LatencySloPolicy(ScalingPolicy):
    """Grow while the latency EWMA violates the SLO; shrink only when
    latency is under ``shrink_frac * slo_ms`` *and* the backlog per
    member is at or below ``low`` -- a quiet queue with a stale-but-low
    EWMA is the only safe shrink signal latency alone can give."""

    name = "latency-slo"

    def __init__(self, slo_ms: float, *, shrink_frac: float = 0.5,
                 low: int | None = None):
        if slo_ms <= 0:
            raise ValueError(f"slo_ms must be positive, got {slo_ms}")
        self.slo_ms = float(slo_ms)
        self.shrink_frac = shrink_frac
        self.low = low if low is not None else default_low_watermark()

    def target(self, snap: ScaleSnapshot) -> int | None:
        lat = snap.lat_ewma_ms
        if lat is not None and lat > self.slo_ms:
            return snap.size + 1
        if (snap.backlog_per_member <= self.low and snap.inflight == 0
                and (lat is None or lat < self.shrink_frac * self.slo_ms)):
            return snap.size - 1
        return None

    def describe(self) -> dict:
        return {"policy": self.name, "slo_ms": self.slo_ms,
                "shrink_frac": self.shrink_frac, "low": self.low}


class SchedulePolicy(ScalingPolicy):
    """Planned capacity: ``steps`` is ``[(t_from_s, size), ...]`` on
    the controller's clock, relative to the first tick.  The active
    step is the last one whose ``t_from_s`` has elapsed -- fully
    deterministic, which makes this the policy of choice for replaying
    a scaling scenario under test or chaos."""

    name = "schedule"

    def __init__(self, steps):
        steps = sorted((float(t), int(size)) for t, size in steps)
        if not steps:
            raise ValueError("SchedulePolicy needs at least one step")
        if steps[0][0] != 0.0:
            steps.insert(0, (0.0, steps[0][1]))
        self.steps = steps
        self._t0: float | None = None

    def target(self, snap: ScaleSnapshot) -> int | None:
        if self._t0 is None:
            self._t0 = snap.t
        elapsed = snap.t - self._t0
        size = self.steps[0][1]
        for t_from, s in self.steps:
            if elapsed >= t_from:
                size = s
        return size

    def describe(self) -> dict:
        return {"policy": self.name, "steps": list(self.steps)}
