"""repro_torch.scale: the closed load->capacity loop (the port of
``repro.scale``).

The fleet holds the elastic *mechanism* (live ``add_worker`` /
``remove_worker``, re-encode for the new ``(n, s)``), the fleet, the
router and ``repro_torch.obs.attribute`` the *sensors*
(``fleet.metrics()``, ``router.metrics()``); this package adds the
policy + provisioning layer that changes the roster in response to
load:

    from repro_torch.scale import Autoscaler, LatencySloPolicy

    fleet = CodedFleet(2, grow_encodings=True)     # card workers
    scaler = Autoscaler(fleet, policy=LatencySloPolicy(slo_ms=250),
                        max_members=12).start()
    ...                     # load ramps: workers follow
    scaler.close()

Layers: ``pool`` (where capacity comes from -- local workers, remote
``--connect`` dials, router replicas), ``policy`` (what size the load
wants -- queue depth, latency SLO, schedules), ``controller`` (the
deterministic hysteresis loop tying them together, injectable clock
and all).  Capacity is added where the target computes: a card fleet
grows by card workers, a router endpoint by replica fleets on its
plan's device.  Env knobs: ``REPRO_SCALE_INTERVAL_MS``, ``REPRO_SCALE_HIGH``
/ ``REPRO_SCALE_LOW``, ``REPRO_SCALE_COOLDOWN_MS``,
``REPRO_SCALE_MIN_WORKERS`` / ``REPRO_SCALE_MAX_WORKERS`` -- all
strictly parsed (garbage fails loudly, naming the variable).
"""

from .controller import (  # noqa: F401
    Autoscaler,
    ScaleController,
    ScaleDecision,
    fleet_sensor,
    router_sensor,
)
from .policy import (  # noqa: F401
    ENV_COOLDOWN_MS,
    ENV_HIGH,
    ENV_INTERVAL_MS,
    ENV_LOW,
    ENV_MAX_WORKERS,
    ENV_MIN_WORKERS,
    LatencySloPolicy,
    QueueDepthPolicy,
    ScaleSnapshot,
    SchedulePolicy,
    ScalingPolicy,
    SchedulePolicy as StepPolicy,  # the scheduled/step policy, by its
    default_cooldown_ms,           # other common name
    default_high_watermark,
    default_interval_ms,
    default_low_watermark,
    default_max_members,
    default_min_members,
)
from .pool import (  # noqa: F401
    LocalPool,
    ProvisionError,
    RemotePool,
    ReplicaPool,
    WorkerPool,
)

__all__ = [
    "Autoscaler", "LatencySloPolicy", "LocalPool", "ProvisionError",
    "QueueDepthPolicy", "RemotePool", "ReplicaPool", "ScaleController",
    "ScaleDecision", "ScaleSnapshot", "SchedulePolicy", "ScalingPolicy",
    "StepPolicy", "WorkerPool", "fleet_sensor", "router_sensor",
]
