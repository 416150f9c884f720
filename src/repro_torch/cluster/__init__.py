"""Cluster runtime: shared-worker fleet sessions over pluggable
transports, measuring real straggler mitigation (the port of
``repro.cluster``).

``compile_plan(...).to_cluster()`` turns a precompiled ``CodedPlan``
into a ``ClusterPlan`` with the same ``matvec / matmat / aggregate``
surface, backed by real workers:

  * ``wire``       -- versioned plan / shard / task / result / heartbeat
    serialization (wire v6, byte for byte the JAX package's: frames
    cross-load both ways), with support-restricted task payloads so
    per-task traffic is omega/k-proportional;
  * ``worker``     -- the transport-agnostic worker core: one serve loop
    + heartbeat ticker shared by every transport; a host worker
    multiplies scipy BSR, a card worker runs ``bcsr_matmul``;
  * ``transport``  -- the byte carriers ported so far: ``memory``
    (in-process threads) and ``pipe`` (spawned subprocesses); pick via
    ``to_cluster(transport=...)``, ``CodedConfig.transport``, or the
    ``REPRO_CLUSTER_TRANSPORT`` env var;
  * ``fleet``      -- the session spine: ``CodedFleet`` owns one
    persistent worker set + one long-lived dispatcher loop;
    ``attach(plan)`` ships shards once and returns a ``PlanHandle``
    whose ``submit_*`` calls return ``CodedFuture``s -- multiple rounds
    in flight, queued matvecs microbatched into wider rounds,
    heartbeat-derived liveness, partial-straggler credit, deadlines,
    elastic membership and re-encode on worker loss; a card plan's
    decode is one ``decode_matmul`` per round;
  * ``dispatcher`` -- ``ClusterPlan``, the blocking single-plan shim;
  * ``faults``     -- deterministic latency / death / hang injection as a
    decorator around any transport's serve path.

Not ported yet (ROADMAP.md §1 items 9-10): the ``tcp`` and ``shm``
transports, ``retry`` (``RetryPolicy``) and ``chaos`` (the seeded chaos
harness).
"""

from .dispatcher import ClusterPlan, ClusterReport  # noqa: F401
from .faults import (  # noqa: F401
    FailStop,
    Hang,
    NoFaults,
    ScriptedFaults,
    StragglerFaults,
    WorkerFailure,
    WorkerHang,
    adversarial_faults,
    faulty,
    from_spec,
    straggler_mask,
)
from .fleet import (  # noqa: F401
    CodedFleet,
    CodedFuture,
    FleetDegraded,
    PlanHandle,
    default_max_inflight,
    default_min_workers,
)
from .transport import (  # noqa: F401
    TRANSPORTS,
    Transport,
    make_transport,
    resolve_transport,
)
from .wire import (  # noqa: F401
    Heartbeat,
    PlanShard,
    Task,
    TaskResult,
    WorkerJoin,
    WorkerLeave,
    dumps_plan,
    loads_plan,
    shard_plan,
)
from .worker import ShardRuntime, serve_loop, start_heartbeat  # noqa: F401
