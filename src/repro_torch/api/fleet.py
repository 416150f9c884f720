"""Public fleet-session API: shared workers, async futures,
microbatched rounds (the port of ``repro.api.fleet``).

    from repro_torch.api.fleet import CodedFleet

    fleet = CodedFleet(n_workers=12, transport="memory")   # on the card
    head = fleet.attach(head_plan)        # shards shipped once
    agg = fleet.attach(agg_plan)          # same workers, second plan

    futs = [head.submit_matvec(x) for x in batches]   # rounds pipeline;
    ys = [f.result() for f in futs]                   # matvecs coalesce
    g = agg.submit_aggregate(payloads).result()
    fleet.close()

A ``CodedFleet`` owns one persistent transport + worker set and one
long-lived dispatcher event loop; every consumer of coded compute (the
serve engine's LM head via ``CodedConfig.fleet``; in the JAX package
also ``CodedMoE`` experts and ``CodedAggregator``, not ported yet)
attaches to the same session instead of hoarding its own workers.  Its
workers run on the card (``bcsr_matmul``) unless the caller asks for
the CPU (``CodedFleet(..., device="cpu")``); a card plan needs card
workers and a host plan host workers.  Submissions return ``CodedFuture``s (``result`` / ``done`` /
``add_done_callback`` / ``cancel``) with multiple rounds in flight,
bounded-queue backpressure, per-plan deadlines, and matvec -> matmat
microbatching (queued matvecs against one plan coalesce into a wider
round and decode back out bitwise-identically).  The in-flight cap
defaults from the ``REPRO_FLEET_MAX_INFLIGHT`` env var.

The session is *elastic* and self-healing: ``fleet.add_worker()``
admits a device into the running session (every attached plan's shards
are caught up and ownership rebalances), ``fleet.remove_worker(w)``
drains in-flight rows before closing the channel, and worker loss
degrades gracefully -- shards re-home, plans re-encode at reduced
resilience (``k`` preserved, ``s`` shrunk) using heartbeat-derived
per-worker throughput for hetero capacities, and below ``min_workers``
(env ``REPRO_FLEET_MIN_WORKERS``) futures fail fast with a structured
``FleetDegraded`` carrying the recovery action -- never a hang.

Observability: ``fleet.metrics()`` / ``handle.metrics()`` return a
structured snapshot (queue depth, in-flight rounds, per-plan latency
EWMAs, resolution counters, worker capacities) -- degradation is
visible to any caller, not only via exceptions.  Per-plan coalescing
is dynamic: ``handle.set_microbatch_cols(cols)`` retargets the width
cap live, and ``handle.submit_matvec_many(xs)`` packs an explicit
group into exactly one round with per-call bitwise decode.  The JAX
package's multi-tenant serve front door over fleet replicas
(``repro.serve.Router``) is not ported yet.

The implementation lives in ``repro_torch.cluster.fleet`` (it is cluster
machinery: transports, wire plan routing, liveness); this module is
the supported import path.
"""

from ..cluster.fleet import (  # noqa: F401
    ENV_MAX_INFLIGHT,
    ENV_MIN_WORKERS,
    ClusterReport,
    CodedFleet,
    CodedFuture,
    FleetDegraded,
    PlanHandle,
    default_max_inflight,
    default_min_workers,
)
