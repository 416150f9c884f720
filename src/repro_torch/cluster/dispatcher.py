"""``ClusterPlan``: the blocking single-plan shim over ``CodedFleet``
(the port of ``repro.cluster.dispatcher``).

In the JAX package's history this module once *was* the dispatcher --
an asyncio event loop spun up per call, torn down at decode.  The fleet
(``repro_torch.cluster.fleet``) holds the whole
coordination spine -- the uniform event stream, heartbeat-driven
suspicion, fail-stop requeue with shard re-shipping, partial-straggler
credit, deadlines, decode-at-fastest-k with the LRU pattern cache --
into one long-lived session loop shared by many plans and many
in-flight rounds.  What remains here is the back-compat surface:

    ClusterPlan(plan, n_workers, transport=...)  ==
        CodedFleet(n_workers, transport=..., max_inflight=1,
                   microbatch=False, device=..., backend=...).attach(plan)

with the same blocking ``matvec / matmat / aggregate`` signatures,
per-round ``ClusterReport``s, bytes-on-wire accounting, and liveness
semantics as before -- every round is one future submitted to the
fleet and immediately ``result()``-ed.  Explicit ``done=`` masks stay
parity mode: only those rows are dispatched and the decode uses
exactly that pattern, so the result is bitwise the in-process packed
backend's (the acceptance check for the whole wire/worker/fleet stack,
on every transport).  The workers follow the plan: a card plan
(``backend="cuda"``), or an aggregation-only plan on the card, is served
by card workers on the plan's device, any other plan by host workers.

New code should hold a ``CodedFleet`` directly (``repro_torch.api.fleet``):
shared workers across plans, async futures, pipelined rounds and
matvec microbatching all live there.
"""

from __future__ import annotations

from .fleet import (  # noqa: F401 - re-export
    ClusterReport,
    CodedFleet,
    plan_workers,
)


class ClusterPlan:
    """A compiled plan served by real workers (see module docstring).

    Build via ``CodedPlan.to_cluster(...)`` or from shipped bytes via
    ``ClusterPlan.from_bytes(...)``.  Use as a context manager or call
    ``shutdown()`` -- worker threads/processes/sockets are real
    resources and the (private, single-plan) fleet owns them.
    """

    def __init__(self, plan, n_workers: int | None = None, *,
                 transport: str | None = None, faults=None,
                 deadline: float | None = None,
                 heartbeat_s: float = 0.25,
                 suspect_after: float | None = None):
        self.plan = plan
        self.deadline = deadline
        w = n_workers if n_workers is not None else plan.n
        if not 1 <= w <= plan.n:
            raise ValueError(f"n_workers must be in [1, {plan.n}], got {w}")
        # the workers' compute follows the plan
        backend, device = plan_workers(plan)
        self.fleet = CodedFleet(
            w, transport=transport, faults=faults, heartbeat_s=heartbeat_s,
            suspect_after=suspect_after, max_inflight=1, microbatch=False,
            device=device, backend=backend)
        try:
            self.handle = self.fleet.attach(plan, deadline=deadline)
        except BaseException:
            self.fleet.close()
            raise
        self._closed = False

    # -- lifecycle ---------------------------------------------------------

    @classmethod
    def from_bytes(cls, data: bytes, *, device=None, **kw) -> "ClusterPlan":
        """Serve a ``dumps_plan`` frame; the plan lands on ``device`` (the
        card unless ``device="cpu"``)."""
        from .wire import loads_plan  # noqa: PLC0415

        return cls(loads_plan(data, device=device), **kw)

    def shutdown(self) -> None:
        if self._closed:
            return
        self._closed = True
        try:
            self.fleet.close()
        except Exception:  # pragma: no cover - teardown best-effort
            pass

    def __enter__(self) -> "ClusterPlan":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()

    def __del__(self):  # pragma: no cover - gc-time safety net
        try:
            self.shutdown()
        except Exception:
            pass

    # -- introspection ----------------------------------------------------

    @property
    def n_workers(self) -> int:
        return self.handle.n_workers

    @property
    def n_tasks(self) -> int:
        return self.handle.n_tasks

    @property
    def k(self) -> int:
        return self.handle.k

    @property
    def packed(self):
        return self.handle._ps.packed

    @property
    def transport(self):
        return self.fleet.transport

    @property
    def transport_name(self) -> str:
        return self.fleet.transport_name

    @property
    def reports(self):
        return self.handle.reports

    @property
    def last_report(self) -> ClusterReport | None:
        return self.handle.last_report

    @property
    def bytes_shards(self) -> int:
        return self.handle.bytes_shards

    @property
    def bytes_tasks_total(self) -> int:
        return self.handle.bytes_tasks_total

    @property
    def _shard_bytes(self) -> list[bytes]:
        return self.handle.shard_blobs

    def wire_totals(self) -> dict:
        """Cumulative bytes-on-wire: shards (shipped once, plus any
        re-shipping) and per-task traffic across all rounds."""
        return self.handle.wire_totals()

    # -- public ops (CodedPlan signatures) ---------------------------------

    def matvec(self, x, done=None, *, deadline: float | None = None):
        """A^T x served by the cluster; ``done=None`` races the workers
        (decode at fastest-k), an explicit mask replays that exact
        pattern (parity mode)."""
        self._check_open()
        return self.handle.submit_matvec(x, done,
                                         deadline=deadline).result()

    def matmat(self, B, done=None, *, deadline: float | None = None):
        """A^T B through paired coded operands, workers doing the
        per-worker products; each task ships only the nonzero coded-B
        block-rows in its tile support (the omega_B/k_B claim)."""
        self._check_open()
        return self.handle.submit_matmat(B, done,
                                         deadline=deadline).result()

    def aggregate(self, payloads, done=None, *,
                  deadline: float | None = None):
        """Straggler-resilient sum of k shard-gradients, collected from
        real workers (gradient-coding decode: a^T G[rows] = 1^T)."""
        self._check_open()
        return self.handle.submit_aggregate(payloads, done,
                                            deadline=deadline).result()

    def reship(self) -> int:
        """Re-shard the (re-compiled) plan and re-ship every worker's
        shard to its current holder (see ``Trainer coded_plans=``).
        Returns bytes shipped."""
        self._check_open()
        return self.handle.reship()

    def _check_open(self) -> None:
        if self._closed:
            raise RuntimeError("cluster has been shut down")
