"""CodedFleet: a self-healing shared-worker session runtime with async
futures, in-flight pipelining, matvec microbatching, and elastic
membership.

The port of ``repro.cluster.fleet``.  The session protocol is the JAX
package's, line for line; what changes is where the numbers live.  A
card plan (``backend="cuda"``) is served by card workers
(``bcsr_matmul``), encodes a matmat's B with ``cyclic_encode`` and
decodes every round with one ``decode_matmul`` on the plan's device; a
host plan keeps the JAX package's numpy ``hinv @ y``, so its parity
mode stays bitwise against the in-process ``packed`` backend.  Results
are tensors on the plan's device either way.  The workers' device and
backend are the fleet's (``CodedFleet(device=, backend=)``), on the card
unless the caller asks for the CPU.

The paper's schemes exist to keep *many* edge devices productively
busy; before this module the repo's public surface was one blocking
call on one private cluster per plan -- every round span up a fresh
event loop, workers idled between rounds, and each consumer (LM head,
MoE experts, gradient aggregator) hoarded its own worker fleet.  A
``CodedFleet`` replaces that spine:

  * **one session, many plans** -- the fleet owns one persistent
    transport + worker set and one long-lived dispatcher event loop
    (created once, never per call).  ``fleet.attach(plan)`` ships the
    plan's shards once; workers co-host every attached plan's BSR task
    tables, keyed by the wire plan id, so the coded LM head, the
    MoE experts and the gradient aggregator all serve off the *same*
    devices;
  * **async futures** -- ``handle.submit_matvec(x)`` returns a
    ``CodedFuture`` (``result`` / ``done`` / ``add_done_callback`` /
    ``cancel``) immediately; multiple rounds stay in flight at once,
    multiplexed over the shared loop and demuxed by ``(plan, round)``
    from the transport's uniform event stream;
  * **microbatching** -- queued matvec calls against the same plan
    coalesce into one wider round (operand columns packed side by
    side, the paper family's MM-regime insight: coding overhead
    amortizes across columns -- Das & Ramamoorthy 2021, Das et al.
    2023).  Decode slices each call's columns back out and resolves
    its future *bitwise-identically* to a solo round;
  * **backpressure + deadlines** -- per-plan bounded submission
    (callers block once ``queue_cap`` calls are unresolved -- or, with
    ``admission="shed"``, get an immediate ``FleetDegraded`` instead of
    queueing: bounded-queue admission control), a fleet in-flight cap
    (``max_inflight``, default from ``REPRO_FLEET_MAX_INFLIGHT``), and
    per-plan / per-call deadlines that fail the affected futures
    without tearing the session down;
  * **elastic membership (wire v4)** -- ``fleet.add_worker()`` admits a
    device into the *running* session: the transport pushes a
    ``WorkerJoin``, the fleet catches the newcomer up (every attached
    plan's shards, rebalanced off the most-loaded holders) and confirms
    with a welcome frame.  ``fleet.remove_worker(w)`` drains first:
    future rows re-home immediately, in-flight rows get ``timeout``
    seconds to finish on the leaver, then the channel closes without a
    death notice.  A worker failed by *suspicion* (not a real death)
    that heartbeats again is re-admitted automatically -- a healed
    partition restores capacity without operator action;
  * **graceful degradation** -- worker loss re-homes shards and, once the live set can no longer host a plan's
    ``n`` coded tasks at full strength, the plan is *re-encoded* for
    the shrunken fleet under a fresh plan id: ``k`` is preserved while
    resilience ``s = n' - k`` shrinks (resilience degrades before
    availability).  Per-worker throughput EWMAs (measured from
    submit->result latency) feed ``proposed-hetero`` capacities on
    re-encode, so a slow-but-alive device gets proportionally fewer
    virtual tiles.  Below ``min_workers``
    (``REPRO_FLEET_MIN_WORKERS``) the fleet fails fast: every future
    resolves with a structured ``FleetDegraded`` carrying the recovery
    action -- never a hang;
  * the full liveness protocol: heartbeat-driven *two-phase* suspicion
    (a worker with outstanding rows is first marked suspected; a late
    beat inside ``suspect_grace`` un-suspects it before any re-ship),
    death notices, dropped connections -- all re-homing a dead
    worker's shards to the least-loaded live host and resubmitting its
    in-flight rows across all live rounds.

``ClusterPlan`` (``repro_torch.cluster.dispatcher``) survives as a thin
back-compat shim: a private single-plan fleet with ``max_inflight=1``
and microbatching off, so its blocking ``matvec / matmat / aggregate``
keep their exact semantics (including bitwise parity under explicit
``done=`` masks).
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import itertools
import os
import threading
import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from .._device import as_tensor, host_f32, host_mask, resolve_device
from .._env import env_int
from ..obs.attrib import attribute
from ..obs.trace import default_tracer
from .transport import make_transport
from .wire import Heartbeat, Task, WorkerJoin, WorkerLeave, plan_packed, \
    shard_plan
from .worker import worker_backend

ENV_MAX_INFLIGHT = "REPRO_FLEET_MAX_INFLIGHT"
ENV_MIN_WORKERS = "REPRO_FLEET_MIN_WORKERS"
_POLL_S = 0.02          # transport poll slice on the pump thread
_TICK_S = 0.025         # watchdog period (suspicion + deadlines)


def default_max_inflight() -> int:
    """Fleet in-flight round cap: ``REPRO_FLEET_MAX_INFLIGHT``, else 8."""
    return env_int(ENV_MAX_INFLIGHT, 8)


def default_min_workers() -> int:
    """Availability floor: ``REPRO_FLEET_MIN_WORKERS``, else 1.  Below
    it the fleet fails futures fast instead of limping on."""
    return env_int(ENV_MIN_WORKERS, 1)


class FleetDegraded(RuntimeError):
    """The fleet degraded past what this call can survive.

    ``action`` says what happened and what recovery looks like:

    * ``"re-encode"`` -- the plan was re-encoded for a shrunken fleet
      while this call was queued and its inputs were tied to the old
      geometry (explicit ``done=`` masks, per-task aggregate payloads).
      Recovery: resubmit against the current plan.
    * ``"shed"`` -- bounded-queue admission control rejected the call
      (``admission="shed"`` and ``queue_cap`` unresolved calls).
      Recovery: back off and resubmit, or raise ``queue_cap``.
    * ``"fail"`` -- live workers dropped below the availability floor
      (``min_workers``) or to zero.  Recovery: ``fleet.add_worker()``
      (or lower ``REPRO_FLEET_MIN_WORKERS``).

    Subclasses ``RuntimeError`` so pre-elastic callers that caught the
    broad class keep working.
    """

    def __init__(self, message: str, *, action: str = "fail",
                 plan_id: int | None = None):
        super().__init__(message)
        self.action = action
        self.plan_id = plan_id


@dataclass
class ClusterReport:
    """What one dispatched round observed (the bench's raw material)."""

    op: str
    round: int
    plan_id: int = 0
    calls: int = 1             # futures resolved by this round (microbatch)
    wall_s: float = 0.0        # dispatch -> k-th completion + decode
    decode_s: float = 0.0
    n_tasks: int = 0
    n_dispatched: int = 0
    n_done: int = 0
    pattern: np.ndarray | None = None       # observed task-done mask
    rows: np.ndarray | None = None          # rows actually decoded from
    deaths: int = 0
    suspected: int = 0         # liveness: missed-heartbeat fail-stops
    requeues: int = 0
    deadline_hit: bool = False
    bytes_tasks: int = 0       # task frames actually put on the wire
    bytes_results: int = 0     # result payload bytes received
    bytes_tasks_dense: int = 0  # what full-operand shipping would have cost
    bytes_copied: int = 0      # task-path memcpy bytes (wire v6): transport
                               # serialize/staging copies + worker-side
                               # operand materialization, NOT the operand
                               # build every transport pays identically
    completed_per_worker: dict = field(default_factory=dict)
    partial_workers: tuple[int, ...] = ()   # hosts with 0 < done < owned
    worker_work: dict = field(default_factory=dict)

    def as_dict(self) -> dict:
        return {
            "op": self.op, "round": self.round, "plan_id": self.plan_id,
            "calls": self.calls, "wall_s": self.wall_s,
            "decode_s": self.decode_s, "n_tasks": self.n_tasks,
            "n_dispatched": self.n_dispatched, "n_done": self.n_done,
            "deaths": self.deaths, "suspected": self.suspected,
            "requeues": self.requeues, "deadline_hit": self.deadline_hit,
            "bytes_tasks": self.bytes_tasks,
            "bytes_results": self.bytes_results,
            "bytes_tasks_dense": self.bytes_tasks_dense,
            "bytes_copied": self.bytes_copied,
            "partial_workers": list(self.partial_workers),
        }


def _independent_rows(G: np.ndarray, done_rows, k: int):
    """Greedy full-rank row pick in completion order, for patterns whose
    first-k rows are singular (non-MDS baselines like repetition)."""
    sel: list[int] = []
    for r in done_rows:
        trial = sel + [int(r)]
        if np.linalg.matrix_rank(G[trial]) == len(trial):
            sel = trial
            if len(sel) == k:
                return np.asarray(sel)
    return None


def _leaves(tree):
    """The leaves of a dict / list / tuple tree, in a fixed order."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _rebuild(tree, leaves):
    """``tree``'s structure over the next leaves of the iterator
    ``leaves`` (the inverse of ``_leaves``)."""
    if isinstance(tree, dict):
        return {key: _rebuild(v, leaves) for key, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, leaves) for v in tree)
    return next(leaves)


def _on_card(plan) -> bool:
    """A card plan: served by card workers, decoded by ``decode_matmul``."""
    return plan.backend == "cuda"


def plan_workers(plan) -> tuple[str, torch.device]:
    """The workers a plan needs: (backend, device).  A card plan gets
    card workers on its own device (the kernel's plain version when that
    device is the CPU), and so does an aggregation-only plan on the card
    (its workers multiply nothing); any other plan gets host workers,
    whose bitwise parity holds only on ``packed``."""
    if _on_card(plan) or (plan.executor is None
                          and plan.device.type == "cuda"):
        return "cuda", plan.device
    return "packed", torch.device("cpu")


def wait_settled(handle: "PlanHandle", n_shards: int,
                 timeout: float = 30.0) -> float:
    """Block until ``handle``'s plan is encoded for ``n_shards`` hosts
    with no re-encode pending; -> the seconds waited.  A scale step or a
    death re-encodes on the fleet's loop, so ``handle.plan`` read right
    after it may still be the old plan; read from another thread, the
    new shard count can even show before the new plan id is stored.  So
    the state is read on the loop, where a re-encode runs whole within
    one callback.  Raises ``TimeoutError`` when it does not settle."""
    fleet, ps = handle.fleet, handle._ps
    t0 = time.perf_counter()

    def settled() -> bool:
        fut = concurrent.futures.Future()
        fleet._loop.call_soon_threadsafe(lambda: fut.set_result(
            ps.n_shards == n_shards and not ps.pending_reencode))
        return fut.result(timeout=max(timeout, 1.0))

    while not settled():
        if time.perf_counter() - t0 > timeout:
            raise TimeoutError(
                f"plan not settled on {n_shards} shards in {timeout} s "
                f"(at {ps.n_shards}, re-encode pending: "
                f"{ps.pending_reencode})")
        time.sleep(0.02)
    return time.perf_counter() - t0


def _device_inverse(hinv, hinv_dev, device) -> torch.Tensor:
    """The decode inverse on the plan's device (the decode cache holds
    it there; a fallback pick of rows was inverted on the host)."""
    return hinv_dev if hinv_dev is not None else \
        torch.from_numpy(np.asarray(hinv, np.float32)).to(device)


# ---------------------------------------------------------------------------
# Futures
# ---------------------------------------------------------------------------


class CodedFuture:
    """Handle for one in-flight coded call.

    ``result(timeout)`` blocks for the decoded value (re-raising the
    round's error), ``done()``/``cancelled()`` poll, ``cancel()``
    withdraws a still-queued call (a launched round is not
    cancellable, mirroring ``concurrent.futures`` semantics), and
    ``add_done_callback(fn)`` fires ``fn(future)`` on resolution --
    from the fleet's loop thread, so callbacks must not block on other
    futures.  After a successful race-mode round ``future.report``
    holds the round's ``ClusterReport`` (observed pattern, wall/decode
    time, per-worker credit).

    A future may also be owned by a non-fleet producer (the serve
    router wraps queued calls in the same type): construct with
    ``fleet=None`` and resolve via ``_finish``; ``cancel()`` then
    delegates to ``_canceller`` when the owner installed one.
    """

    def __init__(self, fleet: "CodedFleet | None" = None,
                 ps: "_PlanState | None" = None):
        self._fleet = fleet
        self._ps = ps
        self._event = threading.Event()
        self._value = None
        self._exc: BaseException | None = None
        self._cancelled = False
        self._callbacks: list = []
        self._lock = threading.Lock()
        self._canceller = None          # non-fleet owners install a hook
        self._t_submit: float | None = None
        self.report: ClusterReport | None = None

    # -- consumer side -----------------------------------------------------

    def done(self) -> bool:
        return self._event.is_set()

    def cancelled(self) -> bool:
        return self._event.is_set() and self._cancelled

    def result(self, timeout: float | None = None):
        if not self._event.wait(timeout):
            raise TimeoutError("coded future not resolved within timeout")
        if self._cancelled:
            raise concurrent.futures.CancelledError()
        if self._exc is not None:
            raise self._exc
        return self._value

    def exception(self, timeout: float | None = None):
        if not self._event.wait(timeout):
            raise TimeoutError("coded future not resolved within timeout")
        if self._cancelled:
            raise concurrent.futures.CancelledError()
        return self._exc

    def add_done_callback(self, fn) -> None:
        with self._lock:
            if not self._event.is_set():
                self._callbacks.append(fn)
                return
        fn(self)

    def cancel(self) -> bool:
        """Withdraw the call if it has not been launched into a round
        yet; returns whether the cancellation took."""
        if self._fleet is None:
            if self._canceller is not None:
                return self._canceller(self)
            return self.cancelled()
        return self._fleet._cancel_call(self._ps, self)

    # -- producer side (fleet loop) ---------------------------------------

    def _finish(self, value=None, exc: BaseException | None = None,
                cancelled: bool = False) -> None:
        with self._lock:
            if self._event.is_set():
                return
            self._value, self._exc, self._cancelled = value, exc, cancelled
            callbacks, self._callbacks = self._callbacks, []
            self._event.set()
        ps = self._ps
        if ps is not None:
            ps.sem.release()            # backpressure slot freed
            ps.account(self)            # metrics: counters + latency EWMA
        for fn in callbacks:
            try:
                fn(self)
            except Exception:           # callbacks must not kill the loop
                pass


# ---------------------------------------------------------------------------
# Per-call / per-round / per-plan state
# ---------------------------------------------------------------------------


@dataclass
class _Call:
    """One submitted operation, prepared on the caller's thread.

    ``built_for`` records which plan *version* (plan id) the geometry-
    dependent fields (operand padding, decode closure, target mask)
    were built against; ``rebuild`` re-derives them from the raw input
    when the plan was re-encoded while the call sat queued.  Calls
    whose inputs are tied to the old geometry (explicit ``done=``
    masks, per-task aggregate payloads) carry ``rebuild=None`` and fail
    with ``FleetDegraded(action="re-encode")`` at launch instead.
    """

    op: str
    future: CodedFuture
    target: np.ndarray
    wait_all: bool
    deadline: float | None
    width: int = 0                      # matvec: operand columns
    b_op: np.ndarray | None = None      # matvec operand (t_pad, width)
    decode: object = None               # op-specific decode closure
    make_task: object = None            # (row, round_id) -> Task (mm/agg)
    dense_bytes: int = 0
    built_for: int = 0                  # plan id the fields were built for
    rebuild: object = None              # (call) -> None re-prep, or None
    group: int | None = None            # explicit coalescing group id


class _Round:
    """One dispatched round: the unit the event stream advances."""

    def __init__(self, ps: "_PlanState", round_id: int, calls: list[_Call],
                 make_task, report: ClusterReport, deadline: float | None):
        self.ps = ps
        self.round_id = round_id
        self.calls = calls
        self.make_task = make_task          # (row) -> Task, round id bound
        self.report = report
        self.target = calls[0].target
        self.wait_all = calls[0].wait_all
        self.inflight: dict[int, int] = {}  # row -> worker it went to
        self.results: dict[int, dict] = {}
        self.order: list[int] = []          # completion order of task rows
        self.sent_at: dict[int, float] = {}  # row -> submit stamp (EWMA)
        self.trace = 0                      # tracer round id (0 = untraced)
        # row -> (worker, t_recv, t_start, t_finish, t_arrival): worker
        # stamps on the worker clock, arrival on ours (traced rounds)
        self.task_meta: dict[int, tuple] = {}
        self.t_start = time.perf_counter()
        self.deadline_at = None if deadline is None \
            else self.t_start + deadline

    def missing_on(self, worker: int) -> list[int]:
        return [int(r) for r in np.flatnonzero(self.target)
                if int(r) not in self.results
                and self.inflight.get(int(r)) == worker]


class _PlanState:
    """Fleet-side state of one attached plan.

    ``plan_id`` changes on re-encode (workers key task tables by
    ``(plan, row)``, so a re-encoded plan MUST ship under a fresh id or
    stale rows would shadow new ones); ``versions`` keeps every plan
    object ever served under this state, keyed by the plan id it served
    as -- the chaos harness replays a report's pattern against
    ``versions[report.plan_id]`` for bitwise parity.
    """

    def __init__(self, plan, plan_id: int, n_shards: int, packed, shards,
                 hosts: list[int] | None = None):
        self.plan = plan
        self.plan_id = plan_id
        self.n_shards = n_shards
        self.packed = packed
        self.default_deadline: float | None = None
        self.reports: deque[ClusterReport] = deque(maxlen=512)
        self.bytes_shards = 0
        self.bytes_tasks_total = 0
        self.bytes_copied_total = 0
        self.queue: deque[_Call] = deque()
        self.sem: threading.Semaphore | None = None     # set by the fleet
        self.detached = False
        self.microbatch_cols: int | None = None  # per-plan cap (None = fleet)
        self.counters = {"submitted": 0, "resolved": 0, "failed": 0,
                         "cancelled": 0, "shed": 0, "deadline_hit": 0}
        self._counter_lock = threading.Lock()
        self.lat_ewma_s: float | None = None    # per-call submit -> resolve
        self.wall_ewma_s: float | None = None   # per-round dispatch -> decode
        self.decode_ewma_s: float | None = None
        self.versions: dict[int, object] = {plan_id: plan}
        self.pending_reencode = False
        self.max_shards = n_shards          # full-strength shard count
        self.ratio = max(1, -(-plan.n // n_shards))  # coded rows per host
        self._plan_cache: dict[tuple, object] = {}   # re-encode memo
        self._load_shards(shards, hosts)
        self.home = dict(self.owner)        # original assignment

    def _load_shards(self, shards, hosts: list[int] | None = None) -> None:
        """(Re)derive per-task wire state from freshly cut shards:
        encoded blobs, work units, the input column supports (the
        only x-blocks / coded-B block-rows a task needs shipped --
        omega/k-proportional traffic), and the shard->rows map the
        elastic rebalancer moves ownership by.  ``hosts`` maps the
        cut's host indices to actual worker ids (an elastic fleet's
        roster is not ``range(n)``)."""
        self.shard_blobs = [s.encode() for s in shards]
        self.owner = {row: s.worker for s in shards for row in s.task_rows}
        self.work = {row: s.work[j] for s in shards
                     for j, row in enumerate(s.task_rows)}
        self.support = {row: np.asarray(s.supports[j], np.int64)
                        for s in shards if s.supports
                        for j, row in enumerate(s.task_rows)}
        self.shard_rows = [list(s.task_rows) for s in shards]
        self.shard_hosts = [s.worker for s in shards]
        if hosts is not None:
            remap = {h: hosts[h] for h in range(len(hosts))}
            self.owner = {row: remap[o] for row, o in self.owner.items()}
            self.shard_hosts = [remap[h] for h in self.shard_hosts]

    def bump(self, key: str, by: int = 1) -> None:
        with self._counter_lock:
            self.counters[key] = self.counters.get(key, 0) + by

    def account(self, fut: "CodedFuture") -> None:
        """Resolution-time bookkeeping (any thread; lock-guarded)."""
        if fut._cancelled:
            self.bump("cancelled")
        elif fut._exc is not None:
            self.bump("failed")
            if isinstance(fut._exc, TimeoutError):
                self.bump("deadline_hit")
        else:
            self.bump("resolved")
            if fut._t_submit is not None:
                lat = time.perf_counter() - fut._t_submit
                self.lat_ewma_s = lat if self.lat_ewma_s is None \
                    else 0.8 * self.lat_ewma_s + 0.2 * lat

    def snapshot(self) -> dict:
        """Point-in-time metrics for this plan (no loop round-trip;
        read under the counter lock plus GIL-atomic reads)."""
        with self._counter_lock:
            counters = dict(self.counters)
        queued = list(self.queue)
        to_ms = lambda s: None if s is None else s * 1e3  # noqa: E731
        return {"plan_id": self.plan_id,
                "kind": self.plan.kind,
                "queue_depth": len(queued),
                "queued_cols": sum(max(c.width, 1) for c in queued),
                "microbatch_cols": self.microbatch_cols,
                "pending_reencode": self.pending_reencode,
                "lat_ewma_ms": to_ms(self.lat_ewma_s),
                "wall_ewma_ms": to_ms(self.wall_ewma_s),
                "decode_ewma_ms": to_ms(self.decode_ewma_s),
                "counters": counters}

    def restricted_payload(self, row: int, b_op: np.ndarray) -> dict:
        """Support-restricted task payload: only the nonzero b
        block-rows the worker's tiles read are shipped; the worker
        scatters them back, bitwise-equivalent to dense."""
        sup = self.support.get(row)
        packed = self.packed
        kb = packed.t_pad // packed.bk
        if sup is None or len(sup) >= kb:
            return {"b": b_op}
        blocks = b_op.reshape(kb, packed.bk, b_op.shape[1])
        # drop support rows where this call's operand is exactly zero
        # (a sparse coded-B chunk): zero rows contribute nothing.  The
        # test must treat NaN/inf as nonzero (!= 0 is True for NaN) so
        # a poisoned operand still propagates instead of being dropped
        nz = (blocks[sup] != 0).any(axis=(1, 2))
        sel = sup[nz]
        bx = blocks[sel].reshape(len(sel) * packed.bk, b_op.shape[1])
        return {"bx": np.ascontiguousarray(bx), "bi": sel.astype(np.int32)}


# ---------------------------------------------------------------------------
# The fleet
# ---------------------------------------------------------------------------


class CodedFleet:
    """A persistent, self-healing worker session serving many coded
    plans (see module docstring).  Construct once, ``attach`` plans,
    submit rounds, grow/shrink with ``add_worker``/``remove_worker``,
    and ``close()`` when done (or use as a context manager) -- the
    transport owns real threads/processes/sockets.
    """

    def __init__(self, n_workers: int, *, transport: str | None = None,
                 faults=None, heartbeat_s: float = 0.25,
                 suspect_after: float | None = None,
                 suspect_grace: float | None = None,
                 max_inflight: int | None = None,
                 microbatch: bool = True, microbatch_cols: int = 64,
                 queue_cap: int | None = None,
                 min_workers: int | None = None,
                 admission: str = "block", transport_opts=None,
                 tracer=None, device=None, backend: str | None = None,
                 grow_encodings: bool = False):
        if admission not in ("block", "shed"):
            raise ValueError(f"admission must be 'block' or 'shed', "
                             f"got {admission!r}")
        # what the workers compute with: on the card (``bcsr_matmul``)
        # unless the caller asks for the CPU; a CPU fleet's workers run
        # the host scipy path unless ``backend="cuda"`` asks for the
        # card path's plain version
        self.device = resolve_device(device)
        self.backend = backend if backend is not None else \
            worker_backend(self.device)
        self.n_workers = n_workers
        self.heartbeat_s = heartbeat_s
        self.suspect_after = suspect_after if suspect_after is not None \
            else max(8 * heartbeat_s, 2.0)
        # two-phase suspicion: a missed-beat worker with outstanding
        # rows is *suspected* first; only after the grace elapses with
        # still no beat is it failed.  Small by default -- the grace
        # exists to let an in-flight late beat cancel the re-ship, not
        # to extend the timeout.
        self.suspect_grace = suspect_grace if suspect_grace is not None \
            else 2 * _TICK_S
        self.max_inflight = max_inflight if max_inflight is not None \
            else default_max_inflight()
        self.microbatch = microbatch
        self.microbatch_cols = microbatch_cols
        self.queue_cap = queue_cap if queue_cap is not None \
            else max(4 * self.max_inflight, 32)
        self.min_workers = min_workers if min_workers is not None \
            else default_min_workers()
        self.admission = admission
        # Autoscaling (repro_torch.scale): by default a plan never grows
        # past its attach-time shard count -- "full strength" is what
        # you attached with.  With ``grow_encodings=True`` a roster that
        # outgrows the plan re-encodes *upward*: ``n`` follows the live
        # worker count while the absolute straggler budget ``s`` is
        # preserved (``k`` grows), so each worker's ``omega/k`` share of
        # the work shrinks -- scale-up buys capacity, not just spares.
        self.grow_encodings = grow_encodings
        self.transport = make_transport(
            transport, n_workers, faults=faults, heartbeat_s=heartbeat_s,
            device=self.device, backend=self.backend,
            **(transport_opts or {}))
        self.transport_name = self.transport.name
        self.bytes_tasks_total = 0
        self.bytes_copied_total = 0
        self.bytes_shards = 0
        self._plans: dict[int, _PlanState] = {}
        self._rounds: dict[tuple[int, int], _Round] = {}
        self._held: dict[int, set[tuple[int, int]]] = \
            {w: set() for w in self.transport.workers()}
        self._dead: set[int] = set()
        self._suspected: dict[int, float] = {}      # worker -> first miss
        self._leaving: set[int] = set()
        self._draining: dict[int, tuple] = {}       # worker -> (deadline, fut)
        self._join_waiters: dict[int, concurrent.futures.Future] = {}
        self._rate: dict[int, float] = {}           # worker -> work/s EWMA
        self._all_dead: RuntimeError | None = None
        self._orphan = {"deaths": 0, "suspected": 0}    # between-rounds
        self._next_plan_id = 1
        self._round_counter = 0
        self._group_counter = itertools.count(1)
        self._rr: list[int] = []            # plan round-robin order
        self._pump_scheduled = False
        self._reencoding = False
        self._closed = False
        self._close_lock = threading.Lock()
        self.event_log: deque[dict] = deque(maxlen=4096)
        # observability (repro.obs): disabled tracing is represented by
        # None, so every hot-path hook costs one identity check.
        # Explicit ``tracer=`` wins; otherwise REPRO_TRACE=1 resolves
        # the process-global tracer.
        self._tracer = tracer if tracer is not None else default_tracer()
        self.transport.start()              # workers up, no shards yet
        self._beats = {w: time.perf_counter()
                       for w in self.transport.workers()}
        self._loop = asyncio.new_event_loop()
        self._loop_thread = threading.Thread(
            target=self._loop.run_forever, name="coded-fleet-loop",
            daemon=True)
        self._loop_thread.start()
        self._pump_stop = threading.Event()
        self._pump_thread = threading.Thread(
            target=self._pump, name="coded-fleet-pump", daemon=True)
        self._pump_thread.start()
        self._loop.call_soon_threadsafe(self._tick)

    # -- lifecycle ---------------------------------------------------------

    def __enter__(self) -> "CodedFleet":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):  # pragma: no cover - gc-time safety net
        try:
            self.close()
        except Exception:
            pass

    def close(self) -> None:
        """Tear the session down: fail unresolved futures, stop the
        loop and pump, shut the transport (sockets closed, heartbeat
        tickers joined, children reaped).  Idempotent and thread-safe
        -- concurrent/double close is a no-op, and closing mid-round
        fails the in-flight futures rather than hanging them."""
        with self._close_lock:
            if self._closed:
                return
            self._closed = True
        if self._loop.is_running():
            done = concurrent.futures.Future()

            def fail_all():
                exc = RuntimeError("fleet closed")
                for ps in self._plans.values():
                    while ps.queue:
                        ps.queue.popleft().future._finish(cancelled=True)
                for rnd in list(self._rounds.values()):
                    for call in rnd.calls:
                        call.future._finish(exc=exc)
                self._rounds.clear()
                for _, fut in self._draining.values():
                    if fut is not None and not fut.done():
                        fut.set_exception(exc)
                self._draining.clear()
                for fut in self._join_waiters.values():
                    if not fut.done():
                        fut.set_exception(exc)
                self._join_waiters.clear()
                done.set_result(None)

            try:
                self._loop.call_soon_threadsafe(fail_all)
                done.result(timeout=5)
            except Exception:  # pragma: no cover - teardown best-effort
                pass
        self._pump_stop.set()
        self._pump_thread.join(timeout=2)
        try:
            self.transport.close()
        except Exception:  # pragma: no cover - teardown best-effort
            pass
        self._loop.call_soon_threadsafe(self._loop.stop)
        self._loop_thread.join(timeout=5)
        self._loop.close()

    def wire_totals(self) -> dict:
        """Cumulative bytes-on-wire across every attached plan."""
        return {"transport": self.transport_name,
                "bytes_shards": self.bytes_shards,
                "bytes_tasks_total": self.bytes_tasks_total,
                "bytes_copied_total": self.bytes_copied_total,
                "transport_bytes_copied": self.transport.bytes_copied}

    def set_microbatch_cols(self, cols: int) -> None:
        """Retarget the fleet-wide coalescing cap; takes effect at the
        next pump, in-flight rounds unaffected."""
        self.microbatch_cols = max(1, int(cols))

    def _metrics_unsafe(self) -> dict:
        live = self._live()
        rounds = list(self._rounds.values())
        per_plan_inflight: dict[int, int] = {}
        for rnd in rounds:
            pid = rnd.ps.plan_id
            per_plan_inflight[pid] = per_plan_inflight.get(pid, 0) + 1
        plans = {}
        for pid, ps in list(self._plans.items()):
            snap = ps.snapshot()
            snap["inflight_rounds"] = per_plan_inflight.get(pid, 0)
            plans[pid] = snap
        return {"transport": self.transport_name,
                "live_workers": live,
                "n_live": len(live),
                "max_inflight": self.max_inflight,
                "inflight_rounds": len(rounds),
                "queued_calls": sum(p["queue_depth"] for p in plans.values()),
                "microbatch": self.microbatch,
                "microbatch_cols": self.microbatch_cols,
                "worker_rates": dict(self._rate),
                "worker_capacities": dict(
                    zip(live, self.worker_capacities(live))),
                "bytes_shards": self.bytes_shards,
                "bytes_tasks_total": self.bytes_tasks_total,
                "bytes_copied_total": self.bytes_copied_total,
                "plans": plans}

    def metrics(self) -> dict:
        """Structured point-in-time snapshot: liveness, in-flight
        rounds, queue depths, per-plan latency EWMAs and counters,
        worker capacities.  The serve router's control input, and the
        observable complement to ``FleetDegraded`` exceptions.  Taken
        on the fleet loop for consistency (falls back to a best-effort
        direct read when the loop is down or we ARE the loop)."""
        if (self._closed or not self._loop.is_running()
                or threading.current_thread() is self._loop_thread):
            return self._metrics_unsafe()
        fut = concurrent.futures.Future()

        def snap():
            try:
                fut.set_result(self._metrics_unsafe())
            except BaseException as e:  # noqa: BLE001
                fut.set_exception(e)

        try:
            self._loop.call_soon_threadsafe(snap)
            return fut.result(timeout=5)
        except Exception:               # pragma: no cover - teardown race
            return self._metrics_unsafe()

    def _log_event(self, kind: str, **fields) -> None:
        """Membership / degradation journal (bounded; chaos + ops
        introspection -- ``fleet.event_log``).  Entries carry BOTH
        clocks: ``t`` (wall, for humans and cross-process joins) and
        ``t_mono`` (``perf_counter``, the clock every latency path and
        tracer span uses) -- so event-log entries are joinable with
        span timelines."""
        self.event_log.append({"t": time.time(),
                               "t_mono": time.perf_counter(),
                               "kind": kind, **fields})

    # -- elastic membership (public surface) -------------------------------

    def live_workers(self) -> list[int]:
        """Current live worker ids (transport-alive, not failed)."""
        return self._live()

    def worker_capacities(self, workers=None, levels: int = 4,
                          rates=None) -> list[int]:
        """Integer device speeds from the throughput EWMAs (submit ->
        result work/s), quantized to ``1..levels`` -- the ``capacities``
        vector ``proposed-hetero`` virtualizes devices with.  Workers
        without a measured rate yet get the median live rate.

        ``rates`` (worker -> work/s) substitutes an external
        measurement for the heartbeat-path EWMAs -- e.g. the per-worker
        compute rates ``repro_torch.obs.attribute`` derives from traced
        worker-side timestamps, which see pure compute time instead of
        the whole submit->result loop (a higher-fidelity capacity
        signal under queueing or wire noise)."""
        ws = list(workers) if workers is not None else self._live()
        src = self._rate if rates is None else rates
        rates = [src.get(w, 0.0) for w in ws]
        known = sorted(r for r in rates if r > 0)
        if not known:
            return [1] * len(ws)
        fallback = known[len(known) // 2]
        rates = [r if r > 0 else fallback for r in rates]
        top = max(rates)
        return [max(1, round(levels * r / top)) for r in rates]

    def observed_rates(self) -> dict | None:
        """Per-worker compute rates (work/s of *pure compute*) derived
        from the active tracer's round records via
        ``repro_torch.obs.attribute``, or None when untraced / nothing
        recorded yet.  This is the default ``rates=`` feed for the
        degradation re-encode path: when tracing is on, a
        ``proposed-hetero`` re-cut follows measured worker-side compute
        time instead of the coarser submit->result EWMAs."""
        tr = self._tracer
        if tr is None:
            return None
        try:
            rates = attribute(tr.events()).compute_rates()
        except Exception:                   # malformed/partial records
            return None
        return rates or None

    def add_worker(self, worker: int | None = None, *,
                   timeout: float = 60.0) -> int:
        """Admit one worker into the running session: the transport
        spawns/accepts the channel, the fleet catches it up with every
        attached plan's shards and confirms with a welcome frame.
        Blocks until the catch-up finished; returns the worker id."""
        if self._closed:
            raise RuntimeError("fleet has been closed")
        w = self.transport.add_worker(worker)
        waiter = concurrent.futures.Future()

        def register():
            if self._closed:
                # close() already failed the waiters it knew of: this one
                # would wait out its timeout on a fleet that is gone
                waiter.set_exception(RuntimeError("fleet closed"))
            elif w in self._beats and w not in self._dead:
                if not waiter.done():
                    waiter.set_result(w)    # join event already processed
            else:
                self._join_waiters[w] = waiter

        self._loop.call_soon_threadsafe(register)
        waiter.result(timeout)
        return w

    def remove_worker(self, worker: int, *, drain: bool = True,
                      timeout: float = 10.0) -> None:
        """Gracefully remove one worker: its shards and future rows
        re-home immediately; with ``drain=True`` its in-flight rows get
        ``timeout`` seconds to finish before being requeued; then the
        channel closes without a death notice."""
        if self._closed:
            raise RuntimeError("fleet has been closed")
        fut = concurrent.futures.Future()
        self._loop.call_soon_threadsafe(
            self._begin_leave, int(worker), drain, timeout, fut)
        fut.result(timeout + 15.0)

    # -- attach / detach ---------------------------------------------------

    def attach(self, plan, *, deadline: float | None = None) -> "PlanHandle":
        """Ship ``plan``'s shards to the fleet's workers (once) and
        return a ``PlanHandle`` for submitting rounds against them.
        The cut targets the *live* roster (an elastic fleet may have
        grown or shrunk); plans smaller than the fleet use its first
        ``plan.n`` live workers, and attached plans co-exist on the
        same worker set."""
        if self._closed:
            raise RuntimeError("fleet has been closed")
        want, _ = plan_workers(plan)
        # an aggregation-only plan ships no shards: any workers serve it
        if plan.executor is not None and self.backend != want:
            # a card plan's workers never run on the host, and a host
            # plan keeps its bitwise parity only on host workers
            raise ValueError(
                f"a {plan.backend} plan needs {want} workers; this fleet's "
                f"workers compute with {self.backend} on {self.device}")
        pid = self._next_plan_id
        self._next_plan_id += 1
        packed = plan_packed(plan)
        hosts = self._live() or self.transport.workers()
        n_shards = max(1, min(len(hosts), plan.n))
        hosts = hosts[:n_shards]
        shards = shard_plan(plan, n_shards, packed=packed, plan_id=pid)
        ps = _PlanState(plan, pid, n_shards, packed, shards, hosts)
        ps.default_deadline = deadline
        ps.sem = threading.Semaphore(self.queue_cap)
        fut = concurrent.futures.Future()
        self._loop.call_soon_threadsafe(self._do_attach, ps, fut)
        fut.result()
        return PlanHandle(self, ps)

    def _do_attach(self, ps: _PlanState, fut) -> None:
        try:
            self._plans[ps.plan_id] = ps
            self._rr.append(ps.plan_id)
            sent = 0
            for idx, blob in enumerate(ps.shard_blobs):
                want = ps.shard_hosts[idx]
                alive = want not in self._dead and self.transport.alive(want)
                holder = want if alive else self._heir()
                if holder != want:      # re-home rows cut for a dead host
                    for row in ps.shard_rows[idx]:
                        ps.owner[row] = holder
                sent += self.transport.ship_shard(holder, blob)
                self._held.setdefault(holder, set()).add((ps.plan_id, idx))
            ps.bytes_shards += sent
            self.bytes_shards += sent
            fut.set_result(sent)
        except BaseException as e:  # noqa: BLE001 - surface to caller
            self._plans.pop(ps.plan_id, None)
            if ps.plan_id in self._rr:
                self._rr.remove(ps.plan_id)
            fut.set_exception(e)

    def _do_detach(self, ps: _PlanState, fut) -> None:
        ps.detached = True
        self._plans.pop(ps.plan_id, None)
        if ps.plan_id in self._rr:
            self._rr.remove(ps.plan_id)
        while ps.queue:
            ps.queue.popleft().future._finish(cancelled=True)
        for key, rnd in list(self._rounds.items()):
            if rnd.ps is ps:
                for call in rnd.calls:
                    call.future._finish(cancelled=True)
                del self._rounds[key]
        for held in self._held.values():
            held.difference_update(
                {(pid, idx) for pid, idx in held if pid == ps.plan_id})
        fut.set_result(None)
        self._pump_queues()

    # -- submission (caller threads) ---------------------------------------

    def _submit_call(self, ps: _PlanState, call: _Call, *,
                     block: bool | None = None) -> CodedFuture:
        if self._closed or ps.detached:
            raise RuntimeError("fleet has been closed"
                               if self._closed else "plan handle detached")
        if self._all_dead is not None:
            raise self._all_dead
        # bounded-queue backpressure: block (fleet default) or shed;
        # ``block`` overrides per call (the serve router submits
        # non-blocking so its scheduler thread can never stall here)
        if not ps.sem.acquire(blocking=self.admission != "shed"
                              if block is None else block):
            ps.bump("shed")
            raise FleetDegraded(
                f"plan {ps.plan_id} admission queue is full "
                f"({self.queue_cap} unresolved calls); back off and "
                f"resubmit, or raise queue_cap",
                action="shed", plan_id=ps.plan_id)
        ps.bump("submitted")
        call.future._t_submit = time.perf_counter()
        tr = self._tracer
        if tr is not None:
            tr.instant("fleet.enqueue", cat="fleet", track="fleet",
                       plan=ps.plan_id, op=call.op,
                       width=max(call.width, 1))
        try:
            self._loop.call_soon_threadsafe(self._enqueue, ps, call)
        except RuntimeError:                # loop torn down under us
            ps.sem.release()
            raise RuntimeError("fleet has been closed") from None
        return call.future

    def _submit_group(self, ps: _PlanState, calls: list[_Call], *,
                      block: bool | None = None) -> list[CodedFuture]:
        """Submit an explicitly-packed coalescing group: all calls land
        on the plan queue in ONE loop callback and pump immediately, so
        they form exactly one round (cap-exempt) when a slot is free --
        the serve router's batch-dispatch primitive.

        Admission is all-or-nothing: the group holds ``len(calls)``
        queue slots or none.  ``block=False`` sheds instead of waiting
        (``FleetDegraded``), releasing every slot acquired so far --
        callers on a scheduler thread must use it, because a blocking
        group wider than the free queue capacity would hold its partial
        slots while waiting for slots only its own unsubmitted calls
        could ever free."""
        if self._closed or ps.detached:
            raise RuntimeError("fleet has been closed"
                               if self._closed else "plan handle detached")
        if self._all_dead is not None:
            raise self._all_dead
        if len(calls) > self.queue_cap:
            # wider than the whole queue: could never admit, even empty
            # (a blocking acquire would self-deadlock, a shed would
            # make every retry futile) -- reject loudly instead
            raise ValueError(
                f"group of {len(calls)} calls exceeds queue_cap="
                f"{self.queue_cap}; split the group or raise queue_cap")
        acquired = 0
        try:
            for _ in calls:
                if not ps.sem.acquire(blocking=self.admission != "shed"
                                      if block is None else block):
                    ps.bump("shed")
                    raise FleetDegraded(
                        f"plan {ps.plan_id} admission queue is full "
                        f"({self.queue_cap} unresolved calls); back off "
                        f"and resubmit, or raise queue_cap",
                        action="shed", plan_id=ps.plan_id)
                acquired += 1
            now = time.perf_counter()
            for c in calls:
                c.future._t_submit = now
            ps.bump("submitted", len(calls))
            tr = self._tracer
            if tr is not None:
                tr.instant("fleet.enqueue-group", cat="fleet",
                           track="fleet", plan=ps.plan_id,
                           calls=len(calls),
                           width=sum(max(c.width, 1) for c in calls))
            self._loop.call_soon_threadsafe(self._enqueue_group, ps, calls)
        except BaseException:
            for _ in range(acquired):
                ps.sem.release()
            raise
        return [c.future for c in calls]

    def _enqueue_group(self, ps: _PlanState, calls: list[_Call]) -> None:
        if ps.detached:
            for c in calls:
                c.future._finish(cancelled=True)
            return
        if self._all_dead is not None:
            for c in calls:
                c.future._finish(exc=self._all_dead)
            return
        ps.queue.extend(calls)
        # the group is complete by construction -- nothing submitted
        # later may join it -- so pump now instead of deferring
        self._pump_queues()

    def _cancel_call(self, ps: _PlanState, future: CodedFuture) -> bool:
        if future.done():
            return future.cancelled()
        if self._closed:
            return False
        answer = concurrent.futures.Future()

        def check():
            for call in ps.queue:
                if call.future is future:
                    ps.queue.remove(call)
                    call.future._finish(cancelled=True)
                    answer.set_result(True)
                    return
            answer.set_result(False)

        try:
            self._loop.call_soon_threadsafe(check)
            return answer.result(timeout=5)
        except Exception:
            return False

    # -- loop-side scheduling ---------------------------------------------

    def _enqueue(self, ps: _PlanState, call: _Call) -> None:
        if ps.detached:
            call.future._finish(cancelled=True)
            return
        if self._all_dead is not None:   # raced the wipeout: fail, not hang
            call.future._finish(exc=self._all_dead)
            return
        ps.queue.append(call)
        # An idle fleet (no in-flight rounds, nothing else queued on
        # any plan) has nothing this call could coalesce with, so
        # launch NOW: deferring would add one loop iteration -- and,
        # under load on the loop, many queued callbacks -- to every
        # isolated low-load call (the inflight=1 latency pathology).
        # With microbatching off the deferral buys nothing either.
        if not self.microbatch or (
                not self._rounds
                and len(ps.queue) == 1
                and not any(p.queue for p in self._plans.values()
                            if p is not ps)):
            self._pump_queues()
            return
        # Otherwise defer the launch by one loop iteration: a burst of
        # submissions (all sitting in this iteration's ready queue)
        # lands in the plan queues BEFORE the pump runs, so queued
        # matvecs coalesce instead of each grabbing its own in-flight
        # slot.  For trickling submissions the deferral is ~a few
        # microseconds.
        if not self._pump_scheduled:
            self._pump_scheduled = True
            self._loop.call_soon(self._deferred_pump)

    def _deferred_pump(self) -> None:
        self._pump_scheduled = False
        self._pump_queues()

    def _coalescible(self, a: _Call, b: _Call) -> bool:
        return (a.op == "matvec" and b.op == "matvec"
                and not a.wait_all and not b.wait_all
                and a.deadline == b.deadline
                and a.group == b.group)

    def _pump_queues(self) -> None:
        """Launch queued calls while in-flight slots are free; queued
        matvecs against the same plan coalesce into one wider round.
        Plans with a pending re-encode hold their queue until the swap
        lands (applied here once their in-flight rounds drain)."""
        if self._closed or self._all_dead is not None:
            return
        self._drain_reencodes()
        while len(self._rounds) < self.max_inflight and not self._closed:
            ps = next((self._plans[pid] for pid in self._rr
                       if self._plans[pid].queue
                       and not self._plans[pid].pending_reencode), None)
            if ps is None:
                return
            # fairness: rotate the plan we just served to the back
            self._rr.remove(ps.plan_id)
            self._rr.append(ps.plan_id)
            batch = [ps.queue.popleft()]
            if self.microbatch or batch[0].group is not None:
                cap = ps.microbatch_cols if ps.microbatch_cols is not None \
                    else self.microbatch_cols
                width = batch[0].width
                # an explicit group (submit_matvec_many) was packed by
                # its caller: it coalesces whole, exempt from the cap
                while (ps.queue
                       and (width < cap or batch[0].group is not None)
                       and self._coalescible(batch[0], ps.queue[0])):
                    nxt = ps.queue.popleft()
                    batch.append(nxt)
                    width += nxt.width
            try:
                self._launch(ps, batch)
            except BaseException as e:  # noqa: BLE001 - fail the batch
                for call in batch:
                    call.future._finish(exc=e)

    def _launch(self, ps: _PlanState, calls: list[_Call]) -> None:
        # launch-time rebuild: the plan may have been re-encoded (new
        # plan id, new geometry) while these calls sat queued
        fresh: list[_Call] = []
        for c in calls:
            if c.built_for == ps.plan_id:
                fresh.append(c)
                continue
            if c.rebuild is None:
                c.future._finish(exc=FleetDegraded(
                    f"plan was re-encoded (now id {ps.plan_id}) while this "
                    f"call was queued and its inputs are tied to the old "
                    f"geometry; resubmit against the current plan",
                    action="re-encode", plan_id=ps.plan_id))
                continue
            try:
                c.rebuild(c)
                fresh.append(c)
            except BaseException as e:  # noqa: BLE001 - fail just this call
                c.future._finish(exc=FleetDegraded(
                    f"rebuilding call after re-encode failed: {e!r}",
                    action="re-encode", plan_id=ps.plan_id))
        if not fresh:
            return
        calls = fresh
        self._round_counter += 1
        round_id = self._round_counter
        op = calls[0].op
        target = calls[0].target
        report = ClusterReport(
            op=op, round=round_id, plan_id=ps.plan_id, calls=len(calls),
            n_tasks=ps.plan.n_tasks, n_dispatched=int(target.sum()),
            deaths=self._orphan["deaths"],
            suspected=self._orphan["suspected"])
        self._orphan = {"deaths": 0, "suspected": 0}
        if op == "matvec":
            if len(calls) == 1:
                b_comb = calls[0].b_op
            else:
                width_all = sum(c.b_op.shape[1] for c in calls)
                slab = self.transport.alloc_operand(
                    (calls[0].b_op.shape[0], width_all), np.float32)
                if slab is None:
                    b_comb = np.concatenate([c.b_op for c in calls], axis=1)
                else:
                    np.concatenate([c.b_op for c in calls], axis=1, out=slab)
                    b_comb = slab
            width = b_comb.shape[1]
            dense = self.transport.prefers_dense_payload

            def make_task(row: int) -> Task:
                # a shared-memory transport ships the one dense operand
                # slab by reference, so support restriction would only
                # add per-row copies it exists to avoid
                payload = {"b": b_comb} if dense \
                    else ps.restricted_payload(row, b_comb)
                return Task(round=round_id, op="matvec", task_row=row,
                            plan=ps.plan_id, payload=payload,
                            meta={"b": width})

            dense_bytes = int(b_comb.nbytes)
            self.transport.prepare_results(
                round_id, [int(r) for r in np.flatnonzero(target)],
                (ps.packed.c_pad, width), np.float32)
        else:
            call = calls[0]
            make_task = lambda row: call.make_task(row, round_id)  # noqa: E731
            dense_bytes = call.dense_bytes
        rnd = _Round(ps, round_id, calls, make_task, report,
                     calls[0].deadline)
        rnd.dense_bytes = dense_bytes
        tr = self._tracer
        if tr is not None:
            # one trace id per round: every Task/TaskResult of this
            # round carries it across the wire (v5), and the decode-time
            # span emission groups by it
            rnd.trace = tr.new_trace_id()
            tr.instant("fleet.launch", cat="fleet", track="fleet",
                       trace=rnd.trace, plan=ps.plan_id, round=round_id,
                       op=op, calls=len(calls),
                       rows=int(target.sum()))
        self._rounds[(ps.plan_id, round_id)] = rnd
        try:
            for row in np.flatnonzero(target):
                self._submit_row(rnd, int(row))
        except BaseException:
            # a failed launch must not leak its in-flight slot -- the
            # caller fails the batch's futures, we drop the round
            self._rounds.pop((ps.plan_id, round_id), None)
            try:
                self.transport.finish_round(round_id)
            except Exception:  # pragma: no cover - close() sweeps leftovers
                pass
            raise

    def _submit_row(self, rnd: _Round, row: int) -> None:
        owner = rnd.ps.owner[row]
        task = rnd.make_task(row)
        if rnd.trace:
            task.trace = rnd.trace      # wire v5: the id rides the task
        copied_before = self.transport.bytes_copied
        sent = self.transport.submit(owner, task)
        copied = self.transport.bytes_copied - copied_before
        rnd.report.bytes_tasks += sent
        rnd.report.bytes_copied += copied
        rnd.ps.bytes_tasks_total += sent
        rnd.ps.bytes_copied_total += copied
        self.bytes_tasks_total += sent
        self.bytes_copied_total += copied
        rnd.inflight[row] = owner
        rnd.sent_at[row] = time.perf_counter()

    # -- the uniform event stream -----------------------------------------

    def _pump(self) -> None:
        """Pump thread: transport events -> the fleet loop."""
        while not self._pump_stop.is_set():
            try:
                ev = self.transport.poll(_POLL_S)
            except Exception:               # transport torn down
                return
            if ev is None:
                continue
            try:
                self._loop.call_soon_threadsafe(self._on_event, ev)
            except RuntimeError:            # loop closed
                return

    def _on_event(self, ev) -> None:
        if self._closed:
            return
        if isinstance(ev, Heartbeat):
            w = ev.worker
            if w in self._dead:
                if self.transport.alive(w):
                    # a beat from a worker *we* failed but the transport
                    # never saw die: suspicion misfired (healed
                    # partition, late beat after re-ship) -- re-admit
                    self._log_event("readmit", worker=w)
                    self._admit_worker(w)
                return
            self._beats[w] = time.perf_counter()
            # a late beat inside the grace window un-suspects the
            # worker before any re-ship happens (two-phase suspicion)
            self._suspected.pop(w, None)
            return
        if isinstance(ev, WorkerJoin):
            self._admit_worker(ev.worker)
            return
        if isinstance(ev, WorkerLeave):
            self._begin_leave(ev.worker, True, 10.0, None)
            return
        if ev.kind == "death":
            self._fail_worker(ev.worker, "death")
            return
        rnd = self._rounds.get((ev.plan, ev.round))
        if rnd is None:
            tr = self._tracer
            if tr is not None and getattr(ev, "trace", 0):
                # a cancelled task completed anyway: its compute bought
                # nothing -- the wasted-work side of straggler
                # attribution
                # serve_s spans serve entry -> return on the worker
                # clock (fault delays included, unlike compute_s --
                # the pure BSR product), so attribution can rate a
                # straggler that ONLY ever answers late
                tr.instant("fleet.late-result", cat="waste", track="fleet",
                           trace=ev.trace, worker=ev.worker,
                           round=ev.round, plan=ev.plan,
                           work=float(ev.work),
                           compute_s=float(ev.compute_s),
                           serve_s=max(0.0, ev.t_finish - ev.t_start)
                           if ev.t_finish else 0.0)
            return                          # stale round, already decoded
        if not ev.ok:
            exc = RuntimeError(f"worker {ev.worker} failed task "
                               f"{ev.task_row}: {ev.error}")
            self._abort_round(rnd, exc)
            return
        if ev.task_row in rnd.results or not rnd.target[ev.task_row]:
            return
        rnd.results[ev.task_row] = ev.arrays
        rnd.order.append(ev.task_row)
        if rnd.trace:
            # worker stamps are on the WORKER's clock; arrival on ours.
            # The decode-time span emission shifts them by the hello
            # clock offset, so store raw here.
            t_arr = time.perf_counter()
            rnd.task_meta[ev.task_row] = (
                ev.worker, ev.t_recv, ev.t_start, ev.t_finish, t_arr)
            if ev.t_finish:
                # every traced result tightens the clock-offset upper
                # bound: arrival - t_finish = offset + wire latency,
                # so the min over results beats the one-shot hello
                # estimate (whose latency includes the spawn storm)
                off = t_arr - ev.t_finish
                offs = self.transport.clock_offsets
                cur = offs.get(ev.worker)   # None: shared clock, exact
                if cur is not None and off < cur:
                    offs[ev.worker] = off
        rep = rnd.report
        rep.bytes_results += sum(int(a.nbytes) for a in ev.arrays.values())
        rep.bytes_copied += int(ev.copied)
        rnd.ps.bytes_copied_total += int(ev.copied)
        self.bytes_copied_total += int(ev.copied)
        rep.completed_per_worker[ev.worker] = \
            rep.completed_per_worker.get(ev.worker, 0) + 1
        rep.worker_work[ev.worker] = \
            rep.worker_work.get(ev.worker, 0.0) + ev.work
        sent_at = rnd.sent_at.get(ev.task_row)
        if sent_at is not None:
            # throughput EWMA: work units per second of submit->result
            # latency.  Feeds hetero capacities on re-encode, so a
            # slow-but-alive device gets proportionally fewer tiles.
            rate = max(float(ev.work), 1e-3) / \
                max(time.perf_counter() - sent_at, 1e-6)
            prev = self._rate.get(ev.worker)
            self._rate[ev.worker] = rate if prev is None \
                else 0.7 * prev + 0.3 * rate
        dec = self._decodable(rnd)
        if dec is not None:
            self._finish_round(rnd, *dec)
        if self._draining:
            self._check_draining()

    def _decodable(self, rnd: _Round):
        ps, k = rnd.ps, rnd.ps.plan.k
        if len(rnd.results) < k:
            return None
        if rnd.wait_all:
            if len(rnd.results) < int(rnd.target.sum()):
                return None
            mask = rnd.target
        else:
            mask = np.zeros(ps.plan.n_tasks, bool)
            mask[list(rnd.results)] = True
        cache = ps.plan._decode_cache()
        G = np.asarray(cache._G)
        try:
            dplan = cache.plan(mask)
            return mask, dplan.rows, dplan.hinv, dplan.hinv_dev
        except (ValueError, np.linalg.LinAlgError):
            rows = _independent_rows(G, rnd.order, k)
            if rows is None:
                return None
            hinv = np.linalg.inv(G[rows]).astype(np.float32)
            return mask, rows, hinv, None

    # -- liveness + deadlines (watchdog) ----------------------------------

    def _tick(self) -> None:
        if self._closed:
            return
        try:
            now = time.perf_counter()
            for w, seen in list(self._beats.items()):
                if now - seen <= self.suspect_after:
                    self._suspected.pop(w, None)
                    continue
                if not any(rnd.missing_on(w)
                           for rnd in self._rounds.values()):
                    # idle silent worker: nothing outstanding, nothing
                    # to re-home -- fresh grace, NOT failed
                    self._beats[w] = now
                    self._suspected.pop(w, None)
                    continue
                first = self._suspected.setdefault(w, now)
                if now - first >= self.suspect_grace:
                    self._suspected.pop(w, None)
                    self._fail_worker(w, "suspected")
            if self._draining:
                self._check_draining()
            for rnd in list(self._rounds.values()):
                if rnd.deadline_at is not None and now > rnd.deadline_at:
                    self._expire_round(rnd)
            self._drain_reencodes()
        finally:
            # the watchdog must survive any single tick's failure --
            # liveness and deadlines die silently otherwise
            self._loop.call_later(_TICK_S, self._tick)

    def _expire_round(self, rnd: _Round) -> None:
        rnd.report.deadline_hit = True
        if not rnd.wait_all:
            # accept whatever pattern we have, if it decodes
            ps, k = rnd.ps, rnd.ps.plan.k
            G = np.asarray(ps.plan._decode_cache()._G)
            rows = _independent_rows(G, rnd.order, k)
            if rows is not None:
                mask = np.zeros(ps.plan.n_tasks, bool)
                mask[list(rnd.results)] = True
                self._finish_round(
                    rnd, mask, rows,
                    np.linalg.inv(G[rows]).astype(np.float32), None)
                return
        deadline = rnd.deadline_at - rnd.t_start
        self._abort_round(rnd, TimeoutError(
            f"deadline: {len(rnd.results)}/{rnd.ps.plan.k} needed task "
            f"rows after {deadline:.3g}s"))

    def _abort_round(self, rnd: _Round, exc: BaseException) -> None:
        self._rounds.pop((rnd.ps.plan_id, rnd.round_id), None)
        try:                                # free shm operand/result slabs
            self.transport.finish_round(rnd.round_id)
        except Exception:   # pragma: no cover - close() sweeps leftovers
            pass
        tr = self._tracer
        if tr is not None and rnd.trace:
            tr.instant("fleet.round-abort", cat="fleet", track="fleet",
                       trace=rnd.trace, plan=rnd.ps.plan_id,
                       round=rnd.round_id, error=type(exc).__name__,
                       deadline_hit=rnd.report.deadline_hit,
                       results=len(rnd.results),
                       inflight=len(rnd.inflight))
        for w in self._live():
            self.transport.cancel(w, rnd.round_id)
        for call in rnd.calls:
            call.future._finish(exc=exc)
        self._pump_queues()

    # -- fail-stop / suspicion / requeue ----------------------------------

    def _live(self) -> list[int]:
        return [w for w in self.transport.workers()
                if w not in self._dead and self.transport.alive(w)]

    def _heir(self, exclude=frozenset()) -> int:
        live = [w for w in self._live()
                if w not in exclude and w not in self._leaving]
        if not live:
            raise RuntimeError("all cluster workers are dead")
        owned = {w: 0 for w in live}
        for ps in self._plans.values():
            for o in ps.owner.values():
                if o in owned:
                    owned[o] += 1
        return min(live, key=lambda w: (owned[w], w))

    def _fail_worker(self, worker: int, cause: str) -> None:
        if worker in self._dead:
            return                          # notices are idempotent
        self._dead.add(worker)
        self._beats.pop(worker, None)
        self._suspected.pop(worker, None)
        self._leaving.discard(worker)
        drain = self._draining.pop(worker, None)
        self._log_event(cause, worker=worker)
        live_rounds = sorted(self._rounds.values(),
                             key=lambda r: r.round_id)
        # attribute the failure to the oldest live round (the shim's
        # one-at-a-time reports keep their meaning); with no
        # round in flight it is folded into the next launched one
        if live_rounds:
            rep = live_rounds[0].report
            if cause == "suspected":
                rep.suspected += 1
            else:
                rep.deaths += 1
        else:
            self._orphan["suspected" if cause == "suspected"
                         else "deaths"] += 1
        try:
            heir = self._heir()
        except RuntimeError:
            # no survivors: fail everything in flight AND queued, and
            # fail-fast future submissions -- a between-rounds wipeout
            # must not turn into silent hangs
            e = FleetDegraded(
                "all cluster workers are dead; add workers "
                "(fleet.add_worker) to recover", action="fail")
            self._all_dead = e
            self._log_event("degraded-wipeout")
            for rnd in live_rounds:
                self._abort_round(rnd, e)
            for ps in self._plans.values():
                while ps.queue:
                    ps.queue.popleft().future._finish(exc=e)
            if drain is not None and drain[1] is not None \
                    and not drain[1].done():
                drain[1].set_exception(e)
            return
        # re-ship every shard the dead host held -- its own AND any it
        # previously inherited (a second death must not strand those)
        for pid, idx in self._held.pop(worker, set()):
            ps = self._plans.get(pid)
            if ps is None or pid != ps.plan_id:
                continue
            sent = self.transport.ship_shard(heir, ps.shard_blobs[idx])
            ps.bytes_shards += sent
            self.bytes_shards += sent
            self._held.setdefault(heir, set()).add((pid, idx))
        for ps in self._plans.values():
            for row, o in list(ps.owner.items()):
                if o == worker:
                    ps.owner[row] = heir
        for rnd in live_rounds:
            for row in rnd.missing_on(worker):
                self._submit_row(rnd, row)
                rnd.report.requeues += 1
        if drain is not None and drain[1] is not None \
                and not drain[1].done():
            drain[1].set_result(None)       # leaver died mid-drain: done
        self._maybe_degrade()

    # -- elastic membership (loop side) ------------------------------------

    def _admit_worker(self, worker: int) -> None:
        """A ``WorkerJoin`` landed (or a suspicion-failed worker beat
        again): catch the worker up with every attached plan's shards,
        rebalance row ownership toward it, confirm the join."""
        if self._closed:
            return
        self._dead.discard(worker)
        self._suspected.pop(worker, None)
        self._leaving.discard(worker)
        self._draining.pop(worker, None)
        self._held.setdefault(worker, set())
        self._beats[worker] = time.perf_counter()
        if self._all_dead is not None:
            # a live worker again: lift the fail-fast (already-failed
            # futures stay failed; new submissions are accepted)
            self._all_dead = None
            self._log_event("recovered", worker=worker)
        for ps in self._plans.values():
            self._rebalance_to(ps, worker)
        try:
            self.transport.confirm_join(worker, plans=len(self._plans))
        except Exception:                   # informational only
            pass
        self._log_event("join", worker=worker)
        waiter = self._join_waiters.pop(worker, None)
        if waiter is not None and not waiter.done():
            waiter.set_result(worker)
        self._maybe_degrade()               # restore resilience if possible
        self._pump_queues()

    def _rebalance_to(self, ps: _PlanState, joiner: int) -> bool:
        """Move shards of one plan toward ``joiner``: orphaned shards
        (held only by dead workers) first, then one at a time off the
        most-loaded live holder while the joiner holds none or the
        imbalance is >= 2.  Rows move with their shard, so the joiner
        ends up serving every attached plan."""
        moved = False
        live = set(self._live())

        def count(w: int) -> int:
            return sum(1 for pid, _ in self._held.get(w, ())
                       if pid == ps.plan_id)

        # orphans: shards stranded on dead holders (post-wipeout joins)
        for w, held in list(self._held.items()):
            if w in live or w == joiner:
                continue
            for pid, idx in list(held):
                if pid != ps.plan_id:
                    continue
                held.discard((pid, idx))
                moved |= self._move_shard(ps, idx, joiner)
        while True:
            holders = [w for w in live
                       if w != joiner and w not in self._leaving
                       and count(w) > 0]
            if not holders:
                break
            big = max(holders, key=count)
            if count(joiner) == 0 or count(big) - count(joiner) >= 2:
                idx = next(i for pid, i in self._held[big]
                           if pid == ps.plan_id)
                self._held[big].discard((ps.plan_id, idx))
                moved |= self._move_shard(ps, idx, joiner)
            else:
                break
        return moved

    def _move_shard(self, ps: _PlanState, idx: int, to: int) -> bool:
        """Ship shard ``idx`` to ``to`` and re-home its rows there.
        In-flight rows stay where they were submitted (the old holder
        keeps its loaded task table until the plan is dropped), so no
        round is disturbed."""
        sent = self.transport.ship_shard(to, ps.shard_blobs[idx])
        ps.bytes_shards += sent
        self.bytes_shards += sent
        self._held.setdefault(to, set()).add((ps.plan_id, idx))
        for row in ps.shard_rows[idx]:
            ps.owner[row] = to
        return True

    def _begin_leave(self, worker: int, drain: bool, timeout: float,
                     fut) -> None:
        """Loop-side start of a graceful leave: re-home shards and
        future rows now, let in-flight rows drain, then tear the
        channel down without a death notice."""
        if worker in self._dead or not self.transport.alive(worker):
            try:                            # already gone: drop from roster
                self.transport.remove_worker(worker)
            except Exception:
                pass
            if fut is not None and not fut.done():
                fut.set_result(None)
            return
        if worker in self._leaving:
            if fut is not None and not fut.done():
                fut.set_result(None)        # concurrent leave: first wins
            return
        self._leaving.add(worker)
        self._log_event("leave-begin", worker=worker, drain=drain)
        try:
            for pid, idx in list(self._held.get(worker, ())):
                ps = self._plans.get(pid)
                if ps is None or pid != ps.plan_id:
                    self._held[worker].discard((pid, idx))
                    continue
                heir = self._heir(exclude={worker})
                self._held[worker].discard((pid, idx))
                self._move_shard(ps, idx, heir)
        except RuntimeError:
            # the leaver is the last live worker: refuse, never strand
            self._leaving.discard(worker)
            if fut is not None and not fut.done():
                fut.set_exception(FleetDegraded(
                    f"cannot remove worker {worker}: no live worker to "
                    f"inherit its shards; add a worker first",
                    action="fail"))
            return
        deadline_at = time.perf_counter() + (timeout if drain else 0.0)
        self._draining[worker] = (deadline_at, fut)
        self._check_draining()

    def _check_draining(self) -> None:
        """Finish leaves whose in-flight rows drained (or timed out --
        then requeue the leftovers on the new owners)."""
        now = time.perf_counter()
        for w, (deadline_at, fut) in list(self._draining.items()):
            leftovers = [(rnd, rows) for rnd in self._rounds.values()
                         if (rows := rnd.missing_on(w))]
            if leftovers and now < deadline_at:
                continue
            for rnd, rows in leftovers:
                for row in rows:
                    self._submit_row(rnd, row)  # owner already re-homed
                    rnd.report.requeues += 1
            self._finish_leave(w, fut)

    def _finish_leave(self, worker: int, fut) -> None:
        self._draining.pop(worker, None)
        self._dead.add(worker)
        self._beats.pop(worker, None)
        self._suspected.pop(worker, None)
        self._held.pop(worker, None)
        try:
            self.transport.remove_worker(worker)
        except Exception:                   # transport without live leave
            pass
        self._leaving.discard(worker)
        self._log_event("leave", worker=worker)
        if fut is not None and not fut.done():
            fut.set_result(None)
        self._maybe_degrade()
        self._pump_queues()

    # -- graceful degradation ----------------------------------------------

    def _maybe_degrade(self) -> None:
        """Roster changed: enforce the availability floor, then retarget
        every plan's resilience to the live set (re-encode deferred
        until the plan's in-flight rounds drain)."""
        live = self._live()
        m = len(live)
        if m == 0:
            return                          # wipeout path already handled
        if m < self.min_workers:
            exc = FleetDegraded(
                f"{m} live workers, below the availability floor "
                f"min_workers={self.min_workers}; add workers "
                f"(fleet.add_worker) or lower {ENV_MIN_WORKERS}",
                action="fail")
            self._all_dead = exc            # fail-fast future submissions
            self._log_event("degraded-floor", live=m,
                            floor=self.min_workers)
            for rnd in sorted(self._rounds.values(),
                              key=lambda r: r.round_id):
                self._abort_round(rnd, exc)
            for ps in self._plans.values():
                while ps.queue:
                    ps.queue.popleft().future._finish(exc=exc)
            return
        for ps in self._plans.values():
            plan = ps.plan
            if getattr(plan, "executor", None) is None \
                    or getattr(plan, "_A", None) is None:
                continue                    # aggregation-only: nothing to cut
            cap = m if self.grow_encodings else ps.max_shards
            if ps.n_shards != min(m, cap):
                ps.pending_reencode = True
        self._drain_reencodes()

    def _drain_reencodes(self) -> None:
        if self._reencoding:
            return
        self._reencoding = True
        try:
            for ps in list(self._plans.values()):
                if ps.pending_reencode and not any(
                        r.ps is ps for r in self._rounds.values()):
                    try:
                        self._reencode(ps)
                    except Exception as e:  # keep-old is always safe
                        ps.pending_reencode = False
                        self._log_event("reencode-failed",
                                        plan=ps.plan_id, error=repr(e))
        finally:
            self._reencoding = False

    def _reencode_scheme(self, ps: _PlanState, m: int, live: list[int]):
        """Pick the replacement scheme for ``m`` live hosts.  Returns
        ``(plan, cut_capacities)`` -- the compiled plan for the new
        ``(n', k')`` and the capacities the shard cut should follow
        (None for a uniform cut).  Shrinking, resilience goes before
        availability: ``k`` is preserved whenever ``n' >= k``.  Growing
        (``grow_encodings``), the absolute straggler budget ``s`` is
        what's preserved and ``k`` expands with the roster, shrinking
        every worker's ``omega/k`` share -- the capacity half of the
        elastic story."""
        from ..api.plan import compile_plan  # noqa: PLC0415 - avoid cycle
        from ..api.schemes import make_scheme  # noqa: PLC0415

        first_pid = min(ps.versions)
        plan0 = ps.versions[first_pid]
        if m == ps.max_shards:
            # full strength restored: reuse the original compile
            return plan0, None
        sch0 = plan0.scheme
        n_target = m * ps.ratio
        if n_target > plan0.n:
            k_goal = max(plan0.k, n_target - (plan0.n - plan0.k))
        else:
            k_goal = min(plan0.k, n_target)
        # tracer-derived per-worker compute rates (repro_torch.obs),
        # when a tracer recorded any rounds, beat the heartbeat-path
        # EWMAs: the hetero cut then reflects measured device speed
        caps = self.worker_capacities(live, rates=self.observed_rates())
        virt = None
        if (plan0.kind == "mv" and len(set(caps)) > 1
                and sch0.name in ("proposed", "proposed-hetero")):
            # measurably uneven devices: capacity-virtualize the cut
            # (Sec. IV-B) so slow-but-alive hosts get fewer tiles
            total = sum(caps)
            virt = [max(1, round(c * n_target / total)) for c in caps]
            n_new = sum(virt)
            k_new = min(k_goal, n_new)
            try:
                sch = make_scheme("proposed-hetero", capacities=virt,
                                  k_A=k_new)
            except (ValueError, KeyError):
                virt = None
        if virt is None:
            n_new, k_new = n_target, min(k_goal, n_target)
            if plan0.kind == "mv":
                sch = make_scheme(sch0.name, n=n_new, k_A=k_new)
            else:
                # mm resilience is n - k_A*k_B; k_A/k_B are structural
                sch = make_scheme(sch0.name, n=n_new, k_A=sch0.k_A,
                                  k_B=sch0.k_B)
        key = (sch.name, n_new, k_new, tuple(virt) if virt else None)
        plan = ps._plan_cache.get(key)
        if plan is None:
            plan = compile_plan(plan0._A, scheme=sch, seed=plan0.seed,
                                backend=plan0.backend,
                                cache_size=plan0.cache_size)
            ps._plan_cache[key] = plan
        return plan, virt

    def _reencode(self, ps: _PlanState) -> None:
        """Swap one plan to an encoding sized for the live roster,
        under a FRESH plan id (worker task tables key ``(plan, row)``;
        reusing the id would let stale rows shadow new ones).  Runs
        only with no in-flight rounds on the plan, so no round ever
        sees two encodings."""
        ps.pending_reencode = False
        live = self._live()
        cap = len(live) if self.grow_encodings else ps.max_shards
        m = max(1, min(len(live), cap))
        hosts = live[:m]
        old_pid = ps.plan_id
        try:
            new_plan, cut_caps = self._reencode_scheme(ps, m, hosts)
        except (ValueError, KeyError) as e:
            # scheme family can't be cut at this size (lcm constraints,
            # n' < k_A*k_B, ...): KEEP the old encoding -- re-homed
            # owners already make it correct, just without restored
            # resilience accounting
            self._log_event("reencode-keep", plan=old_pid, error=repr(e))
            return
        new_pid = self._next_plan_id
        self._next_plan_id += 1
        packed = plan_packed(new_plan)
        shards = shard_plan(new_plan, m, packed=packed, plan_id=new_pid,
                            capacities=cut_caps)
        for held in self._held.values():
            held.difference_update(
                {(p, i) for p, i in held if p == old_pid})
        self._plans.pop(old_pid, None)
        self._rr[self._rr.index(old_pid)] = new_pid
        ps.plan = new_plan
        ps.packed = packed
        ps.n_shards = m
        ps._load_shards(shards, hosts)
        ps.home = dict(ps.owner)
        ps.versions[new_pid] = new_plan
        # the id goes last: a caller thread building a call reads the id
        # first, so a call it stamps with the new id saw the new geometry
        ps.plan_id = new_pid
        self._plans[new_pid] = ps
        sent = 0
        for idx in range(len(ps.shard_blobs)):
            holder = ps.shard_hosts[idx]
            sent += self.transport.ship_shard(holder, ps.shard_blobs[idx])
            self._held.setdefault(holder, set()).add((new_pid, idx))
        ps.bytes_shards += sent
        self.bytes_shards += sent
        for w in self.transport.workers():
            if self.transport.alive(w):     # free the stale task tables
                self.transport.drop_plan(w, old_pid)
        self._log_event("reencode", plan=old_pid, new_plan=new_pid,
                        n=new_plan.n, k=new_plan.k, s=new_plan.s,
                        hosts=hosts, capacities=cut_caps)

    # -- decode + future resolution ---------------------------------------

    def _finish_round(self, rnd: _Round, mask, rows, hinv, hinv_dev
                      ) -> None:
        self._rounds.pop((rnd.ps.plan_id, rnd.round_id), None)
        rep = rnd.report
        rep.n_done = len(rnd.results)
        rep.pattern = mask.copy() if mask is not rnd.target else mask
        rep.rows = np.asarray(rows)
        rep.bytes_tasks_dense = rnd.dense_bytes * \
            max(rep.n_dispatched + rep.requeues, 1)
        if not rnd.wait_all:
            for w in self._live():
                self.transport.cancel(w, rnd.round_id)
        # partial-straggler accounting: hosts whose decode-time credit
        # is a strict subset of the task rows they were assigned
        owned: dict[int, int] = {}
        for w in rnd.ps.home.values():
            owned[w] = owned.get(w, 0) + 1
        rep.partial_workers = tuple(sorted(
            w for w, c in owned.items()
            if 0 < rep.completed_per_worker.get(w, 0) < c))
        t_dec = time.perf_counter()
        try:
            if rnd.calls[0].op == "matvec":
                k = rnd.ps.plan.k
                y = np.stack([np.asarray(rnd.results[int(r)]["y"])
                              for r in rows])          # (k, c_pad, width)
                off = 0
                values = []
                for call in rnd.calls:
                    sl = np.ascontiguousarray(y[:, :, off: off + call.width])
                    values.append(call.decode(sl, rows, hinv, hinv_dev))
                    off += call.width
            else:
                values = [rnd.calls[0].decode(rnd.results, rows, hinv,
                                              hinv_dev)]
        except BaseException as e:  # noqa: BLE001 - surface to futures
            for call in rnd.calls:
                call.future._finish(exc=e)
            self._pump_queues()
            return
        finally:
            # decode copied (or abandoned) every slab-backed view above,
            # so an shm transport can reclaim this round's segments now
            try:
                self.transport.finish_round(rnd.round_id)
            except Exception:  # pragma: no cover - close() sweeps leftovers
                pass
        t_end = time.perf_counter()
        rep.decode_s = t_end - t_dec
        rep.wall_s = t_end - rnd.t_start
        if rnd.trace:
            try:
                self._emit_round_trace(rnd, rep, rows, t_dec, t_end)
            except Exception:       # tracing must never fail a round
                pass
        ps = rnd.ps
        ps.reports.append(rep)
        ps.wall_ewma_s = rep.wall_s if ps.wall_ewma_s is None \
            else 0.8 * ps.wall_ewma_s + 0.2 * rep.wall_s
        ps.decode_ewma_s = rep.decode_s if ps.decode_ewma_s is None \
            else 0.8 * ps.decode_ewma_s + 0.2 * rep.decode_s
        for call, value in zip(rnd.calls, values):
            call.future.report = rep    # observability + parity replay
            call.future._finish(value=value)
        self._pump_queues()

    def _emit_round_trace(self, rnd: _Round, rep: ClusterReport, rows,
                          t_dec: float, t_end: float) -> None:
        """Decode-time span emission for one traced round.

        Worker-side stamps (recv/start/finish, on the worker's clock)
        are shifted onto the coordinator timeline by the hello clock
        offset, then the round decomposes along its *critical chain* --
        the used task whose arrival made it decodable -- into
        coordinator-queue / wire-out / worker-queue / compute /
        wire-back / decode segments.  One structured ``round`` record
        (cat="round") carries the whole breakdown; ``repro_torch.obs.attrib``
        consumes exactly that record.
        """
        tr = self._tracer
        if tr is None:
            return
        trace = rnd.trace
        t_submit = min((c.future._t_submit for c in rnd.calls
                        if c.future._t_submit is not None),
                       default=rnd.t_start)
        used = {int(r) for r in np.asarray(rows).ravel()}
        tasks = []
        for row, (w, t_recv, t_s, t_f, t_arr) in rnd.task_meta.items():
            off = self.transport.clock_offset(w)
            stamped = t_recv > 0.0 and t_s > 0.0 and t_f > 0.0
            info = {"row": int(row), "worker": int(w),
                    "sent": rnd.sent_at.get(row),
                    "recv": t_recv + off if stamped else None,
                    "start": t_s + off if stamped else None,
                    "finish": t_f + off if stamped else None,
                    "arrival": t_arr,
                    "work": float(rnd.ps.work.get(row, 1.0)),
                    "used": int(row) in used}
            tasks.append(info)
            if stamped:
                tr.complete("compute", info["start"], info["finish"],
                            cat="worker", track=f"worker-{w}",
                            trace=trace, row=int(row),
                            round=rnd.round_id, plan=rnd.ps.plan_id,
                            used=info["used"])

        def clamp(x: float) -> float:
            return max(0.0, float(x))

        # critical chain: among the used tasks with full stamps, the
        # one whose arrival completed the fastest-k set.  Offsets
        # telescope across wire_out/wire_back, so the clamped segment
        # sum matches (t_end - t_submit) up to clock-offset error --
        # the BENCH_obs 10% criterion measures exactly that error.
        crit = max((t for t in tasks
                    if t["used"] and t["sent"] is not None
                    and t["recv"] is not None),
                   key=lambda t: t["arrival"], default=None)
        segments = {}
        if crit is not None:
            segments = {
                "coord_queue": clamp(crit["sent"] - t_submit),
                "wire_out": clamp(crit["recv"] - crit["sent"]),
                "worker_queue": clamp(crit["start"] - crit["recv"]),
                "compute": clamp(crit["finish"] - crit["start"]),
                "wire_back": clamp(crit["arrival"] - crit["finish"]),
                "decode_wait": clamp(t_dec - crit["arrival"]),
                "decode": clamp(t_end - t_dec),
            }
        owners = {int(w) for w in rnd.inflight.values()}
        used_workers = {t["worker"] for t in tasks if t["used"]}
        cancelled = sorted(int(r) for r in rnd.inflight
                           if int(r) not in rnd.results)
        tr.complete("queue", t_submit, rnd.t_start, cat="fleet",
                    track="fleet", trace=trace, round=rnd.round_id)
        tr.complete("decode", t_dec, t_end, cat="fleet", track="fleet",
                    trace=trace, round=rnd.round_id, rows=len(used))
        tr.complete("round", t_submit, t_end, cat="round",
                    track=f"plan-{rnd.ps.plan_id}", trace=trace,
                    plan=rnd.ps.plan_id, round=rnd.round_id, op=rep.op,
                    calls=rep.calls, wall_s=rep.wall_s,
                    decode_s=rep.decode_s, requeues=rep.requeues,
                    segments=segments, tasks=tasks,
                    decoded_without=sorted(owners - used_workers),
                    cancelled_rows=cancelled)

    # -- re-shipping (plan retune) ----------------------------------------

    def _reship(self, ps: _PlanState) -> int:
        """Re-shard the (re-compiled) plan and re-ship every shard to
        its current holder (see ``ClusterPlan.reship``)."""
        if self._closed:
            raise RuntimeError("fleet has been closed")
        packed = plan_packed(ps.plan)
        shards = shard_plan(ps.plan, ps.n_shards, packed=packed,
                            plan_id=ps.plan_id)
        fut = concurrent.futures.Future()

        def swap():
            try:
                owner_before = dict(ps.owner)
                ps.packed = packed
                ps._load_shards(shards)
                ps.owner = owner_before     # keep post-failure re-homing
                sent = 0
                for host, held in self._held.items():
                    if host in self._dead:
                        continue
                    for pid, idx in held:
                        if pid != ps.plan_id:
                            continue
                        sent += self.transport.ship_shard(
                            host, ps.shard_blobs[idx])
                ps.bytes_shards += sent
                self.bytes_shards += sent
                fut.set_result(sent)
            except BaseException as e:  # noqa: BLE001
                fut.set_exception(e)

        self._loop.call_soon_threadsafe(swap)
        return fut.result()


# ---------------------------------------------------------------------------
# Plan handles (the per-plan public surface)
# ---------------------------------------------------------------------------


class PlanHandle:
    """One attached plan's session surface.

    ``submit_*`` return ``CodedFuture``s and never block on the round
    (only on backpressure); the plain ``matvec / matmat / aggregate``
    are the blocking conveniences (``submit(...).result()``) that make
    a handle a drop-in for a ``ClusterPlan`` or an in-process
    ``CodedPlan``.
    """

    def __init__(self, fleet: CodedFleet, ps: _PlanState):
        self.fleet = fleet
        self._ps = ps

    # -- introspection ----------------------------------------------------

    @property
    def plan(self):
        return self._ps.plan

    @property
    def plan_id(self) -> int:
        return self._ps.plan_id

    def plan_version(self, plan_id: int):
        """The plan object that served under ``plan_id`` (re-encodes
        allocate fresh ids; chaos parity replays a report's pattern
        against the exact version that produced it)."""
        return self._ps.versions.get(plan_id)

    @property
    def n_workers(self) -> int:
        return self._ps.n_shards

    @property
    def n_tasks(self) -> int:
        return self._ps.plan.n_tasks

    @property
    def k(self) -> int:
        return self._ps.plan.k

    @property
    def reports(self) -> deque:
        return self._ps.reports

    @property
    def last_report(self) -> ClusterReport | None:
        return self._ps.reports[-1] if self._ps.reports else None

    @property
    def bytes_shards(self) -> int:
        return self._ps.bytes_shards

    @property
    def bytes_tasks_total(self) -> int:
        return self._ps.bytes_tasks_total

    @property
    def shard_blobs(self) -> list[bytes]:
        return self._ps.shard_blobs

    def wire_totals(self) -> dict:
        """This plan's bytes-on-wire (the fleet aggregates across plans)."""
        return {"transport": self.fleet.transport_name,
                "bytes_shards": self._ps.bytes_shards,
                "bytes_tasks_total": self._ps.bytes_tasks_total,
                "bytes_copied_total": self._ps.bytes_copied_total}

    def metrics(self) -> dict:
        """This plan's slice of ``fleet.metrics()``: queue depth,
        in-flight rounds, latency EWMAs, resolution counters."""
        snap = self.fleet.metrics()
        mine = snap["plans"].get(self._ps.plan_id)
        if mine is None:                # detached: static view
            mine = self._ps.snapshot()
            mine["inflight_rounds"] = 0
        mine["fleet"] = {k: snap[k] for k in
                         ("transport", "n_live", "max_inflight",
                          "inflight_rounds", "worker_capacities")}
        return mine

    def set_microbatch_cols(self, cols: int | None) -> None:
        """Dynamically retarget this plan's coalescing cap (``None``
        falls back to the fleet default).  Takes effect at the next
        pump; in-flight rounds are unaffected.  This is the knob the
        serve router's adaptive-width feedback loop drives."""
        self._ps.microbatch_cols = None if cols is None \
            else max(1, int(cols))

    # -- lifecycle ---------------------------------------------------------

    def detach(self) -> None:
        """Withdraw this plan from the fleet (queued calls cancelled,
        in-flight rounds dropped).  The fleet and its workers stay up
        for the other attached plans."""
        if self.fleet._closed or self._ps.detached:
            self._ps.detached = True
            return
        fut = concurrent.futures.Future()
        self.fleet._loop.call_soon_threadsafe(
            self.fleet._do_detach, self._ps, fut)
        fut.result(timeout=5)

    def reship(self) -> int:
        """Re-ship this plan's (re-tuned) shards to their current
        holders; returns bytes shipped (see ``CodedPlan.retune``)."""
        return self.fleet._reship(self._ps)

    # -- mask plumbing -----------------------------------------------------

    def _target(self, done) -> tuple[np.ndarray, bool]:
        plan = self._ps.plan
        if done is None:
            return np.ones(plan.n_tasks, bool), False
        mask = np.asarray(plan._task_done(host_mask(done)), bool)
        if mask.shape[0] != plan.n_tasks:
            raise ValueError(f"done mask covers {mask.shape[0]} tasks, "
                             f"plan has {plan.n_tasks}")
        if int(mask.sum()) < plan.k:
            raise ValueError(f"done mask admits {int(mask.sum())} task "
                             f"rows, need at least k={plan.k}")
        return mask, True

    def _deadline(self, deadline) -> float | None:
        return deadline if deadline is not None \
            else self._ps.default_deadline

    # -- async submission --------------------------------------------------

    def _make_matvec_call(self, x, done, deadline,
                          group: int | None = None) -> _Call:
        ps = self._ps
        if ps.plan.kind != "mv":
            raise ValueError(f"matvec needs an mv plan, got {ps.plan.kind}")
        if ps.packed is None:
            raise ValueError("aggregation-only plan: no shards to matvec")
        x = host_f32(x)
        squeeze = x.ndim == 1
        xb = x[None, :] if squeeze else x
        b = xb.shape[0]
        call = _Call(op="matvec", future=CodedFuture(self.fleet, ps),
                     target=None, wait_all=False,
                     deadline=self._deadline(deadline), width=b,
                     group=group)

        def build(c: _Call) -> None:
            # everything geometry-dependent, derived from the plan
            # version current at build/launch time; the id is read
            # first (a re-encode stores it last), so a call built across
            # a re-encode carries the old id and is rebuilt at launch
            pid = ps.plan_id
            plan, packed = ps.plan, ps.packed
            # an shm transport hands out a shared-memory slab here so
            # the one unavoidable operand copy (the pad/transpose below)
            # lands directly in the segment workers will map
            b_op = self.fleet.transport.alloc_operand(
                (packed.t_pad, b), np.float32)
            if b_op is None:
                b_op = np.zeros((packed.t_pad, b), np.float32)
            b_op[: packed.t] = xb.T[: packed.t]
            c.b_op = b_op
            c.target, c.wait_all = self._target(done)
            k, c_pad, c_log, r = plan.k, packed.c_pad, packed.c, plan.r
            dev, card = plan.device, _on_card(plan)

            def decode(y_slice, rows, hinv, hinv_dev):
                if card:
                    # the k live results go to the device once; the
                    # decode stores (b, r) itself, pad columns skipped
                    from ..kernels.decode_matmul import decode_matmul  # noqa: PLC0415

                    out = decode_matmul(
                        _device_inverse(hinv, hinv_dev, dev),
                        torch.from_numpy(y_slice).to(dev), "mv", c=c_log,
                        r=r)
                else:
                    u = hinv @ y_slice.reshape(k, -1)
                    u = u.reshape(k, c_pad, b)[:, : c_log]
                    out = np.moveaxis(u, 2, 0).reshape(b, -1)[:, : r]
                    out = torch.from_numpy(np.ascontiguousarray(out)).to(dev)
                return out[0] if squeeze else out

            c.decode = decode
            c.built_for = pid

        build(call)
        # explicit masks are in this plan version's task coordinates:
        # they cannot survive a re-encode, so they don't get a rebuild
        call.rebuild = None if done is not None else build
        return call

    def submit_matvec(self, x, done=None, *,
                      deadline: float | None = None,
                      block: bool | None = None) -> CodedFuture:
        """A^T x as a future.  ``done=None`` races the workers (and may
        be microbatched with other queued matvecs); an explicit mask
        replays that exact pattern (parity mode, never coalesced).
        ``block`` overrides the fleet's admission policy for this call
        (``False`` sheds instead of waiting on a full queue)."""
        return self.fleet._submit_call(
            self._ps, self._make_matvec_call(x, done, deadline),
            block=block)

    def submit_matvec_many(self, xs, *, deadline: float | None = None,
                           block: bool | None = None) -> list[CodedFuture]:
        """Submit a pre-packed group of race-mode matvecs: the calls
        coalesce into exactly ONE round (exempt from the microbatch
        cap -- the caller already chose the width) but keep per-call
        futures and per-call decode slices, so each result is bitwise
        identical to the same call submitted solo.  The serve router
        dispatches its adaptive batches through this.  Admission is
        all-or-nothing; ``block=False`` sheds rather than waiting (a
        scheduler thread must never park inside fleet admission)."""
        if not xs:
            return []
        grp = next(self.fleet._group_counter)
        calls = [self._make_matvec_call(x, None, deadline, group=grp)
                 for x in xs]
        return self.fleet._submit_group(self._ps, calls, block=block)

    def submit_matmat(self, B, done=None, *,
                      deadline: float | None = None) -> CodedFuture:
        """A^T B as a future; each task ships only the nonzero coded-B
        block-rows in the worker's tile support (the omega_B/k_B
        bandwidth claim, measured per call)."""
        ps = self._ps
        if ps.plan.kind != "mm":
            raise ValueError(f"matmat needs an mm plan, got {ps.plan.kind}")
        w = B.shape[1]
        call = _Call(op="matmat", future=CodedFuture(self.fleet, ps),
                     target=None, wait_all=False,
                     deadline=self._deadline(deadline))

        def build(c: _Call) -> None:
            from ..core.coded_matmul import split_block_columns  # noqa: PLC0415
            from ..runtime import encode_blocks  # noqa: PLC0415

            pid = ps.plan_id                # first: see the matvec build
            plan, packed = ps.plan, ps.packed
            sch = plan.scheme
            dev, card = plan.device, _on_card(plan)
            blocks_b = split_block_columns(as_tensor(B, dev), sch.k_B)
            if plan._sup_b is not None:
                # a card plan encodes B with cyclic_encode, a host plan
                # as its in-process packed backend does
                coded_b = encode_blocks(blocks_b, plan._sup_b, plan._coef_b,
                                        "cuda" if card else "packed")
            else:
                coded_b = torch.einsum(
                    "nk,ktc->ntc",
                    torch.as_tensor(plan._rb, dtype=torch.float32,
                                    device=dev),
                    blocks_b.to(torch.float32))
            # the tasks travel from the host
            b_np = host_f32(coded_b)
            cb = b_np.shape[2]
            c.target, c.wait_all = self._target(done)
            pid = ps.plan_id

            def make_task(row: int, round_id: int) -> Task:
                b_op = np.zeros((packed.t_pad, cb), np.float32)
                b_op[: packed.t] = b_np[row, : packed.t]
                return Task(round=round_id, op="matmat", task_row=row,
                            plan=pid,
                            payload=ps.restricted_payload(row, b_op),
                            meta={"cb": cb})

            def decode(results, rows, hinv, hinv_dev):
                k = plan.k
                y = np.stack([np.asarray(results[int(r)]["y"])
                              for r in rows])          # (k, c_pad, cb)
                if card:
                    # one upload, one decode storing the merged (r, w)
                    from ..kernels.decode_matmul import decode_matmul  # noqa: PLC0415

                    return decode_matmul(
                        _device_inverse(hinv, hinv_dev, dev),
                        torch.from_numpy(y).to(dev), "mm", c=packed.c,
                        r=plan.r, w=w, kb=sch.k_B)
                y = y[:, : packed.c]                   # (k, ca, cb)
                u = hinv @ y.reshape(k, -1)
                u = u.reshape((k,) + y.shape[1:])
                ka, kb = sch.k_A, sch.k_B
                ca = y.shape[1]
                out = u.reshape(ka, kb, ca, cb).transpose(0, 2, 1, 3)
                out = out.reshape(ka * ca, kb * cb)[: plan.r, : w]
                return torch.from_numpy(np.ascontiguousarray(out)).to(dev)

            c.make_task = make_task
            c.decode = decode
            c.dense_bytes = int(packed.t_pad * cb * 4)
            c.built_for = pid

        build(call)
        call.rebuild = None if done is not None else build
        return self.fleet._submit_call(ps, call)

    def submit_aggregate(self, payloads, done=None, *,
                         deadline: float | None = None) -> CodedFuture:
        """Straggler-resilient sum of k shard-gradients as a future
        (gradient-coding decode: a^T G[rows] = 1^T).  Payloads are
        per-task-row, so the call is tied to its plan version: if the
        plan is re-encoded while this sits queued it fails with
        ``FleetDegraded(action="re-encode")`` instead of mis-summing."""
        ps = self._ps
        pid = ps.plan_id                    # first: see the matvec build
        plan = ps.plan
        if plan.kind != "mv":
            raise ValueError("aggregate needs an mv plan")
        if len(payloads) != plan.n_tasks:
            raise ValueError(f"need {plan.n_tasks} worker payloads, "
                             f"got {len(payloads)}")
        # tensors travel from the host (a bf16 leaf keeps its bits)
        flat = [[x.detach().cpu() if isinstance(x, torch.Tensor)
                 else np.asarray(x) for x in _leaves(p)] for p in payloads]
        n_leaves = len(flat[0])
        sizes = np.asarray([sum(int(np.prod(x.shape)) for x in leaves)
                            for leaves in flat], float)
        work = sizes / max(sizes.max(), 1.0)
        target, wait_all = self._target(done)

        def make_task(row: int, round_id: int) -> Task:
            return Task(round=round_id, op="aggregate", task_row=row,
                        plan=ps.plan_id,
                        payload={f"leaf{i}": x
                                 for i, x in enumerate(flat[row])},
                        meta={"work": float(work[row])})

        def decode(results, rows, hinv, hinv_dev):
            a = hinv.sum(axis=0)           # a^T G[rows] = 1^T
            out_leaves = []
            for i in range(n_leaves):
                acc = None
                for coef, r in zip(a, rows):
                    term = coef * host_f32(results[int(r)][f"leaf{i}"])
                    acc = term if acc is None else acc + term
                out_leaves.append(torch.from_numpy(
                    np.ascontiguousarray(acc)).to(plan.device))
            return _rebuild(payloads[0], iter(out_leaves))

        call = _Call(op="aggregate", future=CodedFuture(self.fleet, ps),
                     target=target, wait_all=wait_all,
                     deadline=self._deadline(deadline),
                     make_task=make_task, decode=decode,
                     built_for=pid)
        return self.fleet._submit_call(ps, call)

    # -- blocking conveniences (CodedPlan signatures) ----------------------

    def matvec(self, x, done=None, *, deadline: float | None = None):
        return self.submit_matvec(x, done, deadline=deadline).result()

    def matmat(self, B, done=None, *, deadline: float | None = None):
        return self.submit_matmat(B, done, deadline=deadline).result()

    def aggregate(self, payloads, done=None, *,
                  deadline: float | None = None):
        return self.submit_aggregate(payloads, done,
                                     deadline=deadline).result()
