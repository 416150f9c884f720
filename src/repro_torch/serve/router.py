"""Serve front door: a multi-tenant router over coded fleet replicas
(the port of ``repro.serve.router``).

The paper's MM regime exists because batching amortizes coded work:
one round of width ``b`` spreads the omega/k-weight encode/decode cost
across ``b`` operand columns.  The fleet already coalesces queued
matvecs, but only under a *static* per-plan cap -- good for one cap
only at one offered load.  The router is the layer that decides the
width: it fronts one or more ``CodedFleet`` replicas with **named
endpoints**, queues calls **per tenant**, and dispatches single-tenant
batches whose width follows the queue.

Surface::

    router = Router()
    router.register("lm-head", plan, replicas=2, n_workers=12)
    router.set_tenant("free", weight=1.0)
    router.set_tenant("pro", weight=3.0)
    fut = router.submit("lm-head", x, tenant="pro", deadline=0.2)
    y = fut.result()            # the same CodedFuture the fleet returns
    router.close()

Scheduling is **weighted-fair stride**: each tenant accumulates a
virtual pass ``pass += dispatched_cols / weight`` and the tenant with
the smallest pass dispatches next (ties break by name), so a burst
from one tenant can starve nobody and service ratios converge to the
weight ratios deterministically.  Batches are single-tenant: a
deadline failure or ``FleetDegraded`` on a round fails only that
tenant's futures.  Admission is per-tenant bounded (``queue_cap``
calls; ``admission="block"`` or ``"shed"``).

**Adaptive microbatching** is the core feedback loop: each endpoint
holds an effective width ``w`` in ``[min_cols, max_cols]``; every
dispatch folds the queued columns it *left behind* into an EWMA, and
``w`` doubles when that leftover backlog sustains >= ``w`` and halves
when it falls under ``w/4``.  A dispatch fires when the backlog reaches ``w``, when
the oldest queued call has waited ``batch_wait_s``, or when a deadline
is near -- so at low load ``w`` collapses and calls fly solo with no
collection window, while at high load ``w`` climbs and rounds widen
until decode amortization saturates.  ``adaptive=False`` freezes ``w``
(the static cap the feedback loop replaces).  Batches go to the fleet
via ``PlanHandle.submit_matvec_many`` -- one round, per-call decode
slices -- so every routed result is **bitwise identical** to the same
call submitted solo against the handle.  Dispatch never blocks: the
router tracks each replica's unresolved calls and clamps every batch
to the fleet's free admission slots (``queue_cap``), submitting
non-blocking -- so one saturated endpoint can neither deadlock the
scheduler nor head-of-line-block other endpoints' tenants.  Fleets
the router creates itself get ``queue_cap >= max_cols`` so the clamp
never limits the adaptive width; for externally-owned fleets the
effective width tops out at their ``queue_cap``.

Replica balancing picks the live, non-draining replica with the
fewest outstanding columns (``least-loaded``, default) or cycles
(``round-robin``; ``REPRO_ROUTER_BALANCER``).  Config push rolls out
without dropping in-flight traffic: ``configure`` retunes widths and
windows at the next dispatch, ``swap_plan`` attaches the new plan
before flipping and detaches the old handle only after its in-flight
rounds drain, and ``add_replica``/``remove_replica`` grow and drain
the replica set live.  ``close()`` drains tenant queues, detaches
endpoints, and closes owned replica fleets, idempotently.

Replica fleets the router creates live where the endpoint's plan
does: a card plan (``backend="cuda"``) gets card workers on the plan's
device (each task one ``bcsr_matmul`` at the batch's width, each call's
slice one ``decode_matmul``), a host plan host workers.  The scheduler
thread never touches a tensor's values: ``submit`` brings the operand
and an explicit mask to the host on the caller's thread, and futures
resolve on the fleet loop.

Env vars: ``REPRO_ROUTER_BALANCER`` (least-loaded | round-robin),
``REPRO_ROUTER_QUEUE_CAP`` (per-tenant admission bound, calls),
``REPRO_ROUTER_MAX_COLS`` (adaptive width ceiling).
"""

from __future__ import annotations

import functools
import os
import threading
import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np

from .._device import host_f32, host_mask
from .._env import env_int
from ..cluster.fleet import (
    CodedFleet,
    CodedFuture,
    FleetDegraded,
    plan_workers,
)
from ..obs.trace import default_tracer

ENV_BALANCER = "REPRO_ROUTER_BALANCER"
ENV_QUEUE_CAP = "REPRO_ROUTER_QUEUE_CAP"
ENV_MAX_COLS = "REPRO_ROUTER_MAX_COLS"

_BALANCERS = ("least-loaded", "round-robin")


def default_balancer() -> str:
    b = os.environ.get(ENV_BALANCER, "least-loaded")
    if b not in _BALANCERS:
        raise ValueError(f"{ENV_BALANCER}={b!r}: pick one of {_BALANCERS}")
    return b


def default_queue_cap() -> int:
    return env_int(ENV_QUEUE_CAP, 256)


def default_max_cols() -> int:
    return env_int(ENV_MAX_COLS, 128)


@dataclass
class _TenantConfig:
    name: str
    weight: float = 1.0
    queue_cap: int = field(default_factory=default_queue_cap)
    admission: str = "block"            # block | shed
    deadline: float | None = None       # default per-call deadline


@dataclass(eq=False)        # identity semantics: hashable, and queue
class _RCall:               # membership never aliases equal-field calls
    """One routed call, queued under its (endpoint, tenant)."""

    x: np.ndarray                       # operand, host f32
    cols: int                           # scheduling width (1 for 1-D x)
    done: object                        # explicit mask -> solo parity mode
    deadline_s: float | None            # as requested (batch compat key)
    deadline_at: float | None           # absolute queue+round budget
    future: CodedFuture
    tenant: str
    t_enq: float
    state: str = "queued"               # queued | dispatched | done


class _TenantQueue:
    """Per-(endpoint, tenant) admission + backlog + stride state."""

    def __init__(self, cfg: _TenantConfig):
        self.cfg = cfg
        self.queue: deque[_RCall] = deque()
        self.sem = threading.Semaphore(cfg.queue_cap)
        self.pass_v = 0.0               # stride virtual time
        self.counters = {"submitted": 0, "dispatched": 0, "resolved": 0,
                         "failed": 0, "cancelled": 0, "shed": 0,
                         "deadline_hit": 0, "dispatched_cols": 0}

    @property
    def name(self) -> str:
        return self.cfg.name

    def queued_cols(self) -> int:
        return sum(c.cols for c in self.queue)


class _Replica:
    """One fleet behind an endpoint, plus its in-flight accounting."""

    def __init__(self, index: int, fleet: CodedFleet, handle, owned: bool):
        self.index = index
        self.fleet = fleet
        self.handle = handle            # current plan handle
        self.owned = owned
        self.draining = False
        self.outstanding: dict = {}     # handle -> in-flight batches
        self.out_calls: dict = {}       # handle -> unresolved calls
        self.out_cols = 0
        self.dispatched = 0             # lifetime batches

    def total_outstanding(self) -> int:
        return sum(self.outstanding.values())

    def free_calls(self) -> int:
        """Unused fleet admission slots on the current handle.  The
        router is the handle's only submitter, so this budget is exact:
        a batch clamped to it can never block (or shed) in fleet
        admission."""
        return self.fleet.queue_cap - self.out_calls.get(self.handle, 0)


class _Endpoint:
    def __init__(self, name: str, plan, replicas: list[_Replica], *,
                 adaptive: bool, width: int, min_cols: int, max_cols: int,
                 batch_wait_s: float):
        self.name = name
        self.plan = plan
        self.replicas = replicas
        self.adaptive = adaptive
        self.width = width
        self.min_cols = min_cols
        self.max_cols = max_cols
        self.batch_wait_s = batch_wait_s
        self.tenants: dict[str, _TenantQueue] = {}
        self.depth_ewma = 0.0
        self.vtime = 0.0                # pass of the last dispatched tenant
        self.rr = 0                     # round-robin replica cursor
        self.next_rindex = len(replicas)  # monotonic: never reuse an index
        self.inflight: set = set()      # dispatched, unresolved _RCalls
        self.draining = False
        self.log: deque[dict] = deque(maxlen=2048)

    def queued_cols(self) -> int:
        return sum(tq.queued_cols() for tq in self.tenants.values())

    def outstanding(self) -> int:
        return sum(r.total_outstanding() for r in self.replicas)


@dataclass
class _Job:
    ep: _Endpoint
    tq: _TenantQueue
    replica: _Replica
    handle: object
    batch: list[_RCall]
    cols: int
    remaining: int = 0


def _owned_fleet(plan, n_workers: int | None, transport: str | None,
                 max_inflight: int | None, max_cols: int) -> CodedFleet:
    """A replica fleet the router owns, where ``plan`` lives: card
    workers on a card plan's device, host workers for a host plan.
    ``queue_cap >= max_cols``: a full-width adaptive batch must fit the
    fleet's admission queue, or the per-replica call budget would clamp
    it back down."""
    backend, device = plan_workers(plan)
    return CodedFleet(
        n_workers if n_workers is not None else plan.n,
        transport=transport, max_inflight=max_inflight or 4,
        queue_cap=max(4 * (max_inflight or 4), 32, max_cols),
        device=device, backend=backend)


class Router:
    """Multi-tenant serve front door over coded fleet replicas (see
    module docstring).  One scheduler thread owns all queue/width/
    balance state; submission and completion only touch it under the
    router condition."""

    def __init__(self, *, balancer: str | None = None,
                 batch_wait_s: float = 0.004,
                 min_cols: int = 1, max_cols: int | None = None,
                 tracer=None):
        self.balancer = balancer if balancer is not None \
            else default_balancer()
        # disabled tracing is represented by None (one identity check
        # on the scheduler path); explicit tracer wins over REPRO_TRACE
        self._tracer = tracer if tracer is not None else default_tracer()
        if self.balancer not in _BALANCERS:
            raise ValueError(f"balancer must be one of {_BALANCERS}, "
                             f"got {self.balancer!r}")
        self.default_batch_wait_s = batch_wait_s
        self.default_min_cols = max(1, min_cols)
        self.default_max_cols = max_cols if max_cols is not None \
            else default_max_cols()
        self._cond = threading.Condition()
        self._endpoints: dict[str, _Endpoint] = {}
        self._tenants: dict[str, _TenantConfig] = {}
        self._pending_detach: list = []
        self._paused = False
        self._closing = False
        self._close_deadline: float | None = None
        self._closed = False
        self._close_lock = threading.Lock()
        self._ep_cursor = 0
        self._sched = threading.Thread(
            target=self._run, name="repro-router-sched", daemon=True)
        self._sched.start()

    # -- registration / config push ----------------------------------------

    def register(self, name: str, plan, *, replicas: int | None = None,
                 fleets=None, n_workers: int | None = None,
                 transport: str | None = None, scheme_opts=None,
                 adaptive: bool = True, width: int | None = None,
                 min_cols: int | None = None, max_cols: int | None = None,
                 batch_wait_s: float | None = None,
                 max_inflight: int | None = None) -> None:
        """Create endpoint ``name`` backed by replica fleets.

        ``plan`` is a precompiled ``CodedPlan``, a list of plans (one
        per replica, same math), or a raw matrix compiled on the spot
        via ``scheme_opts`` (kwargs for ``repro_torch.api.compile_plan``).
        ``fleets`` attaches to externally-owned fleets (never closed by
        the router); otherwise ``replicas`` owned fleets of
        ``n_workers`` (default ``plan.n``) are created on ``transport``,
        on the plan's device with its kind of worker.
        ``adaptive=False`` freezes the width at ``width`` (the static
        cap); adaptive mode walks it in ``[min_cols, max_cols]``.
        """
        from ..api.plan import CodedPlan, compile_plan  # noqa: PLC0415

        with self._cond:
            if self._closing or self._closed:
                raise RuntimeError("router has been closed")
            if name in self._endpoints:
                raise ValueError(f"endpoint {name!r} already registered")
        if not isinstance(plan, (CodedPlan, list, tuple)):
            plan = compile_plan(plan, **(scheme_opts or {}))
        if fleets is not None:
            fleets = list(fleets)
            n_rep = len(fleets)
            if replicas is not None and replicas != n_rep:
                raise ValueError(f"replicas={replicas} but {n_rep} "
                                 f"fleets were passed")
        else:
            n_rep = replicas if replicas is not None else 1
        plans = list(plan) if isinstance(plan, (list, tuple)) \
            else [plan] * n_rep
        if len(plans) != n_rep:
            raise ValueError(f"{len(plans)} plans for {n_rep} replicas")
        max_cols = max_cols if max_cols is not None else self.default_max_cols
        min_cols = min_cols if min_cols is not None else self.default_min_cols
        if width is None:
            width = min_cols if adaptive else max_cols
        width = min(max(width, min_cols), max_cols)
        reps: list[_Replica] = []
        try:
            for i in range(n_rep):
                if fleets is not None:
                    fleet, owned = fleets[i], False
                else:
                    fleet, owned = _owned_fleet(
                        plans[i], n_workers, transport, max_inflight,
                        max_cols), True
                reps.append(_Replica(i, fleet, fleet.attach(plans[i]),
                                     owned))
        except BaseException:
            for r in reps:
                if r.owned:
                    r.fleet.close()
            raise
        ep = _Endpoint(name, plans[0], reps, adaptive=adaptive, width=width,
                       min_cols=min_cols, max_cols=max_cols,
                       batch_wait_s=batch_wait_s if batch_wait_s is not None
                       else self.default_batch_wait_s)
        with self._cond:
            if name in self._endpoints or self._closing:
                for r in reps:
                    if r.owned:
                        r.fleet.close()
                raise RuntimeError(f"endpoint {name!r} raced another "
                                   f"register or the router is closing")
            self._endpoints[name] = ep
            self._cond.notify_all()

    def has_endpoint(self, name: str) -> bool:
        with self._cond:
            ep = self._endpoints.get(name)
            return ep is not None and not ep.draining

    def endpoints(self) -> list[str]:
        with self._cond:
            return sorted(self._endpoints)

    def set_tenant(self, name: str, *, weight: float | None = None,
                   queue_cap: int | None = None,
                   admission: str | None = None,
                   deadline: float | None = None) -> None:
        """Create or retune a tenant: scheduling ``weight`` (service is
        weight-proportional under contention), per-endpoint admission
        bound ``queue_cap`` (calls; applies to queues created after the
        change), ``admission`` "block"/"shed", and a default per-call
        ``deadline``.  Unknown tenants are auto-created at weight 1 on
        first submit."""
        if admission is not None and admission not in ("block", "shed"):
            raise ValueError(f"admission must be 'block' or 'shed', "
                             f"got {admission!r}")
        with self._cond:
            cfg = self._tenants.setdefault(name, _TenantConfig(name))
            if weight is not None:
                if weight <= 0:
                    raise ValueError("tenant weight must be positive")
                cfg.weight = float(weight)
            if queue_cap is not None:
                cfg.queue_cap = max(1, int(queue_cap))
            if admission is not None:
                cfg.admission = admission
            if deadline is not None:
                cfg.deadline = deadline
            self._cond.notify_all()

    def configure(self, name: str, *, adaptive: bool | None = None,
                  width: int | None = None, min_cols: int | None = None,
                  max_cols: int | None = None,
                  batch_wait_s: float | None = None) -> None:
        """Retune an endpoint's batching live; applies at the next
        dispatch, in-flight rounds unaffected."""
        with self._cond:
            ep = self._ep(name)
            if adaptive is not None:
                ep.adaptive = adaptive
            if min_cols is not None:
                ep.min_cols = max(1, min_cols)
            if max_cols is not None:
                ep.max_cols = max(1, max_cols)
            if width is not None:
                ep.width = width
            ep.width = min(max(ep.width, ep.min_cols), ep.max_cols)
            if batch_wait_s is not None:
                ep.batch_wait_s = batch_wait_s
            self._cond.notify_all()

    def swap_plan(self, name: str, plan, *, replica: int | None = None
                  ) -> None:
        """Roll a new plan (e.g. a different scheme, a retuned backend)
        onto an endpoint's replicas without dropping traffic: the new
        plan attaches first, new batches flip to it, and each old
        handle detaches only after its in-flight rounds drain."""
        with self._cond:
            ep = self._ep(name)
            targets = ep.replicas if replica is None \
                else [ep.replicas[replica]]
            fleets = [r.fleet for r in targets]
        handles = [f.attach(plan) for f in fleets]   # blocking, pre-flip
        detach_now = []
        with self._cond:
            ep.plan = plan
            for r, h in zip(targets, handles):
                old = r.handle
                r.handle = h
                if r.outstanding.get(old, 0) == 0:
                    r.outstanding.pop(old, None)
                    detach_now.append(old)
                # else: _on_inner retires it at zero outstanding
            self._cond.notify_all()
        for h in detach_now:
            h.detach()

    def add_replica(self, name: str, *, fleet: CodedFleet | None = None,
                    n_workers: int | None = None,
                    transport: str | None = None,
                    max_inflight: int | None = None) -> int:
        """Grow an endpoint's replica set live; returns the new replica
        index (monotonic -- an index removed by ``remove_replica`` is
        never reissued).  The new fleet serves from the next dispatch
        on."""
        with self._cond:
            ep = self._ep(name)
            plan = ep.plan
            max_cols = ep.max_cols
        owned = fleet is None
        if owned:
            fleet = _owned_fleet(plan, n_workers, transport, max_inflight,
                                 max_cols)
        try:
            handle = fleet.attach(plan)
        except BaseException:
            if owned:
                fleet.close()
            raise
        with self._cond:
            r = _Replica(ep.next_rindex, fleet, handle, owned)
            ep.next_rindex += 1
            ep.replicas.append(r)
            self._cond.notify_all()
            return r.index

    def remove_replica(self, name: str, index: int, *,
                       timeout: float = 30.0) -> None:
        """Drain one replica out of rotation: no new batches, wait for
        its in-flight rounds, then detach (and close, if owned)."""
        with self._cond:
            ep = self._ep(name)
            reps = [r for r in ep.replicas if r.index == index]
            if not reps:
                raise ValueError(f"endpoint {name!r} has no replica "
                                 f"{index}")
            r = reps[0]
            if len([x for x in ep.replicas if not x.draining]) <= 1:
                raise ValueError(f"cannot remove the last live replica "
                                 f"of {name!r}")
            r.draining = True
            self._cond.notify_all()
            if not self._cond.wait_for(
                    lambda: r.total_outstanding() == 0, timeout):
                r.draining = False
                raise TimeoutError(f"replica {index} of {name!r} did not "
                                   f"drain within {timeout}s")
            ep.replicas.remove(r)
        for h in [r.handle, *r.outstanding]:
            try:
                h.detach()
            except Exception:
                pass
        if r.owned:
            r.fleet.close()

    def _ep(self, name: str) -> _Endpoint:
        ep = self._endpoints.get(name)
        if ep is None or ep.draining:
            raise ValueError(f"no endpoint {name!r} (have "
                             f"{sorted(self._endpoints)})")
        return ep

    # -- submission (caller threads) ---------------------------------------

    def submit(self, name: str, x, *, tenant: str = "default",
               deadline: float | None = None, done=None) -> CodedFuture:
        """Queue one coded matvec on endpoint ``name`` for ``tenant``;
        returns a ``CodedFuture`` (the fleet's future type -- result /
        exception / cancel / add_done_callback / ``.report``).

        ``deadline`` covers queue wait AND the round; ``done`` replays
        an explicit straggler pattern (parity mode -- dispatched solo,
        never batched).  Batched race-mode calls only share a round
        with same-``deadline`` batchmates; the round budget is the
        earliest batchmate's remaining time.  A CUDA operand or mask is
        copied to the host here, on the caller's thread, so the
        scheduler thread never waits on the device."""
        if self._closed:
            raise RuntimeError("router has been closed")
        x = host_f32(x)
        if done is not None:
            done = host_mask(done)
        cols = 1 if x.ndim == 1 else int(x.shape[0])
        with self._cond:
            ep = self._ep(name)
            if self._closing:
                raise RuntimeError("router has been closed")
            cfg = self._tenants.setdefault(tenant, _TenantConfig(tenant))
            tq = ep.tenants.get(tenant)
            if tq is None:
                tq = ep.tenants[tenant] = _TenantQueue(cfg)
            admission = cfg.admission
        # admission OUTSIDE the condition: a blocked tenant must not
        # stall the scheduler or the other tenants' submissions
        if not tq.sem.acquire(blocking=admission != "shed"):
            with self._cond:
                tq.counters["shed"] += 1
            tr = self._tracer
            if tr is not None:
                tr.instant("router.shed", cat="router", track="router",
                           endpoint=name, tenant=tenant, cols=cols)
            raise FleetDegraded(
                f"tenant {tenant!r} queue on endpoint {name!r} is full "
                f"({cfg.queue_cap} queued calls); back off and resubmit, "
                f"or raise the tenant queue_cap", action="shed")
        if deadline is None:
            deadline = cfg.deadline
        now = time.perf_counter()
        fut = CodedFuture()
        rc = _RCall(x=x, cols=cols, done=done, deadline_s=deadline,
                    deadline_at=None if deadline is None
                    else now + deadline,
                    future=fut, tenant=tenant, t_enq=now)
        fut._canceller = functools.partial(self._cancel_rc, tq, rc)
        with self._cond:
            if self._closing or ep.draining:
                tq.sem.release()
                raise RuntimeError("router has been closed"
                                   if self._closing
                                   else f"endpoint {name!r} is draining")
            if not tq.queue:            # waking from idle: no stride debt
                tq.pass_v = max(tq.pass_v, ep.vtime)
            tq.queue.append(rc)
            tq.counters["submitted"] += 1
            self._cond.notify_all()
        return fut

    def call(self, name: str, x, **kw):
        """Blocking convenience: ``submit(...).result()``."""
        return self.submit(name, x, **kw).result()

    def _cancel_rc(self, tq: _TenantQueue, rc: _RCall, fut) -> bool:
        with self._cond:
            if rc.state != "queued" or rc not in tq.queue:
                return fut.cancelled()
            tq.queue.remove(rc)
            rc.state = "done"
            tq.counters["cancelled"] += 1
            tq.sem.release()
        fut._finish(cancelled=True)
        return True

    # -- the scheduler thread ----------------------------------------------

    def _run(self) -> None:
        stop = False
        while not stop:
            job = None
            finish = []                 # (rc-list, exc) outside the lock
            detach = []
            with self._cond:
                now = time.perf_counter()
                finish.extend(self._expire_locked(now))
                detach, self._pending_detach = self._pending_detach, []
                if self._closing:
                    if self._drained_locked():
                        stop = True
                    elif now >= self._close_deadline:
                        finish.extend(self._flush_locked(
                            RuntimeError("router closed")))
                        stop = True
                if not stop:
                    if self._paused:
                        job, wait_s = None, 0.05
                    else:
                        job, wait_s = self._pick_locked(now)
                    if job is None and not finish and not detach:
                        self._cond.wait(wait_s)
            for h in detach:
                try:
                    h.detach()
                except Exception:
                    pass
            for rcs, exc in finish:
                for rc in rcs:
                    rc.future._finish(exc=exc)
            if job is not None:
                self._dispatch(job)
        self._teardown()

    def _expire_locked(self, now: float):
        """Fail queued calls whose deadline elapsed while waiting --
        before dispatch, so a hopeless call never burns a round."""
        out = []
        for ep in self._endpoints.values():
            for tq in ep.tenants.values():
                expired = [c for c in tq.queue
                           if c.deadline_at is not None
                           and now >= c.deadline_at]
                if not expired:
                    continue
                for c in expired:
                    tq.queue.remove(c)
                    c.state = "done"
                    tq.counters["failed"] += 1
                    tq.counters["deadline_hit"] += 1
                    tq.sem.release()
                out.append((expired, TimeoutError(
                    f"deadline expired in router queue (tenant "
                    f"{tq.name!r}, endpoint {ep.name!r})")))
        return out

    def _flush_tq_locked(self, tq: _TenantQueue, exc):
        """Fail a tenant queue's still-queued calls: state flips,
        counters bump, and each admission slot is released -- a flushed
        call must leave no trace a blocked submitter could wait on."""
        if not tq.queue:
            return []
        drop = list(tq.queue)
        tq.queue.clear()
        for c in drop:
            c.state = "done"
            tq.counters["failed"] += 1
            tq.sem.release()
        return [(drop, exc)]

    def _flush_locked(self, exc):
        out = []
        for ep in self._endpoints.values():
            for tq in ep.tenants.values():
                out.extend(self._flush_tq_locked(tq, exc))
        return out

    def _drained_locked(self) -> bool:
        return all(not tq.queue
                   for ep in self._endpoints.values()
                   for tq in ep.tenants.values()) \
            and all(ep.outstanding() == 0
                    for ep in self._endpoints.values())

    def _pick_replica_locked(self, ep: _Endpoint) -> _Replica | None:
        live = [r for r in ep.replicas if not r.draining
                and not r.fleet._closed
                and r.total_outstanding() < r.fleet.max_inflight
                and r.free_calls() >= 1]
        if not live:
            return None
        if self.balancer == "round-robin":
            r = live[ep.rr % len(live)]
            ep.rr += 1
            return r
        return min(live, key=lambda r: (r.out_cols, r.index))

    def _pick_locked(self, now: float):
        """Choose the next batch to dispatch, or the time to wait."""
        wait_s = 0.05
        names = sorted(self._endpoints)
        if not names:
            return None, wait_s
        order = names[self._ep_cursor % len(names):] \
            + names[: self._ep_cursor % len(names)]
        for name in order:
            ep = self._endpoints[name]
            tqs = [tq for tq in ep.tenants.values() if tq.queue]
            if not tqs:
                continue
            replica = self._pick_replica_locked(ep)
            if replica is None:
                continue                # woken by a round completion
            total = sum(tq.queued_cols() for tq in tqs)
            oldest = min(tq.queue[0].t_enq for tq in tqs)
            tq = min(tqs, key=lambda t: (t.pass_v, t.name))
            head = tq.queue[0]
            urgent = head.deadline_at is not None and \
                head.deadline_at - now <= ep.batch_wait_s
            if not (total >= ep.width or head.done is not None
                    or now - oldest >= ep.batch_wait_s or urgent
                    or self._closing or ep.draining):
                remain = ep.batch_wait_s - (now - oldest)
                if head.deadline_at is not None:
                    remain = min(remain, head.deadline_at - now)
                wait_s = min(wait_s, max(remain, 1e-3))
                continue
            # the batch may not outgrow the replica's free admission
            # slots (1 call = 1 slot): the fleet submit then always
            # admits without blocking -- an unclamped batch wider than
            # queue_cap would park the scheduler thread in admission
            # forever, as only its own unsubmitted calls could free
            # the slots it waits for
            budget = replica.free_calls()
            batch = [tq.queue.popleft()]
            if head.done is None:
                cols = head.cols
                while (tq.queue and cols < ep.width
                       and len(batch) < budget
                       and tq.queue[0].done is None
                       and tq.queue[0].deadline_s == head.deadline_s):
                    nxt = tq.queue.popleft()
                    batch.append(nxt)
                    cols += nxt.cols
            cols = sum(c.cols for c in batch)
            tr = self._tracer
            if ep.adaptive:
                # queue-depth feedback on the backlog LEFT BEHIND by
                # this dispatch: double while a full round's worth
                # still queues, halve when it falls under a quarter.
                # The leftover (not the pre-pop depth) is the signal:
                # pre-pop depth asymptotes to the call width at low
                # load and can wedge w above it, re-introducing the
                # collection window this loop exists to remove.
                ep.depth_ewma = 0.5 * ep.depth_ewma + 0.5 * (total - cols)
                prev_w = ep.width
                if ep.depth_ewma >= ep.width and ep.width < ep.max_cols:
                    ep.width = min(ep.max_cols, ep.width * 2)
                elif (ep.depth_ewma <= ep.width / 4
                      and ep.width > ep.min_cols):
                    ep.width = max(ep.min_cols, ep.width // 2)
                if tr is not None and ep.width != prev_w:
                    tr.instant("router.width", cat="router",
                               track="router", endpoint=ep.name,
                               width=ep.width, prev=prev_w,
                               depth_ewma=ep.depth_ewma)
            tq.pass_v += cols / tq.cfg.weight
            ep.vtime = tq.pass_v
            handle = replica.handle
            replica.outstanding[handle] = \
                replica.outstanding.get(handle, 0) + 1
            replica.out_calls[handle] = \
                replica.out_calls.get(handle, 0) + len(batch)
            replica.out_cols += cols
            replica.dispatched += 1
            for c in batch:
                c.state = "dispatched"
                ep.inflight.add(c)
                tq.sem.release()        # admission bounds the queue
            tq.counters["dispatched"] += len(batch)
            tq.counters["dispatched_cols"] += cols
            # dual clocks, like the fleet event log: wall for humans,
            # monotonic for joining with tracer span timelines
            ep.log.append({"t": time.time(), "t_mono": now,
                           "endpoint": ep.name,
                           "tenant": tq.name, "calls": len(batch),
                           "cols": cols, "width": ep.width,
                           "replica": replica.index})
            if tr is not None:
                tr.instant("router.dispatch", cat="router",
                           track="router", endpoint=ep.name,
                           tenant=tq.name, calls=len(batch), cols=cols,
                           width=ep.width, replica=replica.index)
            self._ep_cursor = (names.index(name) + 1) % len(names)
            job = _Job(ep, tq, replica, handle, batch, cols,
                       remaining=len(batch))
            return job, 0.0
        return None, wait_s

    def _dispatch(self, job: _Job) -> None:
        """Hand one single-tenant batch to its replica fleet, outside
        the router condition.  Submission is non-blocking
        (``block=False``): the batch was clamped to the replica's free
        call budget at pick time, so admission always has room and the
        scheduler thread never parks inside a fleet -- one saturated
        endpoint cannot head-of-line-block every other endpoint and
        tenant.  A shed (impossible for router-owned handles; a defense
        against external budget drift) fails only this batch."""
        batch = job.batch
        now = time.perf_counter()
        dls = [c.deadline_at for c in batch if c.deadline_at is not None]
        deadline = None if not dls else max(min(dls) - now, 1e-3)
        try:
            if batch[0].done is not None:
                inners = [job.handle.submit_matvec(
                    batch[0].x, batch[0].done, deadline=deadline,
                    block=False)]
            elif len(batch) == 1:
                inners = [job.handle.submit_matvec(
                    batch[0].x, deadline=deadline, block=False)]
            else:
                inners = job.handle.submit_matvec_many(
                    [c.x for c in batch], deadline=deadline, block=False)
        except BaseException as e:  # noqa: BLE001 - scoped to this batch
            with self._cond:
                for c in batch:
                    c.state = "done"
                    job.ep.inflight.discard(c)
                job.tq.counters["failed"] += len(batch)
                self._uncount_calls_locked(job.replica, job.handle,
                                           len(batch))
                self._retire_locked(job)
                job.remaining = 0
                self._cond.notify_all()
            for c in batch:
                c.future._finish(exc=e)
            return
        for c, inner in zip(batch, inners):
            inner.add_done_callback(
                functools.partial(self._on_inner, job, c))

    def _uncount_calls_locked(self, r: _Replica, handle, n: int) -> None:
        """Return ``n`` fleet admission slots to the replica's call
        budget (one per resolved call -- mirrors the fleet releasing
        ``ps.sem`` per future)."""
        left = r.out_calls.get(handle, 0) - n
        if left > 0:
            r.out_calls[handle] = left
        else:
            r.out_calls.pop(handle, None)

    def _retire_locked(self, job: _Job) -> None:
        """Give back a batch's replica slot; queue the retiring handle
        for detach once its last round lands (never detach on the
        fleet loop thread -- detach round-trips through that loop)."""
        r = job.replica
        r.outstanding[job.handle] = r.outstanding.get(job.handle, 1) - 1
        r.out_cols -= job.cols
        job.cols = 0                    # only the first retire pays
        if r.outstanding[job.handle] == 0 and job.handle is not r.handle:
            r.outstanding.pop(job.handle, None)
            self._pending_detach.append(job.handle)

    def _on_inner(self, job: _Job, rc: _RCall, inner: CodedFuture) -> None:
        """Fleet-side resolution -> the routed future (loop thread)."""
        cancelled, exc, val = False, None, None
        try:
            val = inner.result(timeout=0)
        except BaseException as e:  # noqa: BLE001
            import concurrent.futures as cf  # noqa: PLC0415
            if isinstance(e, cf.CancelledError):
                cancelled = True
            else:
                exc = e
        rc.future.report = inner.report
        if cancelled:
            rc.future._finish(cancelled=True)
        elif exc is not None:
            rc.future._finish(exc=exc)
        else:
            rc.future._finish(value=val)
        with self._cond:
            rc.state = "done"
            job.ep.inflight.discard(rc)
            self._uncount_calls_locked(job.replica, job.handle, 1)
            tq = job.tq
            if cancelled:
                tq.counters["cancelled"] += 1
            elif exc is not None:
                tq.counters["failed"] += 1
                if isinstance(exc, TimeoutError):
                    tq.counters["deadline_hit"] += 1
            else:
                tq.counters["resolved"] += 1
            job.remaining -= 1
            if job.remaining == 0:
                self._retire_locked(job)
            self._cond.notify_all()

    # -- introspection ------------------------------------------------------

    def metrics(self) -> dict:
        """Structured snapshot: per-endpoint width/backlog, per-tenant
        queue + counters + stride pass, per-replica in-flight load."""
        with self._cond:
            eps = {}
            for name, ep in self._endpoints.items():
                eps[name] = {
                    "adaptive": ep.adaptive,
                    "width": ep.width,
                    "min_cols": ep.min_cols,
                    "max_cols": ep.max_cols,
                    "batch_wait_s": ep.batch_wait_s,
                    "depth_ewma": ep.depth_ewma,
                    "queued_cols": ep.queued_cols(),
                    "draining": ep.draining,
                    "tenants": {
                        tq.name: {"queued": len(tq.queue),
                                  "queued_cols": tq.queued_cols(),
                                  "weight": tq.cfg.weight,
                                  "pass": tq.pass_v,
                                  "counters": dict(tq.counters)}
                        for tq in ep.tenants.values()},
                    "replicas": [
                        {"index": r.index, "owned": r.owned,
                         "transport": r.fleet.transport_name,
                         "draining": r.draining,
                         # plan-state read, no fleet-loop round trip:
                         # the latency signal autoscaling SLO policies
                         # compare against their target
                         "lat_ewma_ms":
                             r.handle._ps.snapshot()["lat_ewma_ms"],
                         "outstanding_batches": r.total_outstanding(),
                         "outstanding_calls": sum(r.out_calls.values()),
                         "outstanding_cols": r.out_cols,
                         "queue_cap": r.fleet.queue_cap,
                         "free_calls": r.free_calls(),
                         "dispatched": r.dispatched}
                        for r in ep.replicas]}
            return {"balancer": self.balancer,
                    "paused": self._paused,
                    "closing": self._closing,
                    "tenants": {n: {"weight": c.weight,
                                    "queue_cap": c.queue_cap,
                                    "admission": c.admission}
                                for n, c in self._tenants.items()},
                    "endpoints": eps}

    def dispatch_log(self, name: str) -> list[dict]:
        """The endpoint's recent dispatch records (tenant, calls, cols,
        width, replica), bounded at 2048 and stamped on both clocks
        (``t`` wall, ``t_mono`` perf_counter -- same discipline as the
        fleet event log, so ``repro_torch.obs.export`` can merge the two
        timelines).  The fairness tests assert on this."""
        with self._cond:
            return list(self._ep(name).log)

    # -- test / operational control -----------------------------------------

    def pause(self) -> None:
        """Hold dispatching (submissions still queue) -- lets tests
        build a deterministic backlog before releasing it."""
        with self._cond:
            self._paused = True
            self._cond.notify_all()

    def resume(self) -> None:
        with self._cond:
            self._paused = False
            self._cond.notify_all()

    # -- shutdown -----------------------------------------------------------

    def unregister(self, name: str, *, timeout: float = 30.0) -> None:
        """Drain one endpoint out of the router: queued calls dispatch,
        in-flight rounds land, then handles detach and owned fleets
        close.  Other endpoints keep serving.  On drain timeout every
        leftover call -- still queued OR already in flight -- fails
        with the unregister error (queues are flushed for real: state,
        counters, and admission slots all settle) before the fleets
        close, so no caller observes a bare cancellation."""
        with self._cond:
            ep = self._endpoints.get(name)
            if ep is None:
                return
            ep.draining = True
            self._cond.notify_all()
            drained = self._cond.wait_for(
                lambda: all(not tq.queue for tq in ep.tenants.values())
                and ep.outstanding() == 0, timeout)
            del self._endpoints[name]
            finish = []
            if not drained:
                exc = RuntimeError(
                    f"endpoint {name!r} unregistered before its calls "
                    f"drained ({timeout}s timeout)")
                for tq in ep.tenants.values():
                    finish.extend(self._flush_tq_locked(tq, exc))
                # in-flight rounds: fail the routed futures first
                # (CodedFuture is first-wins) -- closing the owned
                # fleets below cancels the inner rounds, which must
                # not surface as cancellation to the caller
                finish.append((list(ep.inflight), exc))
                ep.inflight.clear()
        for rcs, exc in finish:
            for rc in rcs:
                rc.future._finish(exc=exc)
        self._close_endpoint(ep)

    def _close_endpoint(self, ep: _Endpoint) -> None:
        for r in ep.replicas:
            for h in {r.handle, *r.outstanding}:
                try:
                    h.detach()
                except Exception:
                    pass
            if r.owned:
                r.fleet.close()

    def close(self, *, drain: bool = True, timeout: float = 30.0) -> None:
        """Tear the router down: drain tenant queues (dispatch what is
        queued, wait for in-flight rounds; ``drain=False`` or deadline
        overrun fails leftovers instead), detach every endpoint, close
        owned replica fleets, stop the scheduler.  Idempotent and
        thread-safe."""
        with self._close_lock:
            if self._closed:
                return
            with self._cond:
                self._closing = True
                self._close_deadline = time.perf_counter() \
                    + (timeout if drain else 0.0)
                self._cond.notify_all()
            self._sched.join(timeout=timeout + 10.0)
            self._closed = True

    def _teardown(self) -> None:
        """Scheduler-exit cleanup (queues already drained/flushed)."""
        with self._cond:
            eps = list(self._endpoints.values())
            self._endpoints.clear()
            detach, self._pending_detach = self._pending_detach, []
            leftovers = self._flush_locked(RuntimeError("router closed"))
        for rcs, exc in leftovers:
            for rc in rcs:
                rc.future._finish(exc=exc)
        for h in detach:
            try:
                h.detach()
            except Exception:
                pass
        for ep in eps:
            self._close_endpoint(ep)

    def __enter__(self) -> "Router":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):  # pragma: no cover - gc-time safety net
        try:
            self.close(drain=False, timeout=1.0)
        except Exception:
            pass
