"""Deterministic chaos harness: scripted fault schedules against a
*live* fleet, with parity and liveness assertions (the port of
``repro.cluster.chaos``; the fleet's workers run on the card unless the
caller asks for the CPU).

The cluster stack claims three robustness properties the unit tests can
only probe one at a time:

  1. **correctness under faults** -- any round that resolves while at
     most ``s`` workers are concurrently faulty decodes *bitwise
     identically* to the in-process plan under the round's observed
     pattern (the repo's established parity oracle), and numerically
     matches the fault-free reference;
  2. **graceful degradation** -- past ``s`` concurrent failures the
     fleet re-encodes at reduced resilience (fresh plan id, ``k``
     preserved) or fails fast with a structured ``FleetDegraded``;
     resolved-degraded values still match the reference;
  3. **no hangs** -- every submitted future resolves (value or error)
     within a bounded wall-clock, whatever the schedule throws.

``run_chaos`` drives all three at once: it builds a seeded schedule of
fault events (kill, hang, slow, partition, garbled frame, graceful
leave, live join, reconnect), splits it into *worker-side* windows
(executed deterministically inside the workers via ``ScriptedFaults``,
sharing one wall-clock epoch across processes) and *controller-side*
actions (driven from a timer thread: ``transport.garble``,
``fleet.add_worker``, ``fleet.remove_worker``), then submits a steady
stream of matvec calls through the storm and classifies every future:

  * ``clean``    -- resolved on the original encoding with no deaths,
    suspicions, requeues or deadline in its round;
  * ``degraded`` -- resolved correctly but the round saw recovery work
    (re-homed rows, a re-encoded plan, requeues);
  * ``failed``   -- resolved with a structured error (``FleetDegraded``
    / deadline), never a hang.

Determinism: the schedule is a pure function of the seed, worker-side
windows replay exactly (``ScriptedFaults`` round-trips through wire
specs to subprocess/socket children), and every assertion is
*invariant-based* -- which rounds a fault lands on may shift with
scheduler noise, but clean rounds must be bitwise-replayable and no
future may hang, at every seed.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

import numpy as np

import torch

from .._device import resolve_device
from .faults import ScriptedFaults
from .fleet import CodedFleet, FleetDegraded

#: fault kinds executed inside the workers as wall-clock windows
WINDOW_KINDS = ("kill", "hang", "slow", "partition")
#: fault kinds driven from the controller thread at their start time
ACTION_KINDS = ("garble", "leave", "join", "reconnect")
#: kinds that count toward the concurrent-failure budget ``s`` (a
#: ``slow`` worker still completes; a ``join`` only adds capacity)
FAILURE_KINDS = ("kill", "hang", "partition", "garble", "leave")


@dataclass
class ChaosEvent:
    """One scheduled fault: ``kind`` at ``t0`` seconds after the epoch,
    against ``worker`` (ignored for ``join``), window-shaped kinds
    ending at ``t1``."""

    kind: str
    t0: float
    worker: int = -1
    t1: float | None = None
    delay_s: float = 0.1        # slow only

    def window(self) -> dict:
        w = {"kind": self.kind, "worker": self.worker, "t0": self.t0}
        if self.t1 is not None:
            w["t1"] = self.t1
        if self.kind == "slow":
            w["delay_s"] = self.delay_s
        return w


def scripted_schedule(seed: int, n: int, s: int, duration: float = 3.0,
                      kinds=WINDOW_KINDS + ACTION_KINDS,
                      n_events: int | None = None,
                      budget: int | None = None) -> list[ChaosEvent]:
    """A seeded, reproducible fault schedule over ``duration`` seconds.

    Events are spread over distinct workers and staggered so no more
    than ``budget`` (default ``s``) failure-kind events overlap -- the
    "within the resilience budget" regime; pass ``budget > s`` to
    script the degradation regime instead.
    """
    rng = np.random.default_rng(seed)
    budget = s if budget is None else budget
    n_events = max(2, int(duration)) if n_events is None else n_events
    events: list[ChaosEvent] = []
    active: list[tuple[float, float, int]] = []      # (t0, t1, worker)
    for i in range(n_events):
        kind = kinds[int(rng.integers(len(kinds)))]
        t0 = float(rng.uniform(0.15, duration))
        t1 = min(float(t0 + rng.uniform(0.3, 0.9)), duration + 1.0)
        if kind == "join":
            events.append(ChaosEvent(kind="join", t0=t0))
            continue
        # the interval this event would count as faulty -- matching
        # ``max_concurrent_failures``: kill/garble fell the worker until
        # the scripted reconnect at t1 + 0.2, a graceful leave counts
        # as its (bounded) drain, hang/partition as their window
        if kind in ("kill", "garble"):
            tf = t1 + 0.2
        elif kind == "leave":
            tf = t0 + 1.0
        else:
            tf = t1
        overlapping = {w for (a, b, w) in active if a < tf and t0 < b}
        free = [w for w in range(n) if w not in {w for *_, w in active}]
        if kind in FAILURE_KINDS and len(overlapping) >= budget:
            kind = "slow"                        # budget full: degrade
        if not free:
            continue
        worker = int(free[int(rng.integers(len(free)))])
        if kind in FAILURE_KINDS:
            active.append((t0, tf, worker))
        events.append(ChaosEvent(
            kind=kind, t0=t0, worker=worker,
            t1=t1 if kind in WINDOW_KINDS else None,
            delay_s=float(rng.uniform(0.05, 0.2))))
        if kind in ("kill", "garble"):
            # scripted recovery: the felled worker reconnects later
            events.append(ChaosEvent(kind="reconnect", worker=worker,
                                     t0=t1 + 0.2))
    return sorted(events, key=lambda e: e.t0)


def max_concurrent_failures(schedule: list[ChaosEvent]) -> int:
    """Peak number of simultaneously-faulty workers the schedule
    scripts (the quantity compared against ``s``).  A kill or garble
    fells its worker until the next scripted reconnect (forever if none
    is scripted -- fail-stop is permanent); hang/partition count for
    their window; a graceful leave counts as a bounded drain; a
    worker's overlapping events count once."""
    edges: list[tuple[float, float, int]] = []
    for ev in schedule:
        if ev.kind not in FAILURE_KINDS:
            continue
        if ev.kind in ("kill", "garble"):
            recon = [e.t0 for e in schedule
                     if e.kind == "reconnect" and e.worker == ev.worker
                     and e.t0 > ev.t0]
            t1 = min(recon) if recon else ev.t0 + 1e9
        elif ev.t1 is not None:
            t1 = ev.t1
        else:               # leave: faulty only through its drain
            t1 = ev.t0 + 1.0
        edges.append((ev.t0, t1, ev.worker))
    peak = 0
    for t0, _, _ in edges:
        live = {w for (a, b, w) in edges if a <= t0 < b}
        peak = max(peak, len(live))
    return peak


@dataclass
class CallOutcome:
    """One submitted call's fate."""

    index: int
    outcome: str                # clean | degraded | failed
    t_submit: float
    t_done: float
    plan_id: int | None = None
    error: str | None = None
    bitwise: bool | None = None     # parity vs local replay
    correct: bool | None = None     # allclose vs fault-free reference


@dataclass
class ChaosResult:
    """What one chaos run observed (the bench serializes this)."""

    transport: str
    seed: int
    n: int
    s: int
    max_concurrent: int
    outcomes: list[CallOutcome] = field(default_factory=list)
    events: list[dict] = field(default_factory=list)    # fleet.event_log
    schedule: list[dict] = field(default_factory=list)
    joiner_serving: bool | None = None
    final_plan: dict = field(default_factory=dict)
    # decision log of the autoscaling controller, when one ran
    # alongside the schedule (run_chaos(autoscale=...))
    autoscale: list = field(default_factory=list)

    def counts(self) -> dict:
        c = {"clean": 0, "degraded": 0, "failed": 0}
        for o in self.outcomes:
            c[o.outcome] += 1
        return c

    def recovery_latency(self) -> dict:
        """Per fault kind: seconds from each fault's start until the
        first call *submitted at or after it* resolved with a value
        (the operator-visible outage per fault)."""
        resolved = sorted((o.t_submit, o.t_done) for o in self.outcomes
                          if o.outcome in ("clean", "degraded"))
        out: dict[str, list[float]] = {}
        for ev in self.schedule:
            if ev["kind"] not in FAILURE_KINDS:
                continue
            nxt = [t_done for t_sub, t_done in resolved
                   if t_sub >= ev["t0"]]
            if nxt:
                out.setdefault(ev["kind"], []).append(
                    min(nxt) - ev["t0"])
        return out

    def as_dict(self) -> dict:
        lat = {k: {"p50_s": float(np.percentile(v, 50)),
                   "p99_s": float(np.percentile(v, 99)),
                   "n": len(v)}
               for k, v in self.recovery_latency().items()}
        return {"transport": self.transport, "seed": self.seed,
                "n": self.n, "s": self.s,
                "max_concurrent_failures": self.max_concurrent,
                "futures": self.counts(),
                "recovery_latency": lat,
                "joiner_serving": self.joiner_serving,
                "final_plan": self.final_plan,
                "fleet_events": [e["kind"] for e in self.events]}


def _controller(fleet: CodedFleet, schedule: list[ChaosEvent],
                epoch: float, stop: threading.Event,
                log: list) -> None:
    """Timer thread: fire controller-side actions at their scripted
    times (worker-side windows run inside the workers)."""
    for ev in schedule:
        if ev.kind not in ACTION_KINDS:
            continue
        delay = epoch + ev.t0 - time.time()
        if delay > 0 and stop.wait(delay):
            return
        try:
            if ev.kind == "garble":
                fleet.transport.garble(ev.worker)
            elif ev.kind == "leave":
                fleet.remove_worker(ev.worker, drain=True, timeout=2.0)
            elif ev.kind == "join":
                log.append(fleet.add_worker(timeout=90.0))
            elif ev.kind == "reconnect":
                if not fleet.transport.alive(ev.worker):
                    log.append(fleet.add_worker(ev.worker, timeout=90.0))
        except (RuntimeError, ValueError) as e:
            # an action can race the fleet's own recovery (the target
            # already died / already rejoined): chaos proceeds, the
            # invariant checks still hold
            log.append(f"{ev.kind}@{ev.worker}: {e!r}")


def run_chaos(schedule: list[ChaosEvent], *, transport: str = "memory",
              n: int = 6, s: int = 2, t: int = 768, r: int = 512,
              seed: int = 0, calls: int = 24, spacing_s: float = 0.1,
              warmup_s: float = 2.0, result_timeout_s: float = 60.0,
              heartbeat_s: float = 0.1, suspect_after: float = 0.6,
              min_workers: int = 1, settle_s: float = 0.5,
              verify: bool = True, autoscale: dict | None = None,
              device=None) -> ChaosResult:
    """Run one scripted chaos schedule against a live fleet.

    Builds an ``(n, s)`` proposed-scheme plan over a seeded sparse
    operand, attaches it, fires the schedule, and submits ``calls``
    sequential matvecs spaced ``spacing_s`` apart (each one blocking
    with a hard ``result_timeout_s`` -- a timeout is a harness
    *failure*, the no-hang invariant).  With ``verify=True`` every
    resolved value is checked bitwise against the local replay of its
    round's observed pattern (on the exact plan version that served
    it) and numerically against the fault-free reference; violations
    raise ``AssertionError``.

    ``device`` (default the card) is where the plan lives and what the
    workers compute on: card workers (``bcsr_matmul``) on a CUDA
    device, host BSR workers on the CPU; the replay runs on the same
    plan, so "bitwise" compares like with like.

    ``autoscale`` (kwargs for ``repro_torch.scale.Autoscaler``) starts
    an autoscaling controller against the fleet for the duration of the
    schedule, so scripted faults and scaling decisions interleave -- a
    kill can land mid scale-up, a join mid drain -- and the invariants
    above must *still* hold.  The workers it adds compute where the
    fleet's do.  The controller's decision log lands on
    ``result.autoscale``.
    """
    from ..api import compile_plan  # noqa: PLC0415 - avoid cycle at import

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    mask = rng.random((t // 8, r // 8)) >= 0.9
    A = (rng.standard_normal((t, r)) *
         np.kron(mask, np.ones((8, 8)))).astype(np.float32)
    xs = [torch.from_numpy(rng.standard_normal(t).astype(np.float32))
          for _ in range(calls)]
    plan = compile_plan(torch.from_numpy(A), scheme="proposed", n=n, s=s,
                        backend="cuda" if dev.type == "cuda" else "packed",
                        device=dev)
    refs = [plan.matvec(x).cpu() for x in xs]          # fault-free truth

    # one shared epoch: worker-side windows and the controller agree on
    # when each fault opens, across threads, pipes and sockets
    epoch = time.time() + warmup_s
    faults = ScriptedFaults(
        windows=[ev.window() for ev in schedule
                 if ev.kind in WINDOW_KINDS],
        epoch=epoch)
    result = ChaosResult(transport=transport, seed=seed, n=n, s=s,
                         max_concurrent=max_concurrent_failures(schedule),
                         schedule=[ev.window() for ev in schedule])
    stop = threading.Event()
    joined: list = []
    fleet = CodedFleet(n, transport=transport, faults=faults,
                       heartbeat_s=heartbeat_s,
                       suspect_after=suspect_after,
                       max_inflight=1, microbatch=False,
                       min_workers=min_workers, device=dev)
    scaler = None
    try:
        handle = fleet.attach(plan)
        original_pid = handle.plan_id
        handle.matvec(xs[0])                # warm the task tables
        if autoscale is not None:
            from ..scale import Autoscaler  # noqa: PLC0415 - avoid cycle
            scaler = Autoscaler(fleet, **autoscale).start()
        ctl = threading.Thread(
            target=_controller, args=(fleet, schedule, epoch, stop, joined),
            name="chaos-controller", daemon=True)
        ctl.start()
        while time.time() < epoch:          # schedule starts at epoch
            time.sleep(0.01)

        n_reports0 = len(handle.reports)
        for i in range(calls):
            target = epoch + i * spacing_s
            delay = target - time.time()
            if delay > 0:
                time.sleep(delay)
            t_sub = time.time() - epoch
            try:
                fut = handle.submit_matvec(xs[i])
                val = fut.result(timeout=result_timeout_s).cpu()
            except TimeoutError:
                raise AssertionError(
                    f"no-hang invariant violated: call {i} did not "
                    f"resolve within {result_timeout_s}s") from None
            except (FleetDegraded, RuntimeError) as e:
                result.outcomes.append(CallOutcome(
                    index=i, outcome="failed", t_submit=t_sub,
                    t_done=time.time() - epoch, error=repr(e)))
                continue
            # max_inflight=1 + solo rounds: this call's report is the
            # one appended since the last resolution (reports append
            # strictly before futures finish)
            rep = handle.reports[-1]
            clean = (rep.plan_id == original_pid and rep.deaths == 0
                     and rep.suspected == 0 and rep.requeues == 0
                     and not rep.deadline_hit)
            bitwise = correct = None
            if verify:
                served = handle.plan_version(rep.plan_id)
                want = served.matvec(xs[i], rep.pattern).cpu()
                bitwise = bool(torch.equal(val, want))
                correct = bool(torch.allclose(val, refs[i], atol=1e-3,
                                              rtol=1e-3))
                assert bitwise, (
                    f"call {i}: decode is not bitwise the local replay "
                    f"of its observed pattern (plan {rep.plan_id})")
                assert correct, (
                    f"call {i}: resolved value diverged from the "
                    f"fault-free reference")
            result.outcomes.append(CallOutcome(
                index=i, outcome="clean" if clean else "degraded",
                t_submit=t_sub, t_done=time.time() - epoch,
                plan_id=rep.plan_id, bitwise=bitwise, correct=correct))
        assert len(handle.reports) - n_reports0 >= 1
        # let the tail of the schedule land (a reconnect after the last
        # call, a deferred re-encode) before reading the final state
        t_end = max([ev.t1 or ev.t0 for ev in schedule] + [0.0]) + settle_s
        while time.time() - epoch < t_end:
            time.sleep(0.02)
        # ... and wait (bounded) for the fleet's re-encode fixed point:
        # the last re-encode's compile can outlast the schedule on a
        # loaded machine, and final_plan must reflect the live roster

        def _settled() -> bool:
            live = len(fleet._live())
            return not fleet._rounds and all(
                not ps.pending_reencode
                and (getattr(ps.plan, "executor", None) is None
                     or getattr(ps.plan, "_A", None) is None
                     or ps.n_shards == max(1, min(live, ps.max_shards)))
                for ps in fleet._plans.values())

        deadline = time.time() + 15.0
        while time.time() < deadline and not _settled():
            time.sleep(0.05)
        # a scripted joiner must end up serving the attached plan
        join_ids = [j for j in joined if isinstance(j, int)]
        if join_ids:
            result.joiner_serving = any(
                any(True for _ in fleet._held.get(j, ()))
                or any(o == j for ps in fleet._plans.values()
                       for o in ps.owner.values())
                for j in join_ids)
        result.final_plan = {"plan_id": handle.plan_id,
                             "n": handle.plan.n, "k": handle.plan.k,
                             "s": handle.plan.s}
        result.events = list(fleet.event_log)
    finally:
        stop.set()
        if scaler is not None:
            scaler.close()
            result.autoscale = scaler.decision_log()
        fleet.close()
    if verify:
        c = result.counts()
        assert c["clean"] + c["degraded"] + c["failed"] == calls
        if result.max_concurrent <= s and c["failed"] > 0:
            bad = [o.error for o in result.outcomes
                   if o.outcome == "failed"]
            raise AssertionError(
                f"schedule stayed within the resilience budget "
                f"(<= {s} concurrent failures) yet {c['failed']} "
                f"futures failed: {bad}")
    return result
