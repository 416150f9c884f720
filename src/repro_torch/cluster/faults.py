"""Fault injection as a *decorator* around any transport's serve path.

The paper's AWS experiments observe stragglers from heterogeneous t2
instances and network congestion; ``repro_torch.core.straggler`` models them
statistically (shifted-exponential, adversarial-slow).  This module
turns those *simulation* models into deterministic injectors, applied
by ``faulty(faults)`` -- a decorator every transport wraps around its
raw task-serve function (thread, pipe and tcp workers all call the
same wrapped function).  The live runtime's liveness protocol
(heartbeats, suspicion, requeue) never consults this module: faults
only *cause* behaviour (latency, fail-stop death, silent hangs) that
the dispatcher then *measures*, which is what keeps threaded CI runs
reproducibly as straggly as the model says while the measured
wall-clock stays real.

Two properties matter for reproducibility:

  * every worker draws from its **own** seeded stream (``seed ^ worker``),
    so OS thread scheduling cannot reorder the sample sequence;
  * delays scale with the task's reported ``work`` (nnz-proportional),
    which is exactly how sparsity preservation becomes wall-clock gain.

``FailStop`` layers deterministic worker death on top of any latency
model (the dispatcher's requeue path is tested against it); ``Hang``
makes a worker go *silent* -- it stops serving AND stops heartbeating
without closing its connection, the one failure mode only the
heartbeat-timeout path can catch.  All injectors round-trip through
``to_spec()`` / ``from_spec()`` (plain json-able dicts) so subprocess
and socket workers can reconstruct them on the far side of a pipe
without pickling code objects.

In the port the serve engine's per-step straggler mask is the caller
so far; the transports that wrap ``faulty`` come with the cluster
layer.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

from ..core.straggler import AdversarialSlow, ShiftedExponential


class WorkerFailure(RuntimeError):
    """Raised inside a worker loop by a fail-stop injector."""


class WorkerHang(RuntimeError):
    """Raised by a ``Hang`` injector: the worker goes silent (no result,
    no death notice, no further heartbeats) but keeps its connection
    open -- detectable only via heartbeat timeout."""


def faulty(faults):
    """Decorator wrapping a transport's raw serve function with
    deterministic fault injection.

    ``serve(worker_id, task, tasks_done) -> TaskResult`` becomes: check
    fail-stop (raise ``WorkerFailure``), check hang (raise
    ``WorkerHang``), compute, then sleep the injected latency (scaled
    by the task's nnz-proportional ``work``).  Every transport applies
    this identically, so a deterministic test behaves the same over
    threads, pipes, or sockets.
    """
    should_hang = getattr(faults, "should_hang", None)

    def deco(serve_fn):
        def wrapped(worker_id: int, task, tasks_done: int):
            if faults.should_fail(worker_id, tasks_done):
                raise WorkerFailure(f"worker {worker_id} fail-stop injected")
            if should_hang is not None and should_hang(worker_id, tasks_done):
                raise WorkerHang(f"worker {worker_id} hang injected")
            result = serve_fn(worker_id, task, tasks_done)
            delay = faults.delay(worker_id, task.task_row, result.work)
            if delay > 0:
                time.sleep(delay)
            return result
        return wrapped

    return deco


def straggler_mask(n: int, s: int, rng: np.random.Generator,
                   model=None) -> np.ndarray:
    """Done mask with the fastest ``n - s`` workers under ``model``.

    The single source of per-step straggler sampling: the serve engine's
    per-token mask and the cluster bench both route through here, so
    "which workers straggle" means the same thing in both.
    """
    model = model if model is not None else ShiftedExponential()
    times = model.sample(np.ones(n), rng)
    done = np.zeros(n, bool)
    done[np.argsort(times, kind="stable")[: n - s]] = True
    return done


_SPECS: dict[str, type] = {}


def _register(cls):
    _SPECS[cls.__name__] = cls
    return cls


def from_spec(spec: dict | None):
    """Reconstruct an injector from ``to_spec()`` output (None -> NoFaults)."""
    if spec is None:
        return NoFaults()
    kind = spec.get("kind")
    if kind not in _SPECS:
        raise ValueError(f"unknown fault spec kind {kind!r}; "
                         f"known: {sorted(_SPECS)}")
    return _SPECS[kind]._from_spec(spec)


@_register
@dataclass
class NoFaults:
    """Injector that never delays and never kills."""

    def delay(self, worker: int, task_row: int, work: float) -> float:
        return 0.0

    def should_fail(self, worker: int, tasks_done: int) -> bool:
        return False

    def mask(self, n: int, s: int) -> np.ndarray:
        return np.ones(n, bool)

    def to_spec(self) -> dict:
        return {"kind": "NoFaults"}

    @classmethod
    def _from_spec(cls, spec: dict) -> "NoFaults":
        return cls()


@_register
@dataclass
class StragglerFaults:
    """Latency injection from a ``repro_torch.core.straggler`` model.

    ``delay(worker, task, work)`` samples the model's completion time
    for ``work`` units and scales it by ``time_scale`` seconds/unit.
    ``shift * work`` models the deterministic compute share and the
    exponential tail the contention share, so a dense worker (high
    work) both starts later and tails worse -- the paper's regime.

    Pass ``rng=`` to share a caller-owned stream (the serve engine's
    step rng); otherwise each worker id gets an independent
    ``default_rng(seed ^ worker)`` stream so threaded runs replay.
    """

    model: object = field(default_factory=ShiftedExponential)
    time_scale: float = 1e-3
    seed: int = 0
    rng: np.random.Generator | None = None
    _streams: dict = field(default_factory=dict, repr=False)

    def _stream(self, worker: int) -> np.random.Generator:
        if self.rng is not None:
            return self.rng
        if worker not in self._streams:
            self._streams[worker] = np.random.default_rng(
                (self.seed << 16) ^ (worker + 1))
        return self._streams[worker]

    def delay(self, worker: int, task_row: int, work: float) -> float:
        work = max(work, 1e-9)
        m = self.model
        if isinstance(m, AdversarialSlow):
            # the model indexes its work vector by worker id; per-task
            # injection has only THIS worker's work, so apply the
            # (deterministic) slowdown directly instead of sampling
            scale = m.slowdown if worker in m.stragglers else 1.0
            return work * scale * self.time_scale
        t = m.sample(np.asarray([work]), self._stream(worker))
        return float(t[0]) * self.time_scale

    def should_fail(self, worker: int, tasks_done: int) -> bool:
        return False

    def mask(self, n: int, s: int) -> np.ndarray:
        return straggler_mask(n, s, self._stream(-1), self.model)

    def to_spec(self) -> dict:
        m = self.model
        if isinstance(m, ShiftedExponential):
            ms = {"model": "shifted-exp", "shift": m.shift, "rate": m.rate}
        elif isinstance(m, AdversarialSlow):
            ms = {"model": "adversarial", "stragglers": list(m.stragglers),
                  "slowdown": m.slowdown}
        else:
            raise ValueError(f"cannot spec model {type(m).__name__}; use a "
                             "core.straggler model for process workers")
        return {"kind": "StragglerFaults", "time_scale": self.time_scale,
                "seed": self.seed, **ms}

    @classmethod
    def _from_spec(cls, spec: dict) -> "StragglerFaults":
        if spec["model"] == "shifted-exp":
            model = ShiftedExponential(shift=spec["shift"], rate=spec["rate"])
        else:
            model = AdversarialSlow(stragglers=tuple(spec["stragglers"]),
                                    slowdown=spec["slowdown"])
        return cls(model=model, time_scale=spec["time_scale"],
                   seed=spec["seed"])


def adversarial_faults(stragglers, slowdown: float = 10.0,
                       time_scale: float = 1e-3, seed: int = 0
                       ) -> StragglerFaults:
    """A fixed straggler set, ``slowdown``x slower (deterministic)."""
    return StragglerFaults(
        model=AdversarialSlow(stragglers=tuple(stragglers),
                              slowdown=slowdown),
        time_scale=time_scale, seed=seed)


@_register
@dataclass
class FailStop:
    """Worker death injection: ``fail_after[w]`` = tasks worker ``w``
    completes before dying (0 = dies on first task).  Latency delegates
    to ``base`` so death can ride on top of straggly runs."""

    fail_after: dict
    base: object = field(default_factory=NoFaults)

    def delay(self, worker: int, task_row: int, work: float) -> float:
        return self.base.delay(worker, task_row, work)

    def should_fail(self, worker: int, tasks_done: int) -> bool:
        limit = self.fail_after.get(worker)
        return limit is not None and tasks_done >= limit

    def mask(self, n: int, s: int) -> np.ndarray:
        done = self.base.mask(n, s)
        done[[w for w in self.fail_after if 0 <= w < n]] = False
        return done

    def to_spec(self) -> dict:
        return {"kind": "FailStop",
                "fail_after": {str(k): int(v)
                               for k, v in self.fail_after.items()},
                "base": self.base.to_spec()}

    @classmethod
    def _from_spec(cls, spec: dict) -> "FailStop":
        return cls(fail_after={int(k): v
                               for k, v in spec["fail_after"].items()},
                   base=from_spec(spec["base"]))


@_register
@dataclass
class ScriptedFaults:
    """Wall-clock-scripted fault windows: the chaos harness's injector.

    Each window is a plain dict ``{"kind", "worker", "t0", "t1"?,
    ...}`` with times in seconds *relative to a shared epoch*
    (``time.time()``-based, so subprocess and socket workers agree on
    when a window opens without any cross-process clock plumbing):

      * ``kill``      -- fail-stop while ``t0 <= now < t1`` (death
        notice on the next served task; a worker respawned after the
        window serves normally -- the reconnect scenario);
      * ``hang``      -- go silent while the window is open: no result,
        no beats, connection held (heartbeat-timeout territory);
      * ``slow``      -- add ``delay_s`` seconds to every task served
        inside the window (a transient straggler);
      * ``partition`` -- unreachable for the window: heartbeats are
        muted (``should_mute``) and any task served inside the window
        is held back until the window heals -- from the dispatcher's
        side the worker is suspected, then comes back.

    Latency composition delegates to ``base`` (so chaos can ride on a
    straggler model); ``to_spec``/``from_spec`` round-trip the whole
    schedule, epoch included, for pipe/tcp worker children.
    """

    windows: list = field(default_factory=list)
    epoch: float = 0.0
    base: object = field(default_factory=NoFaults)

    def _now(self) -> float:
        return time.time() - self.epoch

    def _open(self, kind: str, worker: int, now: float | None = None):
        now = self._now() if now is None else now
        for win in self.windows:
            if win["kind"] != kind or win["worker"] != worker:
                continue
            if win["t0"] <= now < win.get("t1", float("inf")):
                yield win

    def should_fail(self, worker: int, tasks_done: int) -> bool:
        if self.base.should_fail(worker, tasks_done):
            return True
        return any(True for _ in self._open("kill", worker))

    def should_hang(self, worker: int, tasks_done: int) -> bool:
        return any(True for _ in self._open("hang", worker))

    def should_mute(self, worker: int) -> bool:
        """Heartbeat mute hook (``start_heartbeat``): beats are dropped
        while a partition window is open for this worker."""
        return any(True for _ in self._open("partition", worker))

    def delay(self, worker: int, task_row: int, work: float) -> float:
        d = self.base.delay(worker, task_row, work)
        now = self._now()
        for win in self._open("slow", worker, now):
            d += float(win.get("delay_s", 0.05))
        for win in self._open("partition", worker, now):
            # results cross the partition only once it heals
            d = max(d, win.get("t1", now) - now)
        return d

    def mask(self, n: int, s: int) -> np.ndarray:
        return self.base.mask(n, s)

    def to_spec(self) -> dict:
        return {"kind": "ScriptedFaults",
                "windows": [dict(w) for w in self.windows],
                "epoch": float(self.epoch), "base": self.base.to_spec()}

    @classmethod
    def _from_spec(cls, spec: dict) -> "ScriptedFaults":
        return cls(windows=[dict(w) for w in spec["windows"]],
                   epoch=spec["epoch"], base=from_spec(spec["base"]))


@_register
@dataclass
class Hang:
    """Silent-worker injection: ``hang_after[w]`` = tasks worker ``w``
    completes before going mute (0 = hangs on first task).  Unlike
    ``FailStop`` there is no death notice and no connection close --
    the dispatcher can only notice via missed heartbeats, which is
    exactly the sequencing (timeout -> suspected -> requeue) the
    liveness tests pin down.  Latency delegates to ``base``."""

    hang_after: dict
    base: object = field(default_factory=NoFaults)

    def delay(self, worker: int, task_row: int, work: float) -> float:
        return self.base.delay(worker, task_row, work)

    def should_fail(self, worker: int, tasks_done: int) -> bool:
        return self.base.should_fail(worker, tasks_done)

    def should_hang(self, worker: int, tasks_done: int) -> bool:
        limit = self.hang_after.get(worker)
        return limit is not None and tasks_done >= limit

    def mask(self, n: int, s: int) -> np.ndarray:
        done = self.base.mask(n, s)
        done[[w for w in self.hang_after if 0 <= w < n]] = False
        return done

    def to_spec(self) -> dict:
        return {"kind": "Hang",
                "hang_after": {str(k): int(v)
                               for k, v in self.hang_after.items()},
                "base": self.base.to_spec()}

    @classmethod
    def _from_spec(cls, spec: dict) -> "Hang":
        return cls(hang_after={int(k): v
                               for k, v in spec["hang_after"].items()},
                   base=from_spec(spec["base"]))
