"""In-process transport: one serve thread + one heartbeat thread per
worker, events delivered as Python objects (the port of
``repro.cluster.transport.memory``).  Card workers (``backend="cuda"``)
share this process's CUDA context and launch ``bcsr_matmul`` from their
serve threads.

This is the deterministic CI/bench path (the old ``ThreadWorker``
backend, re-expressed over the shared worker core).  Nothing is
serialized on the hot path -- tasks cross as objects -- but shard
blobs still travel as wire bytes (so the codec is exercised) and
``submit`` reports ``Task.nbytes()``, the exact encoded size, so
bytes-on-wire accounting matches the socket transports.

Membership is dynamic (wire v4): ``add_worker`` spins up a fresh
serve + beat thread pair mid-run (and revives a dead id for the
reconnect scenario), ``remove_worker`` drains one worker's threads
without a death notice, and ``garble`` feeds a worker a corrupt frame
-- the serve loop answers with a death notice instead of computing
from a bad state, exactly like the socket transports' digest checks.
"""

from __future__ import annotations

import queue
import threading

from ..wire import Task, WorkerJoin
from ..worker import prepare_device, serve_loop, start_heartbeat
from .base import Transport


class MemoryTransport(Transport):
    name = "memory"

    def __init__(self, n_workers: int, *, faults=None,
                 heartbeat_s: float = 0.25, device=None,
                 backend: str = "packed"):
        super().__init__(n_workers, faults=faults, heartbeat_s=heartbeat_s,
                         device=device, backend=backend)
        self._inboxes: dict[int, queue.Queue] = {}
        self._threads: dict[int, threading.Thread] = {}
        self._beat_stops: dict[int, threading.Event] = {}
        self._beats: dict[int, threading.Thread] = {}

    def _spawn(self, w: int) -> None:
        inbox: queue.Queue = queue.Queue()
        self._inboxes[w] = inbox
        stop_beats = threading.Event()
        self._beat_stops[w] = stop_beats

        def run(wid=w, box=inbox, sb=stop_beats):
            status = serve_loop(wid, box, self.push_event, self.faults,
                                stop_beats=sb, device=self.device,
                                backend=self.backend)
            if status == "death":
                self.mark_dead(wid)

        t = threading.Thread(target=run, name=f"cluster-worker-{w}",
                             daemon=True)
        t.start()
        self._threads[w] = t
        self._beats[w] = start_heartbeat(
            w, self.push_event, self.heartbeat_s, stop_beats,
            mute=getattr(self.faults, "should_mute", None))

    def start(self, shard_blobs: list[bytes] | None = None) -> int:
        """Spawn the worker set; ship initial shards when given (a fleet
        starts bare and ships per ``attach``)."""
        prepare_device(self.device, self.backend)
        for w in sorted(self._known):
            self._spawn(w)
        return sum(self.ship_shard(w, blob)
                   for w, blob in enumerate(shard_blobs or []))

    def ship_shard(self, worker: int, blob: bytes) -> int:
        self._inboxes[worker].put(("shard", blob))
        return len(blob)

    def submit(self, worker: int, task: Task) -> int:
        self._inboxes[worker].put(("task", task))
        return task.nbytes()

    def cancel(self, worker: int, round_id: int) -> None:
        self._inboxes[worker].put(("cancel", round_id))

    def drop_plan(self, worker: int, plan_id: int) -> None:
        inbox = self._inboxes.get(worker)
        if inbox is not None:
            inbox.put(("drop", plan_id))

    def confirm_join(self, worker: int, plans: int = 0) -> None:
        inbox = self._inboxes.get(worker)
        if inbox is not None:
            inbox.put(("welcome", plans))

    # -- dynamic membership (wire v4) ---------------------------------------

    def add_worker(self, worker: int | None = None) -> int:
        w = self.next_worker_id() if worker is None else int(worker)
        if self.alive(w) and self._threads[w].is_alive():
            raise ValueError(f"worker {w} is already serving")
        self._stop_one(w)               # reap a dead predecessor, if any
        self._known.add(w)
        self.revive(w)
        self._spawn(w)
        self.push_event(WorkerJoin(worker=w))
        return w

    def _stop_one(self, w: int, timeout: float = 2.0) -> None:
        stop = self._beat_stops.pop(w, None)
        if stop is not None:
            stop.set()
        inbox = self._inboxes.pop(w, None)
        if inbox is not None:
            inbox.put(("stop", None))
        for table in (self._threads, self._beats):
            t = table.pop(w, None)
            if t is not None:
                t.join(timeout=timeout)

    def remove_worker(self, worker: int) -> None:
        self.mark_dead(worker)          # no death notice: graceful leave
        self._known.discard(worker)
        self._stop_one(worker)

    def garble(self, worker: int) -> int:
        blob = b"\x00garbled-frame"
        self._inboxes[worker].put(("task", blob))
        return len(blob)

    def close(self) -> None:
        if self._closing:
            return
        self._closing = True
        for stop in self._beat_stops.values():
            stop.set()
        for inbox in self._inboxes.values():
            inbox.put(("stop", None))
        for t in list(self._threads.values()) + list(self._beats.values()):
            t.join(timeout=2)
