"""Subprocess transport: wire bytes over ``multiprocessing`` pipes (the
port of ``repro.cluster.transport.pipe``).

One spawned child per worker (spawn context: a child never inherits its
parent's CUDA state, which CUDA cannot share across a fork).  A host
child's task path is numpy + scipy; a card child (``backend="cuda"``)
opens its own CUDA context on ``device`` and launches ``bcsr_matmul``
itself, so its launch counters live in the child; ``reports()`` asks
each child for them over the pipe's control channel.  Everything else
crossing the pipe is wire bytes inside ``(kind, bytes)`` tuples; the child runs
the shared ``serve_loop`` with a reader thread pumping the pipe into
its inbox and a heartbeat ticker beating on the same channel results
travel on.  A child that exits without a death notice (real fail-stop)
is detected by the parent pump's EOF -- and a child whose serve loop
*hangs* parks with the pipe open, invisible to everything except the
dispatcher's heartbeat timeout.

Membership is dynamic (wire v4): ``add_worker`` forks a fresh child
mid-run (reviving a dead id on reconnect) and pushes a ``WorkerJoin``;
``remove_worker`` reaps one child without a death notice (graceful
leave); ``garble`` sends a corrupt frame the child must answer with a
death notice.
"""

from __future__ import annotations

import os
import queue
import threading
import time

from ..faults import from_spec
from ..wire import Task, TaskResult, WorkerJoin, death_notice, decode_event
from ..worker import (prepare_device, serve_loop, start_heartbeat,
                      worker_report)
from .base import Transport

# how long a spawned child may take to report ready: importing torch,
# and for a card child creating its CUDA context and loading the kernel
# library.  Six card children started together on an H100 host were all
# ready after 10.3 s (torch import 8.2 s each, CUDA context 1.5-1.7 s;
# PERF.md, Findings); the wait allows about ten times that.
READY_TIMEOUT_S = 120.0


def _pipe_worker_main(conn, worker_id: int, fault_spec, heartbeat_s: float,
                      device: str = "cpu", backend: str = "packed") -> None:
    """Child entry point: pump pipe -> inbox, serve, beat.  A card
    child creates its CUDA context and loads the kernel library before
    it reports ready."""
    t_entry = time.perf_counter()
    faults = from_spec(fault_spec)
    prepare_device(device, backend)
    inbox: queue.Queue = queue.Queue()
    send_lock = threading.Lock()
    parked = threading.Event()          # set when a stop/EOF reached the pump

    def emit(event) -> None:
        with send_lock:
            conn.send(("event", event.encode()))

    def pump() -> None:
        try:
            while True:
                msg = conn.recv()
                if msg[0] == "report":  # control channel, not the serve loop
                    with send_lock:
                        conn.send(("report", worker_report(device, backend)))
                    continue
                if msg[0] == "stop":
                    parked.set()
                inbox.put(msg)
        except (EOFError, OSError):     # dispatcher went away
            parked.set()
            inbox.put(("stop", None))

    with send_lock:                     # ready: imports are done, serve
        # loop is about to start; the perf_counter sample is the wire-v5
        # clock handshake (parent derives this child's clock offset)
        # (perf_counter is the host's monotonic clock, shared by the
        # processes of one host: the parent times the start-up from it)
        conn.send(("hello", (worker_id, time.perf_counter(),
                             time.perf_counter() - t_entry, t_entry)))
    threading.Thread(target=pump, daemon=True).start()
    stop_beats = threading.Event()
    start_heartbeat(worker_id, emit, heartbeat_s, stop_beats,
                    mute=getattr(faults, "should_mute", None))
    try:
        status = serve_loop(worker_id, inbox, emit, faults,
                            stop_beats=stop_beats, device=device,
                            backend=backend)
    except (BrokenPipeError, OSError):
        return
    if status == "hang":
        # mute with the pipe open: only the dispatcher's heartbeat
        # timeout can catch this worker -- but exit promptly once the
        # dispatcher says stop, so close() never waits out a join
        # timeout on a parked child
        parked.wait()
        os._exit(0)


class PipeTransport(Transport):
    name = "pipe"
    # the child entry point ``_spawn`` starts (shm's child resolves
    # segment references on top of this one's protocol)
    _child_main = staticmethod(_pipe_worker_main)

    def __init__(self, n_workers: int, *, faults=None,
                 heartbeat_s: float = 0.25, device=None,
                 backend: str = "packed"):
        super().__init__(n_workers, faults=faults, heartbeat_s=heartbeat_s,
                         device=device, backend=backend)
        self._conns: dict = {}
        self._procs: dict = {}
        self._pumps: dict[int, threading.Thread] = {}
        self._ready: dict[int, threading.Event] = {}
        self._leaving: set[int] = set()
        self._spawned_at: dict[int, float] = {}
        # per worker, how its start-up went (seconds): ``spawn_s`` from
        # the spawn to the child's entry (interpreter start and imports),
        # ``prepare_s`` the card child's CUDA context and kernel library,
        # ``ready_s`` from the spawn to the parent seeing its hello
        self.startup: dict[int, dict] = {}
        # the latest ``worker_report`` of each child (``reports()``)
        self._reports: dict[int, dict] = {}
        self._reported: dict[int, threading.Event] = {}

    def _spawn(self, w: int) -> None:
        import multiprocessing as mp  # noqa: PLC0415

        ctx = mp.get_context("spawn")
        conn, child = ctx.Pipe()
        proc = ctx.Process(
            target=self._child_main,
            args=(child, w, self.faults.to_spec(), self.heartbeat_s,
                  str(self.device), self.backend),
            daemon=True)
        self._spawned_at[w] = time.perf_counter()
        proc.start()
        child.close()
        self._conns[w] = conn
        self._procs[w] = proc
        self._ready[w] = threading.Event()
        self._reported[w] = threading.Event()
        pump = threading.Thread(target=self._pump, args=(w, conn),
                                daemon=True)
        pump.start()
        self._pumps[w] = pump

    def start(self, shard_blobs: list[bytes] | None = None) -> int:
        shipped = 0
        for w in sorted(self._known):
            self._spawn(w)
        for w, blob in enumerate(shard_blobs or []):
            shipped += self.ship_shard(w, blob)
        # don't hand the transport over until every child finished its
        # (slow: spawn + torch import, and a card child's CUDA context)
        # startup -- otherwise the liveness protocol would suspect
        # workers that never got to beat
        for w in list(self._ready):
            if not self._await_ready(w):
                self.close()
                raise RuntimeError(f"pipe worker {w} never became ready")
        return shipped

    def _await_ready(self, w: int) -> bool:
        """Wait for worker ``w``'s hello, at most ``READY_TIMEOUT_S``;
        a child that exits first (a failed import, say) fails at once."""
        deadline = time.perf_counter() + READY_TIMEOUT_S
        while not self._ready[w].wait(timeout=0.1):
            if (not self._procs[w].is_alive()
                    or time.perf_counter() > deadline):
                return self._ready[w].is_set()
        return True

    def _pump(self, worker: int, conn) -> None:
        try:
            while True:
                kind, data = conn.recv()
                if kind == "hello":
                    # wire v5 clock handshake: the child sampled its
                    # perf_counter at send; ours-at-receive minus that
                    # places its task timestamps on our timeline (error
                    # is the one-way hello latency)
                    now = time.perf_counter()
                    if isinstance(data, tuple):
                        self.clock_offsets[worker] = now - data[1]
                        spawned = self._spawned_at.get(worker, now)
                        self.startup[worker] = {
                            "spawn_s": data[3] - spawned,
                            "prepare_s": data[2], "ready_s": now - spawned}
                    self._ready[worker].set()
                    continue
                if kind == "report":
                    self._reports[worker] = data
                    self._reported[worker].set()
                    continue
                event = decode_event(data)
                if isinstance(event, TaskResult) and event.kind == "death":
                    self.mark_dead(worker)
                self.push_event(event)
        except (EOFError, OSError):
            if not self._closing and worker not in self._dead \
                    and worker not in self._leaving:
                # the process died without a notice: real fail-stop
                self.mark_dead(worker)
                self.push_event(death_notice(
                    worker, "worker process exited"))

    def _send(self, worker: int, msg) -> None:
        conn = self._conns.get(worker)
        if conn is None:
            return                      # left/removed: nothing to send to
        try:
            conn.send(msg)
        except (BrokenPipeError, OSError):
            pass                        # pump reports the death

    def reports(self, timeout: float = 30.0) -> dict[int, dict]:
        """Ask every live child for its ``worker_report`` (pid, compute
        backend, kernel launches, device memory) over the pipe's control
        channel and wait for the answers.  A child answers from its pump
        thread, so launches of tasks whose results already came back are
        in its count."""
        live = [w for w in sorted(self._conns) if self.alive(w)]
        for w in live:
            self._reported[w].clear()
            self._send(w, ("report", None))
        deadline = time.perf_counter() + timeout
        for w in live:
            if not self._reported[w].wait(
                    max(0.0, deadline - time.perf_counter())):
                raise TimeoutError(f"pipe worker {w} sent no report in "
                                   f"{timeout} s")
        return {w: self._reports[w] for w in live}

    def ship_shard(self, worker: int, blob: bytes) -> int:
        self._send(worker, ("shard", blob))
        return len(blob)

    def submit(self, worker: int, task: Task) -> int:
        # encode() is single-copy since wire v6 (one gather join); the
        # pipe carries the flat frame, so that join is the task path's
        # only serialization memcpy -- recorded for the wire bench
        data = task.encode()
        self.bytes_copied += len(data)
        self._send(worker, ("task", data))
        return len(data)

    def cancel(self, worker: int, round_id: int) -> None:
        self._send(worker, ("cancel", round_id))

    def drop_plan(self, worker: int, plan_id: int) -> None:
        self._send(worker, ("drop", plan_id))

    def confirm_join(self, worker: int, plans: int = 0) -> None:
        self._send(worker, ("welcome", plans))

    # -- dynamic membership (wire v4) ---------------------------------------

    def add_worker(self, worker: int | None = None) -> int:
        w = self.next_worker_id() if worker is None else int(worker)
        if self.alive(w) and self._procs[w].is_alive():
            raise ValueError(f"worker {w} is already serving")
        self._reap(w)                   # a dead predecessor, if any
        self._leaving.discard(w)
        self._known.add(w)
        self.revive(w)
        self._spawn(w)
        if not self._await_ready(w):
            self._reap(w)
            raise RuntimeError(f"pipe worker {w} never became ready")
        self.push_event(WorkerJoin(worker=w))
        return w

    def _reap(self, w: int, timeout: float = 2.0) -> None:
        proc = self._procs.pop(w, None)
        conn = self._conns.pop(w, None)
        if conn is not None:
            try:
                conn.send(("stop", None))
            except (BrokenPipeError, OSError):
                pass
        if proc is not None:
            proc.join(timeout=timeout)
            if proc.is_alive():
                proc.terminate()
                proc.join(timeout=timeout)
        if conn is not None:
            conn.close()
        pump = self._pumps.pop(w, None)
        if pump is not None:
            pump.join(timeout=timeout)
        self._ready.pop(w, None)
        self._reported.pop(w, None)
        self._reports.pop(w, None)

    def remove_worker(self, worker: int) -> None:
        # the leaving mark silences the pump's EOF death notice -- a
        # graceful leave is not a fail-stop
        self._leaving.add(worker)
        self.mark_dead(worker)
        self._known.discard(worker)
        self._reap(worker)

    def garble(self, worker: int) -> int:
        blob = b"\x00garbled-frame"
        self._send(worker, ("task", blob))
        return len(blob)

    def close(self) -> None:
        if self._closing:
            return
        self._closing = True
        for w in list(self._conns):
            self._send(w, ("stop", None))
        for proc in self._procs.values():
            proc.join(timeout=2)
            if proc.is_alive():         # hung or stuck child
                proc.terminate()
                proc.join(timeout=2)
        for conn in self._conns.values():
            conn.close()
        for pump in self._pumps.values():
            pump.join(timeout=2)
