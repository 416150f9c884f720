"""TCP transport: the wire format over real sockets (the port of
``repro.cluster.transport.tcp``).

The dispatcher side runs an asyncio server on a dedicated thread; each
worker is a spawned subprocess (spawn context: CUDA state cannot cross
a fork) or a remote ``python -m repro_torch.cluster.worker --connect``
process that connects back and speaks length-prefixed frames of the
versioned wire records:

  * **handshake** -- the first frame on every connection is a hello
    record carrying the wire version (in the record header, so a
    mismatched build is rejected at decode) and the worker id; a
    connection whose first frame fails to decode is closed without
    registering.  A hello for an id the coordinator has never seen (or
    one whose previous connection died) is a **live join**: the
    connection is admitted, a ``WorkerJoin`` surfaces on the uniform
    event stream, and the dispatcher catches the newcomer up (every
    attached plan's shards, digest-verified) before confirming with a
    welcome frame.
  * **shard shipping** -- shards travel wrapped with a sha256 digest.
    The *worker-side* check is the enforcement: a digest mismatch turns
    into a death notice, so a corrupted shard can never silently serve
    wrong products.  The worker also acks the digest back
    (``TcpTransport.shard_acks``).  Shipping retries under the shared
    ``RetryPolicy`` before giving up on a flaky channel.
  * **liveness** -- workers heartbeat on the same socket results travel
    on.  A closed connection surfaces immediately as a death notice
    (unless the worker was *leaving* gracefully); a silent worker is
    caught only by the dispatcher's heartbeat timeout.

What the workers compute with (``device`` / ``backend``) is the
transport's, never a frame's: a locally spawned card child creates its
CUDA context and loads the kernel library before it dials, so start-up
never counts against liveness.  Each spawned child also keeps a
``multiprocessing`` pipe beside its socket, a control channel that
answers ``reports()`` (pid, device, memory, launches) as a pipe child
does; a remote worker has no such channel and ``reports()`` leaves it
out.
"""

from __future__ import annotations

import asyncio
import hashlib
import os
import queue
import socket
import struct
import threading
import time

from ..faults import from_spec
from ..retry import RetryPolicy
from ..wire import (
    PlanShard,
    Task,
    TaskResult,
    WorkerJoin,
    control_record,
    death_notice,
    decode_event,
    decode_record,
    encode_record,
    flatten,
    hello_record,
    welcome_record,
)
from ..worker import (prepare_device, serve_loop, start_heartbeat,
                      worker_report)
from .base import Transport

_LEN = struct.Struct("<I")
_MAX_FRAME = 1 << 31


# ---------------------------------------------------------------------------
# Worker child (blocking sockets + the shared serve loop)
# ---------------------------------------------------------------------------


def _send_frame(sock: socket.socket, blob: bytes,
                lock: threading.Lock) -> None:
    with lock:
        sock.sendall(_LEN.pack(len(blob)) + blob)


def _recv_exact(sock: socket.socket, n: int) -> bytearray | None:
    """Exactly ``n`` bytes into one preallocated buffer (a shard frame
    is hundreds of MB: growing a ``bytes`` chunk by chunk would copy it
    over and over), or None at EOF."""
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        m = sock.recv_into(view[got:])
        if not m:
            return None
        got += m
    return buf


def _recv_frame(sock: socket.socket) -> bytearray | None:
    head = _recv_exact(sock, _LEN.size)
    if head is None:
        return None
    (n,) = _LEN.unpack(head)
    if n > _MAX_FRAME:
        return None
    return _recv_exact(sock, n)


def _answer_reports(ctl, device: str, backend: str) -> None:
    """A spawned child's control channel: answer every ``report``
    request with this process's ``worker_report`` until the parent
    closes the pipe."""
    try:
        while True:
            if ctl.recv()[0] == "report":
                ctl.send(("report", worker_report(device, backend)))
    except (EOFError, OSError):
        return


def _tcp_worker_main(host: str, port: int, worker_id: int, fault_spec,
                     heartbeat_s: float, join: bool = False,
                     device: str = "cpu", backend: str = "packed",
                     ctl=None) -> None:
    """Child entry point: prepare the device, connect, hello, pump
    socket -> inbox, serve.  ``ctl`` is a spawned child's control pipe
    (None for a remote worker): its start-up times go there first, then
    it answers report requests."""
    t_entry = time.perf_counter()
    faults = from_spec(fault_spec)
    prepare_device(device, backend)
    if ctl is not None:
        ctl.send(("startup", (t_entry, time.perf_counter() - t_entry)))
        threading.Thread(target=_answer_reports, args=(ctl, device, backend),
                         daemon=True).start()
    sock = socket.create_connection((host, port))
    lock = threading.Lock()
    inbox: queue.Queue = queue.Queue()
    stop_beats = threading.Event()
    parked = threading.Event()          # set when a stop/EOF reached the pump

    def emit(event) -> None:
        _send_frame(sock, event.encode(), lock)

    def corrupt(why: str) -> None:
        """Corrupted inbound frame: a worker fed garbage must not keep
        serving from a bad state -- notify death and stop."""
        stop_beats.set()
        try:
            emit(death_notice(worker_id, why))
        except OSError:
            pass
        inbox.put(("stop", None))

    def pump() -> None:
        while True:
            try:
                blob = _recv_frame(sock)
            except OSError:
                blob = None
            if blob is None:                    # dispatcher went away
                parked.set()
                inbox.put(("stop", None))
                return
            try:
                meta, arrays = decode_record(blob)
                rec = meta.get("record")
                if rec == "task":
                    inbox.put(("task", Task(
                        round=meta["round"], op=meta["op"],
                        task_row=meta["task_row"],
                        plan=meta.get("plan", 0),
                        trace=meta.get("trace", 0), payload=arrays,
                        meta=meta["meta"])))
                elif rec == "shard-wrap":
                    inner = arrays["blob"].tobytes()
                    digest = hashlib.sha256(inner).hexdigest()
                    if digest != meta["digest"]:
                        corrupt("shard digest mismatch")
                        return
                    _send_frame(sock, control_record(
                        "shard-ack", worker=worker_id, digest=digest), lock)
                    inbox.put(("shard", PlanShard.decode(inner)))
                elif rec == "cancel":
                    inbox.put(("cancel", meta["round"]))
                elif rec == "drop":
                    inbox.put(("drop", meta["plan"]))
                elif rec == "welcome":
                    inbox.put(("welcome", meta.get("plans", 0)))
                elif rec == "stop":
                    parked.set()
                    inbox.put(("stop", None))
                    return
            except (ValueError, KeyError, TypeError) as e:
                # garbled frame OR well-formed json missing fields:
                # either way this worker must not keep serving
                corrupt(repr(e))
                return

    try:
        _send_frame(sock, hello_record(worker_id, join=join), lock)
        threading.Thread(target=pump, daemon=True).start()
        start_heartbeat(worker_id, emit, heartbeat_s, stop_beats,
                        mute=getattr(faults, "should_mute", None))
        status = serve_loop(worker_id, inbox, emit, faults,
                            stop_beats=stop_beats, device=device,
                            backend=backend)
    except OSError:
        sock.close()
        return
    if status == "hang":
        # mute with the socket open: only the dispatcher's heartbeat
        # timeout can catch this worker -- but exit promptly once the
        # dispatcher says stop (or drops the connection), so close()
        # never waits out a join timeout on a parked child
        parked.wait()
        os._exit(0)
    sock.close()


# ---------------------------------------------------------------------------
# Dispatcher side (asyncio server on a dedicated thread)
# ---------------------------------------------------------------------------


class TcpTransport(Transport):
    name = "tcp"

    def __init__(self, n_workers: int, *, faults=None,
                 heartbeat_s: float = 0.25, host: str = "127.0.0.1",
                 port: int = 0, spawn: bool = True,
                 hello_timeout: float = 60.0, allow_join: bool = True,
                 device=None, backend: str = "packed"):
        """``spawn=False`` turns this into a multi-host coordinator: no
        local children are started -- the server binds ``host:port``
        (pass a fixed port so operators can point remote devices at it)
        and ``start`` waits ``hello_timeout`` seconds for ``n_workers``
        remote ``python -m repro_torch.cluster.worker --connect``
        processes to dial in and handshake.  The wire does not carry
        the compute backend, so remote workers must compute as
        ``backend`` says: a ``backend="cuda"`` coordinator is joined by
        card workers (``--device cuda``).  ``allow_join`` (default on)
        admits hellos for ids outside the initial roster at runtime --
        the live-join path."""
        super().__init__(n_workers, faults=faults, heartbeat_s=heartbeat_s,
                         device=device, backend=backend)
        self.host = host
        self.spawn = spawn
        self.hello_timeout = hello_timeout
        self.allow_join = allow_join
        self.port: int | None = port or None
        self._loop: asyncio.AbstractEventLoop | None = None
        self._thread: threading.Thread | None = None
        self._server = None
        self._writers: dict = {}
        self._hello: dict[int, threading.Event] = {
            w: threading.Event() for w in range(n_workers)}
        self._hello_at: dict[int, float] = {}
        self._awaiting: set[int] = set(range(n_workers))
        self._leaving: set[int] = set()
        self._procs: dict = {}
        # spawned children only: the control pipe beside each socket
        self._ctls: dict = {}
        self._spawned_at: dict[int, float] = {}
        # per spawned worker, how its start-up went (seconds), as the
        # pipe transport has it: ``spawn_s`` from the spawn to the
        # child's entry, ``prepare_s`` the card child's CUDA context and
        # kernel library, ``ready_s`` from the spawn to its hello
        self.startup: dict[int, dict] = {}
        self._ship_retry = RetryPolicy(base_s=0.05, max_backoff_s=0.5,
                                       attempt_timeout_s=15.0)
        self.shard_acks: dict[int, str] = {}    # worker -> last acked digest

    # -- event-loop plumbing ----------------------------------------------

    def _run_coro(self, coro, timeout: float = 30.0):
        return asyncio.run_coroutine_threadsafe(coro, self._loop).result(
            timeout)

    async def _read_frame(self, reader) -> bytes | None:
        try:
            head = await reader.readexactly(_LEN.size)
            (n,) = _LEN.unpack(head)
            if n > _MAX_FRAME:
                return None
            return await reader.readexactly(n)
        except (asyncio.IncompleteReadError, ConnectionError, OSError):
            return None

    async def _on_conn(self, reader, writer) -> None:
        blob = await self._read_frame(reader)
        w = None
        try:
            if blob is None:
                raise ValueError("no hello frame")
            meta, _ = decode_record(blob)       # rejects wrong wire version
            if meta.get("record") != "hello":
                raise ValueError(f"expected hello, got {meta.get('record')!r}")
            w = int(meta["worker"])
            if w < 0 or self._writers.get(w) is not None:
                raise ValueError(f"bad or duplicate worker id {w}")
            is_join = w not in self._awaiting
            if is_join and not self.allow_join:
                raise ValueError(f"unknown worker id {w} (live join "
                                 f"disabled)")
            # wire v5 clock handshake: the hello sampled the worker's
            # perf_counter at send; ours-at-receive minus that places
            # worker-side task timestamps on the coordinator timeline
            clock = meta.get("clock")
            if clock is not None:
                self.clock_offsets[w] = time.perf_counter() - float(clock)
        except (ValueError, KeyError, TypeError, AttributeError):
            writer.close()                      # failed handshake: reject
            return
        self._awaiting.discard(w)
        self._known.add(w)
        self.revive(w)
        self._leaving.discard(w)
        self._writers[w] = writer
        self._hello_at[w] = time.perf_counter()
        self._hello.setdefault(w, threading.Event()).set()
        if is_join:
            # live join (a fresh id, a respawned child, or a remote
            # device reconnecting): the dispatcher owns catch-up
            self.push_event(WorkerJoin(worker=w))
        while True:
            blob = await self._read_frame(reader)
            if blob is None:
                break
            try:
                event = decode_event(blob)      # the shared demux
            except ValueError:
                break                           # garbled stream: drop conn
            if isinstance(event, dict):         # control: shard-ack
                if event.get("record") == "shard-ack":
                    self.shard_acks[w] = event["digest"]
                continue
            if isinstance(event, TaskResult) and event.kind == "death":
                self.mark_dead(w)
            self.push_event(event)
        if self._writers.get(w) is writer:
            self._writers.pop(w, None)
        writer.close()
        if not self._closing and w not in self._dead \
                and w not in self._leaving:
            # connection lost without a notice: fail-stop over the network
            self.mark_dead(w)
            self.push_event(death_notice(w, "connection lost"))

    async def _asend(self, worker: int, blob: bytes) -> bool:
        """Write one frame, length-prefixing ``blob``; returns whether
        it actually hit the wire (False once the connection is gone --
        the pump surfaces the death, callers must not crash the round
        or count the bytes)."""
        return await self._asend_framed(worker, _LEN.pack(len(blob)) + blob)

    async def _asend_framed(self, worker: int, frame: bytes) -> bool:
        """Write an already length-prefixed frame (the scatter/gather
        submit path folds the prefix into its single flatten join)."""
        writer = self._writers.get(worker)
        if writer is None:
            return False                        # death already surfaced
        try:
            writer.write(frame)
            await writer.drain()
        except (ConnectionError, OSError):
            return False
        return True

    # -- Transport interface ----------------------------------------------

    def _spawn_child(self, w: int, join: bool = False) -> None:
        import multiprocessing as mp  # noqa: PLC0415

        ctx = mp.get_context("spawn")
        ctl, child_ctl = ctx.Pipe()
        proc = ctx.Process(
            target=_tcp_worker_main,
            args=(self.host, self.port, w, self.faults.to_spec(),
                  self.heartbeat_s, join, str(self.device), self.backend,
                  child_ctl),
            daemon=True)
        self._spawned_at[w] = time.perf_counter()
        proc.start()
        child_ctl.close()
        self._procs[w] = proc
        self._ctls[w] = ctl

    def _await_hello(self, w: int) -> bool:
        """Wait for worker ``w``'s hello, at most ``hello_timeout``; a
        spawned child that exits first (a failed import, a card it
        cannot use) fails at once.  Records a spawned child's start-up
        times from its control pipe."""
        evt = self._hello[w]
        deadline = time.perf_counter() + self.hello_timeout
        proc = self._procs.get(w)
        while not evt.wait(timeout=0.1):
            if (proc is not None and not proc.is_alive()) \
                    or time.perf_counter() > deadline:
                break
        if not evt.is_set():
            return False
        ctl = self._ctls.get(w)
        if ctl is not None and w in self._spawned_at and ctl.poll(5.0):
            _, (t_entry, prepare_s) = ctl.recv()
            spawned = self._spawned_at[w]
            self.startup[w] = {"spawn_s": t_entry - spawned,
                               "prepare_s": prepare_s,
                               "ready_s": self._hello_at[w] - spawned}
        return True

    def start(self, shard_blobs: list[bytes] | None = None) -> int:
        self._loop = asyncio.new_event_loop()
        self._thread = threading.Thread(
            target=self._loop.run_forever, name="cluster-tcp-loop",
            daemon=True)
        self._thread.start()
        try:
            self._server = self._run_coro(
                asyncio.start_server(self._on_conn, self.host,
                                     self.port or 0))
            self.port = self._server.sockets[0].getsockname()[1]
            if self.spawn:
                for w in range(self.n_workers):
                    self._spawn_child(w)
            for w in range(self.n_workers):
                if not self._await_hello(w):
                    raise RuntimeError(f"tcp worker {w} never completed "
                                       f"the handshake")
            return sum(self.ship_shard(w, blob)
                       for w, blob in enumerate(shard_blobs or []))
        except BaseException:
            # failed construction must not leak the loop thread, the
            # server socket, or already-spawned children
            self.close()
            raise

    def reports(self, timeout: float = 30.0) -> dict[int, dict]:
        """Ask every live spawned child for its ``worker_report`` over
        its control pipe and wait for the answers (the shape of
        ``PipeTransport.reports()``).  Remote workers have no control
        channel and are left out."""
        live = [w for w in sorted(self._ctls) if self.alive(w)]
        for w in live:
            self._ctls[w].send(("report", None))
        deadline = time.perf_counter() + timeout
        out = {}
        for w in live:
            ctl = self._ctls[w]
            if not ctl.poll(max(0.0, deadline - time.perf_counter())):
                raise TimeoutError(f"tcp worker {w} sent no report in "
                                   f"{timeout} s")
            out[w] = ctl.recv()[1]
        return out

    def ship_shard(self, worker: int, blob: bytes) -> int:
        import numpy as np  # noqa: PLC0415

        digest = hashlib.sha256(blob).hexdigest()
        frame = encode_record({"record": "shard-wrap", "digest": digest},
                              {"blob": np.frombuffer(blob, np.uint8)})

        # synchronous (.result): shard shipping wants backpressure, and
        # requeue correctness depends on the shard preceding its tasks.
        # Retried under the shared policy: a slow loop round-trip or a
        # transient socket error must not strand a shard (and with it
        # every requeue that depends on it).
        def send_once() -> bool:
            return self._run_coro(self._asend(worker, frame),
                                  timeout=self._ship_retry.attempt_timeout_s)

        try:
            sent = self._ship_retry.call(send_once)
        except (TimeoutError, ConnectionError, OSError):
            return 0                    # channel gone: the pump surfaces it
        return len(frame) if sent else 0

    def submit(self, worker: int, task: Task) -> int:
        # scatter/gather (wire v6): one flatten join gathers header +
        # payload views + the length prefix into the socket frame --
        # the task path's single copy, recorded in bytes_copied
        header, bufs = task.encode_sg()
        nbytes = len(header) + sum(b.nbytes for b in bufs)
        frame = flatten(header, bufs, prefix=_LEN.pack(nbytes))
        self.bytes_copied += nbytes
        # fire-and-forget: the byte count is known up front and the
        # send swallows connection errors (the pump surfaces the death)
        fut = asyncio.run_coroutine_threadsafe(
            self._asend_framed(worker, frame), self._loop)
        fut.add_done_callback(lambda f: f.exception())  # never unretrieved
        return nbytes

    def cancel(self, worker: int, round_id: int) -> None:
        fut = asyncio.run_coroutine_threadsafe(
            self._asend(worker, control_record("cancel", round=round_id)),
            self._loop)
        fut.add_done_callback(lambda f: f.exception())

    def _send_quietly(self, worker: int, blob: bytes) -> bool:
        """One control frame, waited for at most 5 s; False when it did
        not reach the wire (best-effort hygiene never fails its caller)."""
        try:
            return self._run_coro(self._asend(worker, blob), timeout=5)
        except Exception:
            return False

    def drop_plan(self, worker: int, plan_id: int) -> None:
        self._send_quietly(worker, control_record("drop", plan=plan_id))

    def confirm_join(self, worker: int, plans: int = 0) -> None:
        self._send_quietly(worker, welcome_record(worker, plans))

    # -- dynamic membership (wire v4) ---------------------------------------

    def _reap(self, w: int) -> None:
        proc = self._procs.pop(w, None)
        if proc is not None:
            proc.join(timeout=2)
            if proc.is_alive():         # hung or stuck child
                proc.terminate()
                proc.join(timeout=2)
        ctl = self._ctls.pop(w, None)
        if ctl is not None:
            ctl.close()

    def add_worker(self, worker: int | None = None) -> int:
        w = self.next_worker_id() if worker is None else int(worker)
        if self._writers.get(w) is not None:
            raise ValueError(f"worker {w} is already connected")
        self._reap(w)                   # a dead predecessor, if any
        self._hello.setdefault(w, threading.Event()).clear()
        if self.spawn:
            self._spawn_child(w, join=True)
        # spawn=False: a remote device dials on its own -- just wait
        if not self._await_hello(w):
            raise RuntimeError(f"tcp worker {w} never completed the "
                               f"join handshake")
        return w

    def remove_worker(self, worker: int) -> None:
        # leaving mark first: the connection teardown that follows must
        # not be mistaken for fail-stop by the pump
        self._leaving.add(worker)
        self.mark_dead(worker)
        self._known.discard(worker)
        self._send_quietly(worker, control_record("stop"))
        self._reap(worker)

        async def _close_writer() -> None:
            wr = self._writers.pop(worker, None)
            if wr is not None:
                wr.close()

        try:
            self._run_coro(_close_writer(), timeout=5)
        except Exception:
            pass

    def garble(self, worker: int) -> int:
        """One deliberately corrupt frame: the worker's pump must answer
        with a death notice (it may not keep serving from a bad state)."""
        frame = b"\xde\xad\xbe\xefgarbled-frame"
        return len(frame) if self._send_quietly(worker, frame) else 0

    def close(self) -> None:
        if self._closing:
            return
        self._closing = True
        if self._loop is not None:
            stop = control_record("stop")
            for w in list(self._writers):
                self._send_quietly(w, stop)
        for w in list(self._procs):
            self._reap(w)
        for ctl in self._ctls.values():
            ctl.close()
        self._ctls.clear()

        async def teardown() -> None:
            for w in list(self._writers):
                writer = self._writers.pop(w, None)
                if writer is not None:
                    writer.close()
            if self._server is not None:
                self._server.close()
                await self._server.wait_closed()

        if self._loop is not None:
            try:
                self._run_coro(teardown(), timeout=10)
            except Exception:  # pragma: no cover - teardown best-effort
                pass
            self._loop.call_soon_threadsafe(self._loop.stop)
            self._thread.join(timeout=5)
            self._loop.close()
