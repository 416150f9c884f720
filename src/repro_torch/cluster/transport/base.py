"""The ``Transport`` interface: how coded bytes reach workers (the port
of ``repro.cluster.transport.base``).

A transport owns the full lifecycle of one cluster's worker channels:
``start`` (connect + handshake + ship the per-worker shards),
``ship_shard`` (re-shipping on requeue or plan re-tune), ``submit`` /
``cancel`` (per-task traffic), and a single uniform event stream
(``poll``) carrying ``TaskResult``s and ``Heartbeat``s from every
worker.  The dispatcher is written against exactly this surface -- it
cannot tell threads from pipes from sockets, which is the point: the
C(n, s) parity sweep and the liveness protocol are properties of the
stack, not of one backend.

Every mutating call returns the bytes it handed to the wire, so
bytes-on-wire accounting (the paper's omega/k communication claim) is
measured at the transport boundary rather than estimated.  (A frame
racing a dropping connection may be counted and then never arrive --
the death event that follows re-accounts the round via requeue;
``ship_shard`` returns 0 when the channel is already known-dead.)
"""

from __future__ import annotations

import queue

import torch

from ..faults import NoFaults
from ..wire import Heartbeat, Task
from ..worker import WORKER_BACKENDS


class Transport:
    """Base class: event queue, liveness bookkeeping, lifecycle guards.

    ``device`` and ``backend`` say what the workers compute with (see
    ``repro_torch.cluster.worker``).  Subclasses implement ``start`` /
    ``ship_shard`` / ``submit`` /
    ``cancel`` / ``close`` and keep ``self._dead`` honest (a worker is
    transport-dead once a death notice or channel loss was observed;
    *suspicion* from missed heartbeats is the dispatcher's job).

    Membership is dynamic since wire v4: ``n_workers`` is the *initial*
    roster (ids ``0..n-1``), ``add_worker`` / ``remove_worker`` grow
    and shrink it at runtime, and every membership gain surfaces as a
    ``WorkerJoin`` on the uniform event stream so the dispatcher can
    catch the newcomer up.  ``close`` is idempotent (guarded by
    ``self._closing``) and safe mid-round.
    """

    name = "base"
    # a transport that ships one dense operand region shared by every
    # task of a round (the JAX package's shm) sets this; the fleet
    # consults it when building a round's tasks.
    prefers_dense_payload = False

    def __init__(self, n_workers: int, *, faults=None,
                 heartbeat_s: float = 0.25, device=None,
                 backend: str = "packed"):
        if backend not in WORKER_BACKENDS:
            raise ValueError(f"worker backend must be one of "
                             f"{WORKER_BACKENDS}, got {backend!r}")
        self.n_workers = n_workers
        # what every worker of this transport computes with (never sent
        # in a frame): host scipy BSR ("packed"), or bcsr_matmul on
        # ``device`` ("cuda")
        self.device = torch.device(device if device is not None else "cpu")
        self.backend = backend
        self.faults = faults if faults is not None else NoFaults()
        self.heartbeat_s = heartbeat_s
        self.events: queue.Queue = queue.Queue()
        # wire v6 copy accounting: bytes this transport memcpy'd on the
        # coordinator side (flatten joins, staging into shared
        # segments).  Worker-side copies ride back on
        # ``TaskResult.copied``; the fleet sums both per round.
        self.bytes_copied = 0
        # beats keep ticking while the cluster idles between calls and
        # nothing polls: cap how many may sit queued (stale beats carry
        # no information -- the dispatcher re-stamps liveness at round
        # start), so idle time never grows memory
        self._beat_cap = max(64, 4 * n_workers)
        self._known: set[int] = set(range(n_workers))
        self._dead: set[int] = set()
        self._closing = False
        # wire v5: per-worker perf_counter offset sampled at the hello
        # handshake (coordinator receive stamp minus the clock sample in
        # the hello), i.e. coordinator_time ~= worker_time + offset.
        # In-process workers share the coordinator clock (offset 0.0,
        # the dict default); socket/pipe transports fill this in.
        self.clock_offsets: dict[int, float] = {}

    def clock_offset(self, worker: int) -> float:
        """perf_counter delta placing ``worker``'s timestamps on the
        coordinator timeline (0.0 when clocks are shared/unknown)."""
        return self.clock_offsets.get(worker, 0.0)

    def push_event(self, event) -> None:
        """Enqueue one uniform-stream event; idle heartbeats beyond the
        cap are dropped (results and deaths never are)."""
        if isinstance(event, Heartbeat) and \
                self.events.qsize() >= self._beat_cap:
            return
        self.events.put(event)

    # -- lifecycle ---------------------------------------------------------

    def start(self, shard_blobs: list[bytes] | None = None) -> int:
        """Spawn/connect workers and handshake; ship the initial shards
        when given (a fleet starts its worker set bare and ships per
        ``attach``).  Returns total bytes shipped."""
        raise NotImplementedError

    def close(self) -> None:
        raise NotImplementedError

    # -- traffic -----------------------------------------------------------

    def ship_shard(self, worker: int, blob: bytes) -> int:
        raise NotImplementedError

    def submit(self, worker: int, task: Task) -> int:
        raise NotImplementedError

    def cancel(self, worker: int, round_id: int) -> None:
        raise NotImplementedError

    def drop_plan(self, worker: int, plan_id: int) -> None:
        """Tell ``worker`` to free one plan's task tables (wire v4,
        sent on plan re-encode).  Best-effort: a transport without a
        control path may ignore it."""

    def confirm_join(self, worker: int, plans: int = 0) -> None:
        """Welcome frame after shard catch-up (wire v4).  Socket
        transports forward it to the device; in-process ones treat it
        as informational."""

    # -- zero-copy hooks (wire v6) ------------------------------------------
    # No-ops everywhere except shm, where operands and results live in
    # shared segments the fleet writes/reads directly.

    def alloc_operand(self, shape, dtype) -> "object | None":
        """A zero-filled array the fleet may build a round's operand in
        *in place*.  shm returns a view of a fresh shared segment (the
        padding copy every transport pays lands straight in shared
        memory, so submit ships a reference); others return None and
        the fleet allocates normally."""
        return None

    def prepare_results(self, round_id: int, rows, shape, dtype) -> None:
        """Announce a round's expected result geometry before submit.
        shm carves a per-round result slab and remembers row offsets;
        others ignore it."""

    def finish_round(self, round_id: int) -> None:
        """A round fully resolved (decoded, aborted or expired):
        release any per-round transport state (shm unlinks the round's
        operand/result segments)."""

    # -- dynamic membership (wire v4) ---------------------------------------

    def workers(self) -> list[int]:
        """Current roster (alive or not), sorted."""
        return sorted(self._known)

    def next_worker_id(self) -> int:
        return max(self._known, default=-1) + 1

    def add_worker(self, worker: int | None = None) -> int:
        """Spawn/admit one worker into the running transport and push a
        ``WorkerJoin`` event; returns its id.  ``worker=None`` picks
        the next free id; naming a dead id revives it (reconnect)."""
        raise NotImplementedError(f"{self.name} transport cannot add "
                                  f"workers at runtime")

    def remove_worker(self, worker: int) -> None:
        """Tear one worker's channel down *without* a death notice (the
        graceful half of leave; the dispatcher drains first)."""
        raise NotImplementedError(f"{self.name} transport cannot remove "
                                  f"workers at runtime")

    def garble(self, worker: int) -> int:
        """Deliver a deliberately corrupt frame to ``worker`` (chaos:
        the worker must refuse to keep serving and notify death rather
        than compute from a bad state).  Returns bytes sent."""
        raise NotImplementedError(f"{self.name} transport cannot garble "
                                  f"frames")

    # -- the uniform event stream -----------------------------------------

    def poll(self, timeout: float):
        """Next ``TaskResult`` / ``Heartbeat``, or None on timeout."""
        try:
            return self.events.get(timeout=timeout)
        except queue.Empty:
            return None

    def drain(self) -> list:
        """Everything already queued (between-rounds hygiene)."""
        out = []
        while True:
            try:
                out.append(self.events.get_nowait())
            except queue.Empty:
                return out

    def alive(self, worker: int) -> bool:
        """Transport-level liveness (no death notice / channel loss
        observed).  A silently hung worker is still transport-alive --
        only the dispatcher's heartbeat timeout catches it."""
        return worker in self._known and worker not in self._dead

    def mark_dead(self, worker: int) -> None:
        self._dead.add(worker)

    def revive(self, worker: int) -> None:
        """Clear the dead mark (a rejoin/reconnect admitted a fresh
        channel for this id)."""
        self._dead.discard(worker)
