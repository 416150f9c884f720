"""Transport-agnostic worker core: one serve loop, every transport.

The port of ``repro.cluster.worker``.  The worker side of the paper's
system is an edge device that holds its coded submatrices (as BSR -- it
multiplies exactly the nonzero tiles, so its per-task cost is
nnz-proportional) and answers matvec / matmat / aggregate tasks as they
stream in.  This module is everything about that device that does NOT
depend on how bytes reach it:

  * ``ShardRuntime``   -- the task table (plan id + coded task row ->
    operator).  A worker co-hosts *several plans'* shards (a fleet
    session ships every attached plan to the same worker set), so tasks
    are keyed by ``(plan, row)`` and each plan keeps its own geometry
    for the scatter of support-restricted payloads (``bx``/``bi``) back
    into the zero operand buffer, bitwise-equivalent to dense shipping.
    It computes on one of two paths, picked by the transport that runs
    the worker (never by a frame, so frames stay the JAX package's):

      - ``backend="packed"`` (a host worker): the JAX package's scipy
        BSR product, verbatim, so the cluster's parity mode stays
        bitwise against the in-process ``packed`` backend;
      - ``backend="cuda"`` (a card worker): at ``load`` each task row's
        8x8 BSR of A_i^T is re-tiled on ``device`` into the ``cuda``
        backend's 32x32 padded-slot form of A_i; at ``run`` the operand
        goes to the device, one ``bcsr_matmul`` launch computes
        A_i^T B, and ``y`` comes back to the host as the wire needs.
        On a CPU ``device`` that launch is the kernel's plain version.

  * ``serve_loop``     -- the message state machine (shard / task /
    cancel / stop) with cancel-draining, fault decoration
    (``faults.faulty``), death notices and silent hangs; results echo
    the task's plan id so the fleet dispatcher can demux multiple
    in-flight rounds;
  * ``start_heartbeat``-- the liveness ticker: a side thread beating on
    the worker's emit channel every ``interval`` seconds until stopped,
    so compute (or injected latency) never starves liveness.

The transports (``repro_torch.cluster.transport``) supply only the
plumbing: an inbox of ``(kind, value)`` messages and an ``emit``
callable for results/beats.  Thread and pipe workers therefore run *the
same code* -- which is what makes the C(n, s) dispatcher-parity sweep a
property of the stack rather than of one backend.  The JAX package's
remote tcp worker (``python -m repro.cluster.worker --connect``) waits
for the tcp transport (ROADMAP.md §1 item 9).
"""

from __future__ import annotations

import os
import queue
import threading
import time

import numpy as np
import torch

from .faults import NoFaults, WorkerFailure, WorkerHang, faulty
from .wire import Heartbeat, PlanShard, Task, TaskResult, death_notice

# what a worker computes with: the host's scipy BSR, or the card's kernel
WORKER_BACKENDS = ("packed", "cuda")


def prepare_device(device, backend: str) -> None:
    """Make a card worker's first task cost what later ones do: create
    the CUDA context and load the kernel library (building it if no
    build is cached) before the worker reports ready."""
    dev = torch.device(device)
    if backend == "cuda" and dev.type == "cuda":
        from ..kernels import _build  # noqa: PLC0415 - card workers only

        torch.empty(0, device=dev)
        _build.library()


def worker_report(device, backend: str) -> dict:
    """What a worker process can say of itself, for its transport's
    control channel (never a wire frame): its pid, what it computes
    with, the kernel launches it made, and for a card worker the device
    memory its tensors hold."""
    from ..kernels import launch_counts  # noqa: PLC0415

    dev = torch.device(device)
    card = backend == "cuda" and dev.type == "cuda"
    return {"pid": os.getpid(), "device": str(dev), "backend": backend,
            "launches": launch_counts(),
            "device_name": torch.cuda.get_device_name(dev) if card else None,
            "memory_allocated": (torch.cuda.memory_allocated(dev)
                                 if card else 0)}


def _bsr_operator(shard: PlanShard, t: dict):
    """The host path: the shipped BSR components as a scipy operator,
    read in place (zero-copy: the decoded shard components are
    frombuffer views of the received frame)."""
    from scipy import sparse  # noqa: PLC0415 - worker-side heavy dep

    bsr = sparse.bsr_matrix(
        (np.asarray(t["data"]), np.asarray(t["indices"]),
         np.asarray(t["indptr"])),
        shape=(shard.c_pad, shard.t_pad), blocksize=(shard.bm, shard.bk))
    return lambda b: bsr @ b


class CardTask:
    """The card path of one task row: its BSR of A_i^T (c_pad x t_pad,
    bm x bk blocks) re-tiled into the ``cuda`` backend's packed form of
    A_i (``packed``: 32x32 tiles, only the nonzero ones, on ``device``);
    calling it on a host operand (t_pad, width) runs one ``bcsr_matmul``
    and returns A_i^T @ operand (c_pad, width) on the host."""

    def __init__(self, shard: PlanShard, t: dict, device: torch.device):
        from ..runtime.executor import CUDA_TILE  # noqa: PLC0415
        from ..runtime.pack import pack_coded_blocks  # noqa: PLC0415

        bk, bm = shard.bk, shard.bm
        kb, mb = shard.t_pad // bk, shard.c_pad // bm
        indptr = np.asarray(t["indptr"], np.int64)
        col = np.repeat(np.arange(mb), np.diff(indptr))   # A^T block-row
        data = torch.tensor(np.asarray(t["data"], np.float32), device=device)
        tiles = torch.zeros((kb, mb, bk, bm), dtype=torch.float32,
                            device=device)
        # A^T's (bm x bk) block (c-block, t-block) is A's tile (t-block,
        # c-block), transposed
        tiles[torch.tensor(np.asarray(t["indices"], np.int64), device=device),
              torch.tensor(col, device=device)] = data.transpose(1, 2)
        dense = tiles.permute(0, 2, 1, 3).reshape(1, shard.t_pad,
                                                  shard.c_pad)
        self.packed = pack_coded_blocks(dense, CUDA_TILE, CUDA_TILE)
        self.device = device
        self.c_pad = shard.c_pad

    def __call__(self, operand: np.ndarray) -> np.ndarray:
        from ..kernels.bcsr_matmul import bcsr_matmul  # noqa: PLC0415

        p = self.packed
        b = torch.tensor(operand, device=self.device)
        y = bcsr_matmul(p.a_data, p.a_idx, b, mb=p.mb, counts=p.counts)
        return y[: self.c_pad].cpu().numpy()


class ShardRuntime:
    """Task table: (plan id, coded task row) -> operator + work.

    ``backend`` picks the path (``packed``: scipy BSR on the host;
    ``cuda``: ``bcsr_matmul`` on ``device``, see the module docstring).
    """

    def __init__(self, device=None, backend: str = "packed"):
        if backend not in WORKER_BACKENDS:
            raise ValueError(f"worker backend must be one of "
                             f"{WORKER_BACKENDS}, got {backend!r}")
        self.device = torch.device(device if device is not None else "cpu")
        self.backend = backend
        self.tasks: dict[tuple[int, int], dict] = {}
        # per-plan operand geometry (t_pad, bk) for the support scatter
        self.geometry: dict[int, tuple[int, int]] = {}

    def drop(self, plan: int) -> int:
        """Free one plan's task table + geometry (wire v4 ``drop``:
        the fleet re-encoded the plan under a fresh id, the old shards
        must not accumulate on long-lived devices).  Returns how many
        task rows were freed."""
        stale = [key for key in self.tasks if key[0] == plan]
        for key in stale:
            del self.tasks[key]
        self.geometry.pop(plan, None)
        return len(stale)

    def load(self, shard: PlanShard) -> None:
        if shard.t_pad:
            self.geometry[shard.plan] = (shard.t_pad, shard.bk)
        for j, row in enumerate(shard.task_rows):
            entry = {"work": shard.work[j], "op": None}
            if shard.tasks:
                entry["op"] = (
                    CardTask(shard, shard.tasks[j], self.device)
                    if self.backend == "cuda"
                    else _bsr_operator(shard, shard.tasks[j]))
            self.tasks[(shard.plan, row)] = entry

    def _operand(self, plan: int, payload: dict
                 ) -> tuple[np.ndarray, int]:
        """Materialize the (t_pad, width) input the BSR product reads;
        returns ``(operand, bytes_copied)``.

        Dense payloads (``b``) pass through as zero-copy views;
        support-restricted ones (``bx`` rows + ``bi`` block indices)
        scatter into a zero buffer -- every unshipped row was exactly
        zero, so the product is bitwise the dense-shipped one, and the
        scatter's memcpy bytes are the copy accounting (wire v6) this
        path reports back on ``TaskResult.copied``.
        """
        if "b" in payload:
            src = np.asarray(payload["b"])
            out = np.asarray(src, np.float32)
            copied = 0 if np.shares_memory(out, src) else out.nbytes
            return out, copied
        t_pad, bk = self.geometry[plan]
        bx = np.asarray(payload["bx"], np.float32)
        bi = np.asarray(payload["bi"], np.int64)
        b = np.zeros((t_pad, bx.shape[1]), np.float32)
        if len(bi):
            rows = (bi[:, None] * bk + np.arange(bk)).ravel()
            b[rows] = bx
        return b, bx.nbytes

    def run(self, task: Task) -> tuple[dict, float, int]:
        """Execute one task; returns (result arrays, work units,
        task-path bytes memcpy'd materializing the operand)."""
        entry = self.tasks.get((task.plan, task.task_row))
        if entry is None:
            raise KeyError(
                f"task (plan {task.plan}, row {task.task_row}) not in this "
                f"worker's shards (have {sorted(self.tasks)})")
        if task.op in ("matvec", "matmat"):
            # (c_pad, t_pad) A_i^T @ (t_pad, width): nonzero tiles only
            operand, copied = self._operand(task.plan, task.payload)
            return {"y": entry["op"](operand)}, entry["work"], copied
        if task.op == "aggregate":
            # combining is the dispatcher's job; the worker's cost is the
            # gradient compute the payload stands for (work from the task)
            return dict(task.payload), float(task.meta.get("work", 1.0)), 0
        raise ValueError(f"unknown op {task.op!r}")


def start_heartbeat(worker_id: int, emit, interval: float,
                    stop: threading.Event, mute=None) -> threading.Thread:
    """Beat ``Heartbeat(worker_id)`` on ``emit`` every ``interval``
    seconds until ``stop`` is set (or the channel dies).  Runs on its
    own daemon thread so long tasks and injected latency never starve
    liveness -- only death, hangs, and shutdown do.  ``mute`` (an
    optional ``mute(worker_id) -> bool``, e.g. a scripted partition
    window) drops individual beats while truthy -- the device is alive
    but unreachable, which is exactly what the dispatcher's suspicion
    path must be exercised against."""

    def beat():
        tick = 0
        while not stop.wait(interval):
            tick += 1
            if mute is not None and mute(worker_id):
                continue
            try:
                emit(Heartbeat(worker=worker_id, tick=tick))
            except Exception:   # channel gone: the pump handles liveness
                return

    t = threading.Thread(target=beat, name=f"cluster-beat-{worker_id}",
                         daemon=True)
    t.start()
    return t


def serve_loop(worker_id: int, inbox: "queue.Queue", emit, faults=None,
               stop_beats: threading.Event | None = None, *, device=None,
               backend: str = "packed") -> str:
    """The shared worker state machine (see module docstring).

    ``inbox`` delivers ``(kind, value)`` messages -- ``shard`` (wire
    bytes or a decoded ``PlanShard``), ``task`` (wire bytes or a
    ``Task``), ``cancel`` (round id), ``stop``.  ``emit`` receives
    ``TaskResult``s.  Returns ``"stop"`` | ``"death"`` | ``"hang"`` so
    the transport runner knows whether to exit cleanly, notify, or park
    with the connection open (a hung edge device does not close its
    socket).  ``device`` and ``backend`` pick the worker's compute path
    (``ShardRuntime``).
    """
    faults = faults if faults is not None else NoFaults()
    runtime = ShardRuntime(device, backend)
    cancelled: set[int] = set()
    pending: list = []
    tasks_done = 0

    @faulty(faults)
    def serve(wid: int, task: Task, done: int) -> TaskResult:
        t0 = time.perf_counter()
        arrays, work, copied = runtime.run(task)
        return TaskResult(worker=wid, round=task.round,
                          task_row=task.task_row, plan=task.plan, ok=True,
                          work=work, compute_s=time.perf_counter() - t0,
                          copied=copied, arrays=arrays)

    def finish(status: str) -> str:
        if stop_beats is not None:
            stop_beats.set()
        return status

    while True:
        kind, val = pending.pop(0) if pending else inbox.get()
        if kind == "stop":
            return finish("stop")
        if kind == "cancel":
            cancelled.add(val)
            continue
        if kind == "welcome":
            continue                    # join confirmation: informational
        if kind == "drop":
            runtime.drop(val)
            continue
        try:
            if kind == "shard":
                runtime.load(PlanShard.decode(val) if isinstance(val, bytes)
                             else val)
                continue
            task: Task = Task.decode(val) if isinstance(val, bytes) else val
            # wire v5 tracing: stamp the task's arrival on this worker's
            # monotonic clock (only when the coordinator traced it --
            # untraced tasks pay a single truthiness check)
            t_recv = time.perf_counter() if task.trace else 0.0
        except Exception as e:
            # garbled frame (ValueError / KeyError / TypeError), or a card
            # worker that cannot place its shard (no device, no kernel
            # library): this worker must not keep serving from a bad
            # state -- notify death instead of crashing the serve thread
            what = "garbled" if isinstance(
                e, (ValueError, KeyError, TypeError)) else "failed"
            try:
                emit(death_notice(worker_id, f"{what} {kind}: {e!r}"))
            except Exception:
                pass
            return finish("death")
        # drain everything already queued so cancels annihilate stale
        # tasks before we burn compute (and injected sleep) on them
        while True:
            try:
                pending.append(inbox.get_nowait())
            except queue.Empty:
                break
        for m in pending:
            if m[0] == "cancel":
                cancelled.add(m[1])
        # round ids are fleet-monotonic, but a requeued task can reach
        # this worker AFTER newer rounds' traffic (its first owner
        # died), so keep a trailing window of old cancels rather than
        # pruning everything below the current round -- the set stays
        # bounded either way
        cancelled = {c for c in cancelled if c >= task.round - 64}
        if task.round in cancelled:
            continue
        try:
            t_start = time.perf_counter()
            res = serve(worker_id, task, tasks_done)
            if task.trace:
                # t_finish is stamped HERE, after ``faulty`` returns, so
                # injected straggler delay lands in the compute segment
                # (compute_s inside ``serve`` measures the BSR product
                # alone) -- attribution pins slow devices from these
                res.trace = task.trace
                res.t_recv = t_recv
                res.t_start = t_start
                res.t_finish = time.perf_counter()
            emit(res)
            tasks_done += 1
        except WorkerHang:
            return finish("hang")           # silent: no notice, no close
        except WorkerFailure as e:
            try:
                emit(death_notice(worker_id, str(e)))
            except Exception:
                pass
            return finish("death")
        except Exception as e:  # defensive: surface, don't hang round
            emit(TaskResult(
                worker=worker_id, round=task.round,
                task_row=task.task_row, plan=task.plan,
                ok=False, error=repr(e)))
