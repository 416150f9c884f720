"""Shared-memory transport: co-located workers, zero-copy payloads (the
port of ``repro.cluster.transport.shm``).

Worker children are spawned subprocesses (the pipe transport's control
channel, pumps, liveness, reports and membership machinery are
inherited wholesale), but *payload bytes never cross the pipe*:

  * **shards land once** -- ``ship_shard`` writes the wire-v6 shard
    frame into a ``multiprocessing.shared_memory`` segment and sends
    only the segment name; the child maps it and decodes in place (a
    host child's BSR operators are ``np.frombuffer`` views straight into
    ``/dev/shm``; a card child re-tiles the components onto its device).
  * **operands are built in place** -- the fleet asks
    ``alloc_operand`` for the round's operand buffer and pads/
    concatenates directly into a fresh segment, so the one copy every
    transport pays to *build* the operand already lands in shared
    memory.  ``submit`` then ships a header-only task frame whose meta
    carries ``(segment, offset, dtype, shape)`` references -- task
    bytes copied per call is the header, not the payload.  A card child
    uploads the referenced view to its device.
  * **results write into a per-round slab** -- ``prepare_results``
    carves one segment per round with a fixed offset per task row; the
    child writes ``y`` there (a card child copies it from the device
    straight into the slab) and sends an array-less result frame, and
    the coordinator pump re-materializes ``y`` as a zero-copy view for
    the dispatcher to decode.  ``finish_round`` unlinks the round's
    segments once the fleet is done with them.

Segment lifecycle is coordinator-owned: only this process ever
*creates* or *unlinks* segments; children merely attach, and keep their
maps for the process's lifetime (host BSR operators hold views into
them; a card child keeps them too, for one code path).  Spawn children
share the coordinator's ``resource_tracker`` process, so the attach-side
registration is an idempotent duplicate of the create-side one.
``close`` releases every live segment, which is what the ``/dev/shm``
leak checks assert.  No segment is pinned for the device
(``cudaHostRegister``): a card child's upload reads pageable memory.

Faults, garbling, heartbeats, live join/leave and the EOF death path
are untouched pipe behavior -- the C(n, s) parity sweep and the chaos
harness run on ``shm`` exactly as on the other transports.
"""

from __future__ import annotations

import gc
import itertools
import os
import queue
import threading
import time
import weakref
from multiprocessing import shared_memory

import numpy as np
import torch

from ..faults import from_spec
from ..wire import PlanShard, Task, TaskResult, decode_record
from ..worker import (prepare_device, serve_loop, start_heartbeat,
                      worker_report)
from .pipe import PipeTransport

_REF_META = "shm"          # task meta key: payload refs
_RES_META = "shm_res"      # task meta key: result-slab ref


def _attach(segs: dict, name: str) -> shared_memory.SharedMemory:
    """Child-side segment map cache.  The coordinator owns every
    segment's lifetime.  Python registers attached segments with the
    resource tracker too, but spawn children inherit the coordinator's
    tracker process, whose name cache is a set -- the child-side
    register is an idempotent duplicate of the create-side one, and the
    coordinator's unlink unregisters it.  (Unregistering here instead
    would strip the coordinator's own registration and leak the segment
    if it crashed before unlink.)  Maps are kept for the process
    lifetime -- host BSR operators hold views into them."""
    shm = segs.get(name)
    if shm is None:
        shm = shared_memory.SharedMemory(name=name)
        segs[name] = shm
    return shm


def _seg_view(segs: dict, ref) -> np.ndarray:
    seg, off, dtype, shape = ref
    shm = _attach(segs, seg)
    dt = np.dtype(dtype)
    count = int(np.prod(shape)) if shape else 1
    return np.frombuffer(shm.buf, dtype=dt, count=count,
                         offset=int(off)).reshape(shape)


def _shm_worker_main(conn, worker_id: int, fault_spec, heartbeat_s: float,
                     device: str = "cpu", backend: str = "packed") -> None:
    """Child entry point: the pipe child with a ref-resolving pump.

    Tasks arrive as header-only frames; the pump maps the referenced
    segments and hands ``serve_loop`` a ``Task`` whose payload entries
    are zero-copy views.  Results with a slab ref are written into the
    shared slab and travel back array-less.  A card child creates its
    CUDA context and loads the kernel library before it reports ready.
    """
    t_entry = time.perf_counter()
    faults = from_spec(fault_spec)
    prepare_device(device, backend)
    inbox: queue.Queue = queue.Queue()
    send_lock = threading.Lock()
    parked = threading.Event()
    segs: dict[str, shared_memory.SharedMemory] = {}
    res_refs: dict[tuple[int, int], list] = {}   # (round, row) -> slab ref

    def emit(event) -> None:
        if isinstance(event, TaskResult) and event.kind == "result" \
                and event.ok and "y" in event.arrays:
            y = event.arrays["y"]
            ref = res_refs.pop((event.round, event.task_row), None)
            if ref is not None:
                dst = _seg_view(segs, ref)
                if isinstance(y, torch.Tensor):
                    # a card task's y: device -> slab, one copy
                    torch.from_numpy(dst).copy_(y)
                else:
                    dst[...] = np.asarray(y, dst.dtype)
                event.arrays = {}       # bytes live in the slab now
            elif isinstance(y, torch.Tensor):
                event.arrays = {"y": y.cpu().numpy()}
        with send_lock:
            conn.send(("event", event.encode()))

    def pump() -> None:
        try:
            while True:
                kind, data = conn.recv()
                if kind == "report":    # control channel, not the serve loop
                    with send_lock:
                        conn.send(("report", worker_report(device, backend)))
                    continue
                if kind == "stop":
                    parked.set()
                elif kind == "shard" and isinstance(data, tuple) \
                        and data and data[0] == _REF_META:
                    # shard frame lives in a segment: decode in place
                    try:
                        shm = _attach(segs, data[1])
                    except FileNotFoundError:
                        # released before this child mapped it: a newer
                        # ship of the same shard is behind it on the
                        # pipe, or the plan or this worker left
                        continue
                    inbox.put(("shard",
                               PlanShard.decode(shm.buf[:int(data[2])])))
                    continue
                elif kind == "task" and isinstance(data, bytes):
                    try:
                        task = Task.decode(data)
                        for aname, ref in (task.meta.get(_REF_META)
                                           or {}).items():
                            task.payload[aname] = _seg_view(segs, ref)
                        res = task.meta.get(_RES_META)
                        if res is not None:
                            res_refs[(task.round, task.task_row)] = res
                            # bounded: drop refs rounds behind (the
                            # same trailing window serve_loop keeps
                            # for cancels)
                            for key in [k for k in res_refs
                                        if k[0] < task.round - 64]:
                                del res_refs[key]
                    except FileNotFoundError:
                        # segment already unlinked: the round resolved
                        # without us -- surface, never compute garbage
                        emit(TaskResult(
                            worker=worker_id, round=-1, task_row=-1,
                            ok=False, error="shm segment gone "
                            "(round already resolved)"))
                        continue
                    except (ValueError, KeyError, TypeError):
                        # garbled frame: let serve_loop's decode path
                        # raise and answer with the death notice
                        inbox.put(("task", data))
                        continue
                    inbox.put(("task", task))
                    continue
                inbox.put((kind, data))
        except (EOFError, OSError):
            parked.set()
            inbox.put(("stop", None))

    with send_lock:                     # ready, with the start-up times
        conn.send(("hello", (worker_id, time.perf_counter(),
                             time.perf_counter() - t_entry, t_entry)))
    threading.Thread(target=pump, daemon=True).start()
    stop_beats = threading.Event()
    start_heartbeat(worker_id, emit, heartbeat_s, stop_beats,
                    mute=getattr(faults, "should_mute", None))
    try:
        status = serve_loop(worker_id, inbox, emit, faults,
                            stop_beats=stop_beats, device=device,
                            backend=backend, host_results=False)
    except (BrokenPipeError, OSError):
        return
    if status == "hang":
        parked.wait()
        os._exit(0)


class ShmTransport(PipeTransport):
    name = "shm"
    # one dense operand region serves every task of a round (workers
    # view the same segment), so the fleet skips per-task
    # support-restriction -- bytes-on-wire for a task is its header
    prefers_dense_payload = True
    # the child entry point ``PipeTransport._spawn`` starts
    _child_main = staticmethod(_shm_worker_main)

    _ids = itertools.count()

    def __init__(self, n_workers: int, *, faults=None,
                 heartbeat_s: float = 0.25, device=None,
                 backend: str = "packed"):
        super().__init__(n_workers, faults=faults, heartbeat_s=heartbeat_s,
                         device=device, backend=backend)
        self.prefix = f"repro{os.getpid()}x{next(self._ids)}"
        self._seq = itertools.count()
        # reentrant: weakref finalizers (unclaimed-slab cleanup) may
        # fire from a gc triggered inside a locked region
        self._lock = threading.RLock()
        # addr -> (shm, nbytes): operand slabs handed to the fleet but
        # not yet claimed by a submitted round
        self._operands: dict[int, tuple] = {}
        # round -> [shm, ...]: operand segments a round's tasks reference
        self._round_segs: dict[int, list] = {}
        # round -> (shm, {row: offset}, shape, dtype): result slabs
        self._results: dict[int, tuple] = {}
        # (worker, plan) -> shm: shipped shard frames
        # (worker, plan, task rows) -> the shard's segment
        self._shard_segs: dict[tuple[int, int, tuple], object] = {}
        self._deferred: list = []       # close() raced a live view

    # -- segment plumbing ---------------------------------------------------

    def _new_seg(self, nbytes: int) -> shared_memory.SharedMemory:
        return shared_memory.SharedMemory(
            name=f"{self.prefix}n{next(self._seq)}",
            create=True, size=max(int(nbytes), 1))

    def _release(self, shm) -> None:
        """Unlink (drops the /dev/shm entry) and close.  A close racing
        a still-referenced view defers -- the name is already gone, the
        map goes when the last view does (retried on later releases)."""
        try:
            shm.unlink()
        except FileNotFoundError:       # already released
            pass
        try:
            shm.close()
        except BufferError:
            self._deferred.append(shm)

    def _retry_deferred(self) -> None:
        still = []
        for shm in self._deferred:
            try:
                shm.close()
            except BufferError:
                still.append(shm)
        self._deferred = still

    # -- zero-copy hooks (wire v6) ------------------------------------------

    def alloc_operand(self, shape, dtype):
        """A zero-filled array in a fresh shared segment for the fleet
        to build the round's operand in place (fresh POSIX segments are
        zero pages, so no fill copy).  Claimed by the round that first
        submits it; unclaimed slabs are freed on close."""
        dt = np.dtype(dtype)
        nbytes = int(np.prod(shape)) * dt.itemsize
        shm = self._new_seg(nbytes)
        arr = np.frombuffer(shm.buf, dtype=dt,
                            count=nbytes // dt.itemsize).reshape(shape)
        addr = arr.__array_interface__["data"][0]
        with self._lock:
            self._operands[addr] = (shm, nbytes)
        # backstop: a slab whose call never launched (rebuilt under a
        # fresh plan, microbatch concatenation superseded it) is freed
        # when the fleet drops the array, not at close
        weakref.finalize(arr, self._drop_unclaimed, addr, shm)
        return arr

    def _drop_unclaimed(self, addr: int, shm) -> None:
        with self._lock:
            entry = self._operands.pop(addr, None)
        if entry is not None:
            self._release(shm)

    def _payload_ref(self, arr, round_id: int):
        """Resolve a payload array to a (segment, offset, dtype, shape)
        ref when it is a view of a slab this transport allocated; the
        slab is claimed for ``round_id`` on first resolution."""
        if not isinstance(arr, np.ndarray) or not arr.flags["C_CONTIGUOUS"]:
            return None
        addr = arr.__array_interface__["data"][0]
        with self._lock:
            for base, (shm, nbytes) in self._operands.items():
                if base <= addr and addr + arr.nbytes <= base + nbytes:
                    del self._operands[base]
                    self._round_segs.setdefault(round_id, []).append(shm)
                    return [shm.name, addr - base, str(arr.dtype),
                            list(arr.shape)]
            for rshm in self._round_segs.get(round_id, ()):
                buf_addr = np.frombuffer(
                    rshm.buf, np.uint8).__array_interface__["data"][0]
                if buf_addr <= addr and \
                        addr + arr.nbytes <= buf_addr + rshm.size:
                    return [rshm.name, addr - buf_addr, str(arr.dtype),
                            list(arr.shape)]
        return None

    def prepare_results(self, round_id: int, rows, shape, dtype) -> None:
        rows = [int(r) for r in rows]
        dt = np.dtype(dtype)
        rowbytes = int(np.prod(shape)) * dt.itemsize
        shm = self._new_seg(max(len(rows), 1) * rowbytes)
        offsets = {r: j * rowbytes for j, r in enumerate(rows)}
        with self._lock:
            self._results[round_id] = (shm, offsets, tuple(shape), str(dt))

    def finish_round(self, round_id: int) -> None:
        with self._lock:
            segs = self._round_segs.pop(round_id, [])
            res = self._results.pop(round_id, None)
        for shm in segs:
            self._release(shm)
        if res is not None:
            self._release(res[0])
        self._retry_deferred()

    # -- Transport interface ------------------------------------------------

    def ship_shard(self, worker: int, blob: bytes) -> int:
        """Land the shard frame in a segment once; the pipe carries the
        name.  The child decodes in place, so the single staging write
        here is the only copy a shard pays on the host."""
        try:
            meta, _ = decode_record(blob)
            plan_id = int(meta.get("plan", 0))
            rows = tuple(int(r) for r in meta.get("task_rows", ()))
        except (ValueError, KeyError, TypeError):
            plan_id, rows = -1, ()
        shm = self._new_seg(len(blob))
        shm.buf[: len(blob)] = blob
        self.bytes_copied += len(blob)
        # keyed by the shard itself: an heir that inherits a dead
        # worker's rows of a plan keeps the segment of its own rows
        # (keyed by worker and plan alone, the inherited shard released
        # the heir's segment, and a child that had not mapped it yet
        # died on the missing name)
        key = (worker, plan_id, rows)
        with self._lock:
            old = self._shard_segs.pop(key, None)
            self._shard_segs[key] = shm
        if old is not None:             # re-ship replaces (retune/requeue)
            self._release(old)
        self._send(worker, ("shard", (_REF_META, shm.name, len(blob))))
        return len(blob)

    def submit(self, worker: int, task: Task) -> int:
        refs = {}
        inline = {}
        for name, arr in task.payload.items():
            ref = self._payload_ref(np.asarray(arr), task.round)
            if ref is not None:
                refs[name] = ref
            else:
                inline[name] = arr      # e.g. aggregate leaves
        meta = dict(task.meta)
        if refs:
            meta[_REF_META] = refs
        with self._lock:
            res = self._results.get(task.round)
        if res is not None and task.task_row in res[1]:
            shm, offsets, shape, dts = res
            meta[_RES_META] = [shm.name, offsets[task.task_row],
                               dts, list(shape)]
        framed = Task(round=task.round, op=task.op, task_row=task.task_row,
                      plan=task.plan, trace=task.trace, payload=inline,
                      meta=meta)
        data = framed.encode()
        # header-only when every payload array resolved to a segment:
        # the flatten join is the task path's whole memcpy
        self.bytes_copied += len(data)
        self._send(worker, ("task", data))
        # bytes-on-wire stays the real frame size (refs, not payloads)
        return len(data)

    def push_event(self, event) -> None:
        """Re-materialize slab-backed results as zero-copy views before
        the dispatcher sees them -- the fleet decodes shm rounds
        exactly like any other transport's."""
        if isinstance(event, TaskResult) and event.kind == "result" \
                and event.ok and not event.arrays:
            with self._lock:
                res = self._results.get(event.round)
            if res is not None and event.task_row in res[1]:
                shm, offsets, shape, dts = res
                dt = np.dtype(dts)
                count = int(np.prod(shape)) if shape else 1
                event.arrays = {"y": np.frombuffer(
                    shm.buf, dtype=dt, count=count,
                    offset=offsets[event.task_row]).reshape(shape)}
        super().push_event(event)

    def drop_plan(self, worker: int, plan_id: int) -> None:
        super().drop_plan(worker, plan_id)
        with self._lock:
            mine = [key for key in self._shard_segs
                    if key[:2] == (worker, plan_id)]
            segs = [self._shard_segs.pop(key) for key in mine]
        for shm in segs:
            self._release(shm)

    def remove_worker(self, worker: int) -> None:
        super().remove_worker(worker)
        with self._lock:
            mine = [key for key in self._shard_segs if key[0] == worker]
            segs = [self._shard_segs.pop(key) for key in mine]
        for shm in segs:
            self._release(shm)

    def close(self) -> None:
        if self._closing:
            return
        super().close()
        with self._lock:
            leftovers = (
                [shm for shm, _ in self._operands.values()]
                + [shm for segs in self._round_segs.values()
                   for shm in segs]
                + [res[0] for res in self._results.values()]
                + list(self._shard_segs.values()))
            self._operands.clear()
            self._round_segs.clear()
            self._results.clear()
            self._shard_segs.clear()
        for shm in leftovers:
            self._release(shm)
        # anything a live view pinned: the names are unlinked already,
        # drop the maps once the views are collectable
        gc.collect()
        self._retry_deferred()
