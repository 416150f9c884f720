"""Versioned wire format: compiled plans -> bytes -> workers.

The port of ``repro.cluster.wire``.  Wire v6 is kept byte for byte
(magic, version, json manifest, scatter/gather buffers), so a frame the
JAX package writes loads here and the reverse; only what the frames
hold on either end differs (torch tensors on the plan's device here).

A compiled ``CodedPlan`` is a host-side object (encoding matrices,
packed shards, LRU decode cache); to dispatch it to edge workers it
must cross a pipe.  Three record kinds share one self-describing binary
codec (magic + version + json manifest + raw array blobs -- no pickle,
so a worker never executes shipped code):

  * **full plan** (``dumps_plan`` / ``loads_plan``) -- scheme descriptor
    fields, system matrix, the coded shards *in their original dtype*
    (a bf16 LM head must come back bf16 -- mirroring ``_match_dtype``
    in ``api.plan``), mm-side encoding state, and the decode cache's
    cached straggler patterns so the receiving side re-warms the same
    inverses it had.
  * **per-worker ``PlanShard``** (``shard_plan``) -- the worker's task
    rows as packed BSR tiles (``runtime.pack.bsr_shards``): the worker
    multiplies exactly the nonzero tiles, so its compute cost is
    nnz-proportional (the paper's CSR workers).  Virtual workers are
    round-robined over ``n_workers`` physical hosts; a strong host
    owning several virtual rows is how partial stragglers arise.
  * **task / result messages** (``Task`` / ``TaskResult``) -- the
    per-call traffic: inputs out, per-task products + work accounting
    back.  Task inputs are *support-restricted*: only the x-blocks /
    coded-B block-rows a worker's nonzero tiles actually read travel
    (the paper's communication claim -- per-worker traffic ~ omega/k of
    the dense scheme's); ``record_nbytes`` gives every transport the
    same bytes-on-wire accounting without serializing twice.
  * **liveness messages** (``Heartbeat`` / hello handshake) -- workers
    beat on the same stream results travel on, so the dispatcher
    derives ``done=`` masks from measured liveness (missed heartbeats
    => suspected => requeue) instead of injected fault masks.

Arrays are encoded as (dtype-name, shape, raw bytes).  A record's
arrays may be numpy arrays or torch tensors (on any device: they are
copied to the host).  ``bfloat16`` needs no ``ml_dtypes``: a bf16
tensor is written as its raw 16-bit words under the dtype name
``bfloat16``, exactly the bytes and manifest the JAX package writes,
and a ``bfloat16`` entry decodes to a ``torch.bfloat16`` tensor (a
host copy; every other dtype decodes to a zero-copy numpy view).

Wire v6 splits every record into scatter/gather form: a small framed
header (whose manifest doubles as the explicit buffer count/length
table) plus a list of zero-copy array buffers
(``encode_record_sg`` / ``decode_record_sg``).  The flat codec
(``encode_record`` / ``decode_record``) is a thin gather over it: one
join on encode, ``np.frombuffer`` views on decode -- so a frame crosses
a byte-stream transport with exactly one copy each way.
"""

from __future__ import annotations

import json
import struct
import time
from dataclasses import dataclass, field

import numpy as np
import torch

MAGIC = b"RPRC"
WIRE_VERSION = 6       # v6: scatter/gather framing -- every record
                       # splits into a small header (magic + version +
                       # json manifest, which doubles as the explicit
                       # buffer count/length table) and a list of raw
                       # array buffers, so encoding never calls
                       # ``tobytes()``: ``encode_record_sg`` returns
                       # ``(header, [memoryview, ...])`` and transports
                       # either pass the views through (memory, shm) or
                       # flatten once (``flatten`` -- a single vectored
                       # join, pipe/tcp).  Results optionally carry a
                       # ``copied`` byte count (worker-side memcpy
                       # accounting); absent when zero, so the copy
                       # accounting costs no wire bytes on the
                       # zero-copy paths it exists to assert.
                       # v5: observability -- tasks/results *optionally*
                       # carry a trace id plus worker-side monotonic
                       # timestamps (recv/start/finish), and the hello
                       # handshake samples the sender's clock so the
                       # coordinator can place worker spans on its own
                       # timeline.  All new fields are absent unless
                       # tracing is enabled, so a tracerless v5 peer
                       # decodes traced and untraced frames alike.
                       # v4: elastic membership -- join/leave/welcome
                       # control frames (a worker may dial into a
                       # *running* fleet and be caught up, or drain out
                       # of one), plus drop frames freeing a
                       # re-encoded plan's stale task tables.
                       # v3: plan/round routing fields on shard / task /
                       # result records -- workers co-host several
                       # plans' shards (fleet sessions) and the fleet
                       # dispatcher demuxes results by (plan, round).
                       # v2: heartbeat/hello records, shard col
                       # supports, support-restricted task payloads

_HEADER = struct.Struct("<4sHQ")   # magic, version, manifest length

BF16 = "bfloat16"
# torch dtypes a record may carry, by their numpy (manifest) names
_TORCH_NAMES = {torch.float64: "float64", torch.float32: "float32",
                torch.float16: "float16", torch.int64: "int64",
                torch.int32: "int32", torch.int16: "int16",
                torch.int8: "int8", torch.uint8: "uint8",
                torch.bool: "bool", torch.bfloat16: BF16}


def _np_dtype(name: str) -> np.dtype:
    """The numpy dtype a manifest entry is read as: bf16 as its raw
    16-bit words (numpy has no bf16 of its own)."""
    return np.dtype(np.uint16) if name == BF16 else np.dtype(name)


def _spec(name: str, a) -> dict:
    """One manifest entry, without touching the array's bytes (a 0-d
    array is listed as shape [1], as ``np.ascontiguousarray`` makes it)."""
    shape = list(a.shape) or [1]
    if isinstance(a, torch.Tensor):
        if a.dtype not in _TORCH_NAMES:
            raise TypeError(f"array {name!r}: dtype {a.dtype} has no wire "
                            f"name")
        return {"name": name, "dtype": _TORCH_NAMES[a.dtype],
                "shape": shape, "nbytes": a.numel() * a.element_size()}
    return {"name": name, "dtype": str(a.dtype), "shape": shape,
            "nbytes": a.nbytes}


def _host(a) -> np.ndarray:
    """A record array as a contiguous host numpy array (a tensor is
    copied to the host; bf16 becomes its raw 16-bit words)."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        if a.dtype == torch.bfloat16:
            a = a.view(torch.int16)
        a = a.numpy()
    return np.ascontiguousarray(a)


def _manifest_head(meta: dict, arrays: dict) -> bytes:
    manifest = {"meta": meta, "arrays": [
        _spec(name, a) for name, a in arrays.items()]}
    return json.dumps(manifest, separators=(",", ":")).encode()


def _decoded(spec: dict, arr: np.ndarray):
    """A decoded array: bf16 words become a ``torch.bfloat16`` tensor."""
    if spec["dtype"] == BF16:
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16)
    return arr


def encode_record_sg(meta: dict, arrays: dict | None = None
                     ) -> tuple[bytes, list[memoryview]]:
    """Scatter/gather form of one wire record (wire v6).

    Returns ``(header, buffers)``: the header is the small framed part
    (magic + version + json manifest, whose per-array entries are the
    explicit buffer count/length table), the buffers are zero-copy
    ``memoryview``s of the arrays' raw bytes in manifest order.  No
    host array byte is copied here -- a transport that can carry
    multiple buffers (an in-process queue) ships the views as-is; one
    that needs a single frame calls :func:`flatten` and pays exactly
    one gather copy.
    """
    arrays = arrays or {}
    head = _manifest_head(meta, arrays)
    bufs = [_raw_view(_host(a)) for a in arrays.values()]
    return _HEADER.pack(MAGIC, WIRE_VERSION, len(head)) + head, bufs


def _raw_view(a: np.ndarray) -> memoryview:
    """The contiguous array's bytes, as a view (no copy)."""
    return memoryview(a.reshape(-1).view(np.uint8))


def flatten(header: bytes, buffers: list[memoryview],
            prefix: bytes = b"") -> bytes:
    """Gather a scatter/gather record into one contiguous frame with a
    single join (the one copy a stream transport must pay).  ``prefix``
    lets a length-prefixed framing (tcp) fold its prefix into the same
    join instead of paying a second concatenation copy."""
    return b"".join([prefix, header, *buffers]) if prefix \
        else b"".join([header, *buffers])


def encode_record(meta: dict, arrays: dict | None = None) -> bytes:
    """One flat wire record: json-able ``meta`` + named numpy arrays.
    Single-copy: gathers the scatter/gather form with one join."""
    return flatten(*encode_record_sg(meta, arrays))


def record_nbytes(meta: dict, arrays: dict | None = None) -> int:
    """Exact ``len(encode_record(meta, arrays))`` without copying the
    array payloads -- the bytes-on-wire accounting for transports that
    never serialize (the in-process ``memory`` transport)."""
    arrays = arrays or {}
    return (_HEADER.size + len(_manifest_head(meta, arrays))
            + sum(_spec(n, a)["nbytes"] for n, a in arrays.items()))


def decode_record(data) -> tuple[dict, dict]:
    """Decode one flat frame (``bytes`` or any buffer -- a
    ``memoryview`` decodes in place, arrays stay views)."""
    if len(data) < _HEADER.size:
        raise ValueError(f"truncated wire record: {len(data)} bytes is "
                         f"shorter than the {_HEADER.size}-byte header")
    magic, version, hlen = _HEADER.unpack_from(data, 0)
    if magic != MAGIC:
        raise ValueError("not a repro cluster wire record")
    if version != WIRE_VERSION:
        raise ValueError(f"wire version {version} unsupported "
                         f"(this build speaks {WIRE_VERSION})")
    off = _HEADER.size
    if off + hlen > len(data):
        raise ValueError("truncated wire record: manifest extends past "
                         "the end of the buffer")
    try:
        manifest = json.loads(bytes(data[off: off + hlen]))
        specs = manifest["arrays"]
        meta = manifest["meta"]
    except (ValueError, KeyError, TypeError) as e:
        raise ValueError(f"garbled wire record manifest: {e}") from e
    off += hlen
    arrays = {}
    try:
        for spec in specs:
            if off + spec["nbytes"] > len(data):
                raise ValueError(f"truncated wire record: array "
                                 f"{spec['name']!r} extends past the buffer")
            dt = _np_dtype(spec["dtype"])
            arr = np.frombuffer(data, dtype=dt,
                                count=spec["nbytes"] // dt.itemsize,
                                offset=off).reshape(spec["shape"])
            arrays[spec["name"]] = _decoded(spec, arr)
            off += spec["nbytes"]
    except (KeyError, TypeError, AttributeError) as e:
        raise ValueError(f"garbled wire record manifest: {e!r}") from e
    return meta, arrays


def decode_record_sg(header, buffers) -> tuple[dict, dict]:
    """Decode the scatter/gather form (wire v6): a framed ``header``
    plus one raw buffer per manifest entry.

    The manifest is the buffer table: buffer count and every buffer's
    byte length are checked against it, so a peer that drops, truncates
    or garbles buffers is rejected with the same explicit errors the
    flat codec raises.  Arrays are zero-copy ``np.frombuffer`` views of
    the supplied buffers.
    """
    if len(header) < _HEADER.size:
        raise ValueError(f"truncated wire record: {len(header)} bytes is "
                         f"shorter than the {_HEADER.size}-byte header")
    magic, version, hlen = _HEADER.unpack_from(header, 0)
    if magic != MAGIC:
        raise ValueError("not a repro cluster wire record")
    if version != WIRE_VERSION:
        raise ValueError(f"wire version {version} unsupported "
                         f"(this build speaks {WIRE_VERSION})")
    if _HEADER.size + hlen > len(header):
        raise ValueError("truncated wire record: manifest extends past "
                         "the end of the header")
    try:
        manifest = json.loads(bytes(header[_HEADER.size: _HEADER.size + hlen]))
        specs = manifest["arrays"]
        meta = manifest["meta"]
    except (ValueError, KeyError, TypeError) as e:
        raise ValueError(f"garbled wire record manifest: {e}") from e
    if not isinstance(specs, list) or len(specs) != len(buffers):
        n = len(specs) if isinstance(specs, list) else "?"
        raise ValueError(f"wrong buffer count: manifest lists {n} "
                         f"arrays but the frame carries {len(buffers)} "
                         f"buffers")
    arrays = {}
    try:
        for spec, buf in zip(specs, buffers):
            nbytes = spec["nbytes"]
            got = memoryview(buf).nbytes
            if got != nbytes:
                raise ValueError(
                    f"truncated wire record: buffer for array "
                    f"{spec['name']!r} is {got} bytes, manifest wants "
                    f"{nbytes}")
            dt = _np_dtype(spec["dtype"])
            arrays[spec["name"]] = _decoded(spec, np.frombuffer(
                buf, dtype=dt,
                count=nbytes // dt.itemsize).reshape(spec["shape"]))
    except (KeyError, TypeError, AttributeError) as e:
        raise ValueError(f"garbled wire record manifest: {e!r}") from e
    return meta, arrays


# ---------------------------------------------------------------------------
# Scheme descriptors (plain dataclass fields -- covers hetero schemes too,
# which cannot be rebuilt from a registry name alone)
# ---------------------------------------------------------------------------


def scheme_to_meta(sch) -> dict:
    from ..core.assignment import MMScheme  # noqa: PLC0415 - avoid a cycle

    if isinstance(sch, MMScheme):
        return {"kind": "mm", "name": sch.name, "n": sch.n, "k_A": sch.k_A,
                "k_B": sch.k_B, "s": sch.s, "omega_A": sch.omega_A,
                "omega_B": sch.omega_B,
                "supports_A": [list(t) for t in sch.supports_A],
                "supports_B": [list(t) for t in sch.supports_B],
                "threshold_optimal": sch.threshold_optimal}
    return {"kind": "mv", "name": sch.name, "n": sch.n, "k_A": sch.k_A,
            "s": sch.s, "omega_A": sch.omega_A,
            "supports": [list(t) for t in sch.supports],
            "tasks_per_worker": sch.tasks_per_worker,
            "threshold_optimal": sch.threshold_optimal}


def scheme_from_meta(m: dict):
    from ..core.assignment import MMScheme, MVScheme  # noqa: PLC0415

    if m["kind"] == "mm":
        return MMScheme(
            name=m["name"], n=m["n"], k_A=m["k_A"], k_B=m["k_B"], s=m["s"],
            omega_A=m["omega_A"], omega_B=m["omega_B"],
            supports_A=tuple(tuple(t) for t in m["supports_A"]),
            supports_B=tuple(tuple(t) for t in m["supports_B"]),
            threshold_optimal=m["threshold_optimal"])
    return MVScheme(
        name=m["name"], n=m["n"], k_A=m["k_A"], s=m["s"],
        omega_A=m["omega_A"],
        supports=tuple(tuple(t) for t in m["supports"]),
        tasks_per_worker=m["tasks_per_worker"],
        threshold_optimal=m["threshold_optimal"])


# ---------------------------------------------------------------------------
# Full-plan serialization
# ---------------------------------------------------------------------------


def dumps_plan(plan) -> bytes:
    """Serialize a compiled ``CodedPlan`` (operand-backed or
    aggregation-only).  Dtype-faithful: the coded shards travel in the
    operand dtype the compiler kept them in (a card plan's come to the
    host for it)."""
    meta = {"record": "plan", "kind": plan.kind, "backend": plan.backend,
            "seed": plan.seed, "r": plan.r, "cache_size": plan.cache_size,
            "scheme": scheme_to_meta(plan.scheme)}
    arrays: dict = {"G": np.asarray(plan.G, np.float64)}
    ex = plan.executor
    if ex is not None:
        arrays["coded"] = ex.coded
    if plan._rb is not None:
        arrays["rb"] = np.asarray(plan._rb)
    if plan._sup_b is not None:
        arrays["sup_b"] = plan._sup_b
        arrays["coef_b"] = plan._coef_b
    cache = ex.cache if ex is not None and ex.cache is not None \
        else plan._agg_cache
    if cache is not None and len(cache):
        arrays["cache_patterns"] = cache.patterns()
    return encode_record(meta, arrays)


def loads_plan(data: bytes, backend: str | None = None, device=None):
    """Reconstruct a ``CodedPlan`` from ``dumps_plan`` bytes.

    ``backend=`` overrides the serialized choice.  The plan lands on
    ``device`` as ``compile_plan`` places one: on the card unless
    ``device="cpu"`` is asked for.  A backend the port lacks (a JAX
    package frame's ``pallas``) raises instead of demoting: pass
    ``backend=`` to pick one of the port's.
    """
    from .._device import resolve_device  # noqa: PLC0415 - avoid a cycle
    from ..api.plan import CodedPlan  # noqa: PLC0415
    from ..runtime import BACKENDS, CodedExecutor  # noqa: PLC0415

    meta, arrays = decode_record(data)
    if meta.get("record") != "plan":
        raise ValueError(f"expected a plan record, got {meta.get('record')!r}")
    sch = scheme_from_meta(meta["scheme"])
    resolved = backend or meta["backend"]
    if resolved not in BACKENDS:
        raise ValueError(f"plan backend {resolved!r} is not one of the "
                         f"port's {BACKENDS}; pass backend=")
    dev = resolve_device(device)
    plan = CodedPlan(scheme=sch, kind=meta["kind"], backend=resolved,
                     seed=meta["seed"], G=np.array(arrays["G"]),
                     r=meta["r"], cache_size=meta["cache_size"], device=dev)
    if "rb" in arrays:
        plan._rb = np.array(arrays["rb"])
    if "sup_b" in arrays:
        plan._sup_b = torch.as_tensor(np.array(arrays["sup_b"]), device=dev)
        plan._coef_b = torch.as_tensor(np.array(arrays["coef_b"]),
                                       device=dev)
    if "coded" in arrays:
        coded = arrays["coded"]
        if not isinstance(coded, torch.Tensor):
            coded = torch.from_numpy(np.array(coded))
        plan.executor = CodedExecutor(
            coded.to(dev), plan.G, sch.k, plan.r, backend=resolved,
            cache_size=plan.cache_size, device=dev)
    for pattern in arrays.get("cache_patterns", ()):
        try:
            plan._decode_cache().plan(np.asarray(pattern, bool))
        except (ValueError, np.linalg.LinAlgError):  # pragma: no cover
            continue
    return plan


# ---------------------------------------------------------------------------
# Per-worker shards
# ---------------------------------------------------------------------------


@dataclass
class PlanShard:
    """One physical worker's slice of a compiled plan.

    ``tasks[j]`` holds the BSR components of coded task row
    ``task_rows[j]`` (transposed shard ``A_i^T``, shape
    (c_pad, t_pad), blocksize (bm, bk)); ``work[j]`` is the row's
    nonzero-tile count normalized by the dense tile count -- the
    nnz-proportional work units the fault injectors and the result
    accounting both use.  ``supports[j]`` is the row's *input column
    support*: the sorted t-block indices its nonzero tiles read -- the
    dispatcher ships only those x-blocks / coded-B block-rows per task,
    which is how the paper's omega/k communication claim reaches the
    wire.  Aggregation-only plans ship payload-less shards (the
    worker's job is combining gradients it already has).
    """

    worker: int
    n_workers: int
    task_rows: tuple[int, ...]
    kind: str
    scheme_name: str
    n: int                     # virtual workers
    k: int
    tasks_per_worker: int
    plan: int = 0              # fleet plan id: workers co-host several
                               # plans' shards, keyed by (plan, row)
    t: int = 0
    c: int = 0
    t_pad: int = 0
    c_pad: int = 0
    bk: int = 0
    bm: int = 0
    work: tuple[float, ...] = ()
    supports: tuple[tuple[int, ...], ...] = ()   # per task: t-block cols read
    tasks: list[dict] = field(default_factory=list)   # data/indices/indptr

    def _record_parts(self) -> tuple[dict, dict[str, np.ndarray]]:
        meta = {"record": "shard", "worker": self.worker,
                "n_workers": self.n_workers, "plan": self.plan,
                "task_rows": list(self.task_rows), "kind": self.kind,
                "scheme_name": self.scheme_name, "n": self.n, "k": self.k,
                "tasks_per_worker": self.tasks_per_worker, "t": self.t,
                "c": self.c, "t_pad": self.t_pad, "c_pad": self.c_pad,
                "bk": self.bk, "bm": self.bm, "work": list(self.work),
                "supports": [list(s) for s in self.supports],
                "has_payload": bool(self.tasks)}
        arrays = {}
        for j, task in enumerate(self.tasks):
            for part in ("data", "indices", "indptr"):
                arrays[f"{j}.{part}"] = task[part]
        return meta, arrays

    def encode(self) -> bytes:
        return encode_record(*self._record_parts())

    def encode_sg(self) -> tuple[bytes, list[memoryview]]:
        """Scatter/gather form (wire v6): header + one zero-copy view
        per BSR component, in manifest order -- the shm transport lays
        these straight into a shared segment."""
        return encode_record_sg(*self._record_parts())

    @classmethod
    def decode(cls, data: bytes) -> "PlanShard":
        meta, arrays = decode_record(data)
        if meta.get("record") != "shard":
            raise ValueError(
                f"expected a shard record, got {meta.get('record')!r}")
        tasks = []
        if meta["has_payload"]:
            for j in range(len(meta["task_rows"])):
                tasks.append({part: arrays[f"{j}.{part}"]
                              for part in ("data", "indices", "indptr")})
        return cls(
            worker=meta["worker"], n_workers=meta["n_workers"],
            plan=meta.get("plan", 0),
            task_rows=tuple(meta["task_rows"]), kind=meta["kind"],
            scheme_name=meta["scheme_name"], n=meta["n"], k=meta["k"],
            tasks_per_worker=meta["tasks_per_worker"], t=meta["t"],
            c=meta["c"], t_pad=meta["t_pad"], c_pad=meta["c_pad"],
            bk=meta["bk"], bm=meta["bm"], work=tuple(meta["work"]),
            supports=tuple(tuple(s) for s in meta["supports"]),
            tasks=tasks)


def plan_packed(plan):
    """The packed form cluster workers are shipped (8x8 tiles).

    Reuses the executor's own packing when it is already at the worker
    tile size -- then the shipped BSR components are *bitwise* the ones
    the in-process packed backend multiplies, which is what makes the
    dispatcher-parity acceptance check exact.  A card plan (``cuda``,
    32x32 tiles) is packed again at 8x8 on its device; its shards come
    to the host once, when ``shard_plan`` exports them.
    """
    from ..runtime import pack_coded_blocks  # noqa: PLC0415

    ex = plan.executor
    if ex is None:
        return None
    if ex.packed is not None and (ex.packed.bk, ex.packed.bm) == (8, 8):
        return ex.packed
    return pack_coded_blocks(ex.coded.detach(), 8, 8)


def _host_virtuals(n_virtual: int, w: int,
                   capacities=None) -> list[list[int]]:
    """Virtual-worker ids per physical host.

    Uniform hosts round-robin (``v % w``).  With ``capacities`` (one
    positive int per host) the cut mirrors ``make_hetero_system``'s
    layout exactly: hosts ordered by descending capacity own
    *contiguous* virtual ranges sized proportionally to their capacity
    -- so a hetero scheme's per-device tile groups land on the device
    they were sized for, and a slow host gets proportionally fewer
    coded tiles instead of a 1/w slice it cannot keep up with.
    """
    if capacities is None:
        return [list(range(host, n_virtual, w)) for host in range(w)]
    caps = [int(c) for c in capacities]
    if len(caps) != w or any(c < 1 for c in caps):
        raise ValueError(f"capacities wants {w} ints >= 1, got {capacities}")
    order = sorted(range(w), key=lambda h: (-caps[h], h))
    quota = [0] * w
    # largest-remainder split of n_virtual proportional to capacity,
    # every host guaranteed at least one virtual worker
    total = sum(caps)
    exact = [n_virtual * caps[h] / total for h in order]
    base = [max(1, int(e)) for e in exact]
    while sum(base) > n_virtual:
        base[base.index(max(base))] -= 1
    rema = sorted(range(len(order)), key=lambda i: base[i] - exact[i])
    for i in rema:
        if sum(base) >= n_virtual:
            break
        base[i] += 1
    start = 0
    for h, c in zip(order, base):
        quota[h] = (start, c)
        start += c
    return [list(range(s, s + c)) for s, c in
            (quota[host] for host in range(w))]


def shard_plan(plan, n_workers: int | None = None, packed=None,
               plan_id: int = 0, capacities=None) -> list[PlanShard]:
    """Split a compiled plan into per-physical-worker shards.

    Virtual worker ``v`` (and its ``tasks_per_worker`` task rows) lands
    on physical worker ``v % n_workers``; with fewer hosts than virtual
    workers each host serves several rows sequentially -- the
    partial-straggler setting of Sec. IV-B.  ``capacities`` switches to
    the capacity-proportional contiguous cut (hetero schemes /
    EWMA-measured device speeds -- see ``_host_virtuals``).
    """
    from ..runtime.pack import bsr_shards  # noqa: PLC0415

    n_virtual = plan.n
    per = plan.tasks_per_worker
    w = n_workers if n_workers is not None else n_virtual
    if not 1 <= w <= n_virtual:
        raise ValueError(f"n_workers must be in [1, {n_virtual}], got {w}")
    if packed is None:
        packed = plan_packed(plan)
    if packed is not None:
        ex = plan.executor
        if packed is ex.packed:
            bsr = ex._bsr_shards()
        else:
            bsr = bsr_shards(packed)
        dense_tiles = max((packed.t_pad // packed.bk)
                          * (packed.c_pad // packed.bm), 1)

    by_host = _host_virtuals(n_virtual, w, capacities)
    shards = []
    for host in range(w):
        rows = [v * per + j for v in by_host[host] for j in range(per)]
        if packed is None:
            shards.append(PlanShard(
                worker=host, n_workers=w, task_rows=tuple(rows),
                kind=plan.kind, scheme_name=plan.scheme.name, n=n_virtual,
                k=plan.k, tasks_per_worker=per, plan=plan_id,
                work=tuple(1.0 for _ in rows)))
            continue
        tasks, work, supports = [], [], []
        for row in rows:
            m = bsr[row]
            tasks.append({"data": np.asarray(m.data, np.float32),
                          "indices": np.asarray(m.indices, np.int32),
                          "indptr": np.asarray(m.indptr, np.int64)})
            work.append(packed.tile_counts[row] / dense_tiles)
            # input column support: the t-blocks this row's tiles read
            # (the only x-blocks / coded-B rows a task must ship)
            supports.append(tuple(int(j) for j in np.unique(m.indices)))
        shards.append(PlanShard(
            worker=host, n_workers=w, task_rows=tuple(rows), kind=plan.kind,
            scheme_name=plan.scheme.name, n=n_virtual, k=plan.k,
            tasks_per_worker=per, plan=plan_id, t=packed.t, c=packed.c,
            t_pad=packed.t_pad, c_pad=packed.c_pad, bk=packed.bk,
            bm=packed.bm, work=tuple(work), supports=tuple(supports),
            tasks=tasks))
    return shards


# ---------------------------------------------------------------------------
# Task / result messages
# ---------------------------------------------------------------------------


@dataclass
class Task:
    """One unit of dispatched work: apply op to one coded task row.

    Matvec / matmat payloads come in two forms: dense (``b``: the full
    (t_pad, width) operand) or support-restricted (``bx``: only the
    selected t-block rows, stacked; ``bi``: their block indices) -- the
    worker scatters ``bx`` back into a zero (t_pad, width) buffer, so
    the BSR product is bitwise the dense-shipped one while the wire
    carries omega/k-proportional bytes.

    ``trace`` (wire v5) ties the task to one coordinator-side trace id;
    0 means untraced and the field never reaches the wire, so a traced
    and an untraced frame are byte-identical when tracing is off.
    """

    round: int
    op: str                                   # matvec | matmat | aggregate
    task_row: int
    plan: int = 0                             # fleet plan routing (wire v3)
    trace: int = 0                            # trace id (wire v5; 0 = off)
    payload: dict = field(default_factory=dict)   # name -> np.ndarray
    meta: dict = field(default_factory=dict)

    def _meta(self) -> dict:
        meta = {"record": "task", "round": self.round, "op": self.op,
                "task_row": self.task_row, "plan": self.plan,
                "meta": self.meta}
        if self.trace:
            meta["trace"] = self.trace
        return meta

    def encode(self) -> bytes:
        return encode_record(self._meta(), self.payload)

    def encode_sg(self) -> tuple[bytes, list[memoryview]]:
        """Scatter/gather form (wire v6): header + zero-copy payload
        views.  ``flatten(*task.encode_sg())`` == ``task.encode()``."""
        return encode_record_sg(self._meta(), self.payload)

    def nbytes(self) -> int:
        """Wire size of ``encode()`` without serializing the payload."""
        return record_nbytes(self._meta(), self.payload)

    @classmethod
    def decode(cls, data: bytes) -> "Task":
        meta, arrays = decode_record(data)
        if meta.get("record") != "task":
            raise ValueError(
                f"expected a task record, got {meta.get('record')!r}")
        return cls(round=meta["round"], op=meta["op"],
                   task_row=meta["task_row"], plan=meta.get("plan", 0),
                   trace=meta.get("trace", 0),
                   payload=arrays, meta=meta["meta"])


@dataclass
class TaskResult:
    """A worker's answer for one task -- or its death notice.

    ``kind="death"`` (task_row -1, round -1) marks worker fail-stop;
    the dispatcher responds by re-shipping the dead worker's shard to a
    live host and requeueing its outstanding tasks.

    Traced results (wire v5: ``trace`` nonzero) additionally carry the
    worker-side monotonic stamps ``t_recv`` (task materialized off the
    inbox), ``t_start`` (compute began) and ``t_finish`` (serve
    returned, fault delays included) -- the coordinator shifts them by
    the hello clock offset and decomposes the round into queue / wire /
    compute segments.  All three stay off the wire when untraced.
    """

    worker: int
    round: int
    task_row: int
    plan: int = 0                              # fleet plan routing (wire v3)
    ok: bool = True
    kind: str = "result"                       # result | death
    error: str = ""
    work: float = 0.0
    compute_s: float = 0.0
    trace: int = 0                             # trace id (wire v5; 0 = off)
    t_recv: float = 0.0                        # worker clock (wire v5)
    t_start: float = 0.0
    t_finish: float = 0.0
    copied: int = 0                            # worker-side bytes memcpy'd
                                               # (wire v6; 0 = off the wire)
    arrays: dict = field(default_factory=dict)

    def _meta(self) -> dict:
        meta = {"record": "result", "worker": self.worker,
                "round": self.round, "task_row": self.task_row,
                "plan": self.plan, "ok": self.ok, "kind": self.kind,
                "error": self.error, "work": self.work,
                "compute_s": self.compute_s}
        if self.trace:
            meta["trace"] = self.trace
            meta["t_recv"] = self.t_recv
            meta["t_start"] = self.t_start
            meta["t_finish"] = self.t_finish
        if self.copied:
            meta["copied"] = self.copied
        return meta

    def encode(self) -> bytes:
        return encode_record(self._meta(), self.arrays)

    def encode_sg(self) -> tuple[bytes, list[memoryview]]:
        """Scatter/gather form (wire v6): header + zero-copy result
        views, for transports that never flatten."""
        return encode_record_sg(self._meta(), self.arrays)

    def nbytes(self) -> int:
        """Wire size of ``encode()`` without serializing the arrays."""
        return record_nbytes(self._meta(), self.arrays)

    @classmethod
    def decode(cls, data: bytes) -> "TaskResult":
        meta, arrays = decode_record(data)
        if meta.get("record") != "result":
            raise ValueError(
                f"expected a result record, got {meta.get('record')!r}")
        return cls(worker=meta["worker"], round=meta["round"],
                   task_row=meta["task_row"], plan=meta.get("plan", 0),
                   ok=meta["ok"], kind=meta["kind"], error=meta["error"],
                   work=meta["work"], compute_s=meta["compute_s"],
                   trace=meta.get("trace", 0),
                   t_recv=meta.get("t_recv", 0.0),
                   t_start=meta.get("t_start", 0.0),
                   t_finish=meta.get("t_finish", 0.0),
                   copied=meta.get("copied", 0),
                   arrays=arrays)


def death_notice(worker: int, error: str) -> TaskResult:
    return TaskResult(worker=worker, round=-1, task_row=-1, ok=False,
                      kind="death", error=error)


# ---------------------------------------------------------------------------
# Liveness / control messages (the transport-uniform event stream)
# ---------------------------------------------------------------------------


@dataclass
class Heartbeat:
    """Periodic liveness beat a worker emits on its result stream.

    The dispatcher stamps arrival times per worker; a worker that stops
    beating for ``suspect_after`` seconds while owning outstanding task
    rows is *suspected* and handled exactly like fail-stop (shard
    re-shipped, rows requeued) -- liveness is measured, never injected.
    """

    worker: int
    tick: int = 0

    def encode(self) -> bytes:
        return encode_record({"record": "beat", "worker": self.worker,
                              "tick": self.tick})


@dataclass
class WorkerJoin:
    """Membership event: a worker (re)joined the transport (wire v4).

    Transports surface every membership gain -- a spawned addition, a
    remote ``--connect`` dial into a *running* fleet, a healed
    partition's reconnect -- as this event on the uniform stream; the
    fleet dispatcher answers by catching the worker up (digest-verified
    shard ship for every attached plan, rebalanced off the most-loaded
    hosts) and confirming with a welcome frame.
    """

    worker: int
    capacity: int = 1          # device speed hint (1 = baseline)

    def encode(self) -> bytes:
        return encode_record({"record": "join", "worker": self.worker,
                              "capacity": self.capacity})


@dataclass
class WorkerLeave:
    """Membership event: a worker asked to leave gracefully (wire v4).

    Unlike a death notice this is *drain-before-remove*: the fleet
    stops routing new rows to the worker, waits for its in-flight rows
    (bounded), re-homes its shards, and only then tears the channel
    down -- no requeue storm, no suspicion.
    """

    worker: int
    reason: str = ""

    def encode(self) -> bytes:
        return encode_record({"record": "leave", "worker": self.worker,
                              "reason": self.reason})


def hello_record(worker: int, *, join: bool = False) -> bytes:
    """Per-connection handshake: the wire version travels in the record
    header (so a mismatched peer is rejected at decode), the worker id
    in the meta.  Socket transports send this as their first frame;
    ``join=True`` marks a live join into an already-running fleet
    (v4 -- a coordinator accepts it for ids it has never seen).

    ``clock`` (wire v5) samples the sender's ``time.perf_counter`` at
    send time: the coordinator subtracts it from its own receive stamp
    to estimate the per-worker clock offset (error is one-way hello
    latency), which places worker-side task timestamps on the
    coordinator timeline."""
    return encode_record({"record": "hello", "worker": worker,
                          "wire_version": WIRE_VERSION, "join": bool(join),
                          "clock": time.perf_counter()})


def welcome_record(worker: int, plans: int = 0) -> bytes:
    """Coordinator -> worker join confirmation (wire v4): sent after
    shard catch-up, echoing how many attached plans were shipped."""
    return encode_record({"record": "welcome", "worker": worker,
                          "plans": plans})


def drop_record(plan_id: int) -> bytes:
    """Free one plan's task tables on a worker (wire v4): sent when the
    fleet re-encodes a plan under a fresh plan id, so stale shards do
    not accumulate on long-lived devices."""
    return encode_record({"record": "drop", "plan": plan_id})


def control_record(record: str, **meta) -> bytes:
    """A payload-less control frame (``cancel``, ``stop``, ``shard-ack``)."""
    return encode_record({"record": record, **meta})


def decode_event(data: bytes):
    """Decode one frame of the worker->dispatcher stream.

    Returns a ``TaskResult``, ``Heartbeat``, ``WorkerJoin`` or
    ``WorkerLeave``; control records (``shard-ack``, ``hello``,
    ``welcome``) come back as their plain meta dict.  This is the
    single demux every transport's pump uses, so the dispatcher sees
    one uniform event stream no matter what carried the bytes.
    """
    meta, arrays = decode_record(data)
    rec = meta.get("record") if isinstance(meta, dict) else None
    try:
        if rec == "result":
            return TaskResult(worker=meta["worker"], round=meta["round"],
                              task_row=meta["task_row"],
                              plan=meta.get("plan", 0), ok=meta["ok"],
                              kind=meta["kind"], error=meta["error"],
                              work=meta["work"], compute_s=meta["compute_s"],
                              trace=meta.get("trace", 0),
                              t_recv=meta.get("t_recv", 0.0),
                              t_start=meta.get("t_start", 0.0),
                              t_finish=meta.get("t_finish", 0.0),
                              copied=meta.get("copied", 0),
                              arrays=arrays)
        if rec == "beat":
            return Heartbeat(worker=meta["worker"], tick=meta["tick"])
        if rec == "join":
            return WorkerJoin(worker=meta["worker"],
                              capacity=meta.get("capacity", 1))
        if rec == "leave":
            return WorkerLeave(worker=meta["worker"],
                               reason=meta.get("reason", ""))
    except KeyError as e:   # parses but fields are missing: still garbled
        raise ValueError(f"garbled {rec} record: missing {e}") from e
    if rec in ("shard-ack", "hello", "welcome"):
        return meta
    raise ValueError(f"unexpected event record {rec!r}")
