#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA Hopper card.

    python3 chip_smoke.py [--seed N]

Phases, one JSON line each:

  0. device -- the card's name and power limit (``nvidia-smi``) and its
     compute capability;
  1. build  -- the three CUDA kernels built from ``src/repro_torch/
     kernels/csrc`` (or loaded from ``build/repro_torch/``);
  3. mv     -- the coded LM head of phi3-mini-3.8b: ``compile_plan`` over
     a random (3072, 32064) head with ``CodedConfig``'s defaults (n=16
     workers, s=2 stragglers, Alg. 1), then ``plan.matvec`` for a decode
     step of 8 requests under the all-alive and three random straggler
     patterns, in f32 and with the head in bf16, held against A^T x in
     f64 on the card;
  4. mm     -- the paper's Fig. 4 system (n=20, k_A=k_B=4, s=4) over
     (8192, 4096) operands with 98% of their 32x32 tiles zero:
     ``plan.matmat`` under two random straggler patterns, held against
     A^T B in f64;
  2. kernels -- after each of phases 3 and 4, every kernel held against
     its plain PyTorch version on the inputs that phase passes it (the
     encode on ``split_block_columns``' strided view; the matmat's one
     grouped ``bcsr_matmul`` over the k live workers, and one worker
     alone, each with the f32 coded B a plan's matmat passes; the decode
     in the layouts of matvec (mv), matmat (mm) and ``decode`` (gather)),
     in f32 and with bf16 shards, with its time, the plain version's, one
     PyTorch library call's, and the least time the card could take
     (the bound: bytes over 3.35 TB/s, or flops over 67 TFLOP/s f32 and
     989 TFLOP/s for a bf16 x bf16 product).  Decode rows add a second
     yardstick, ``torch.matmul`` followed by the rearrangement the
     executor did before the decode stored its layout itself, and
     ``device_ms``, the kernel's own duration in a ``torch.profiler``
     trace, which sets device time apart from the host's issue rate;
  5. census -- one matvec and one matmat under ``torch.profiler``: every
     device kernel they launch, in order, and the device's busy share of
     the call's p50 wall time.  The decode must be the last kernel: no
     copy or permute follows it;
  6. serve  -- the port's serving path at phi3-mini-3.8b's full width,
     through ``repro_torch.launch.serve``'s own steps with the launcher's
     defaults: the bf16 model built and drawn from ``--seed`` on the card,
     the engine with its coded LM head (n=6, s=2), 8 requests in waves of
     4, 16 new tokens, and the launcher's coded-head check; then the
     checks: prefill and decode logits against a fresh forward (bf16, and
     in f32 on the same weights), the coded head against ``hidden @
     head`` in f64 under 5 of the engine's own straggler masks (with
     kappa), the launch counts (1 ``cyclic_encode`` at build, none while
     serving, 1 ``bcsr_matmul`` + 1 ``decode_matmul`` per coded call), a
     ``census`` of one coded call, and the three kernels at this geometry;
  7. cluster -- the edge cluster (``repro_torch.cluster``) with card
     workers, on the serve phase's model: the engine in cluster mode
     (``CodedConfig(cluster=True, transport="memory")``, n=6, s=2, 6
     workers) under 5 explicit engine masks, held against the in-process
     engine (f32, 2e-5 of max|ref|, bitwise or not) and ``hidden @ head``
     in f64 (with kappa), 20 rounds for the p50, ``decode_s`` and task
     bytes; the Fig. 4 matmat over ``to_cluster(transport="memory")``
     (n=20, k_A=k_B=4, 98% zero tiles) against the in-process ``cuda``
     matmat and f64; the head over ``to_cluster(transport="pipe")``,
     ``nvidia-smi``'s compute apps shown beside the children; one racing
     round (``done=None``) under ``StragglerFaults``; then
     ``bcsr_matmul`` on one worker task of the head and the fleet's
     decode, each against its plain version, and a ``census`` of one
     cluster round (both taken before the mm path; the decode's trace is
     taken again, whole, after the pipe path and the race).  Launches: k ``bcsr_matmul`` + 1 ``decode_matmul``
     per engine call, 1 ``cyclic_encode`` + k + 1 per matmat, 1
     ``decode_matmul`` per pipe call in the parent and k ``bcsr_matmul``
     in the children (each child reports its own counts over the pipe's
     control channel, with its pid, its card and the device memory its
     shard holds), 1 ``cyclic_encode`` at the engine's build.  Every
     clean round has no death, requeue or suspicion.

Launch counters are set to 0 just before each main path (mv, mm,
serve, cluster) and read just after: every encode must have gone through
``cyclic_encode``, every worker product through ``bcsr_matmul`` (one
launch per matvec and per matmat) and every decode through
``decode_matmul`` (one per matvec, matmat and ``decode``).  Any failure raises and exits non-zero.  The
last three lines are the kernel table, the ``nvidia-smi`` line and
``{"ok": true, "device": {...}}``.

With ``--parent DIR`` (another checkout, e.g. the parent commit's) it
also runs ``scripts/ab_smoke.py``: matvec and matmat p50 of that
checkout and of this one, in turns (parent, change, change, parent), on
this card, one ``ab`` line per run and a summary.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.api import compile_plan  # noqa: E402
from repro_torch.cluster import StragglerFaults  # noqa: E402
from repro_torch.cluster.wire import PlanShard  # noqa: E402
from repro_torch.cluster.worker import CardTask  # noqa: E402
from repro_torch.configs.base import CodedConfig  # noqa: E402
from repro_torch.core.coded_matmul import split_block_columns  # noqa: E402
from repro_torch.core.encoding import mv_encoding_matrix  # noqa: E402
from repro_torch.kernels import (  # noqa: E402
    _build,
    bcsr_matmul,
    bcsr_matmul_plain,
    cyclic_encode,
    cyclic_encode_plain,
    decode_matmul,
    decode_matmul_plain,
    launch_counts,
    reset_launch_counts,
)
from repro_torch.kernels.decode_matmul import (  # noqa: E402
    launch_decode,
    prepare_decode,
)
from repro_torch.launch import serve as launcher  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.runtime import encode_blocks, support_tables  # noqa: E402
from repro_torch.runtime.pack import unpack_coded_blocks  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet): HBM3 rate, f32 FFMA rate, and the
# dense bf16 tensor-core rate, the least time a bf16 x bf16 product needs
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12
# tolerances of tests/test_kernels.py (allclose: |a-b| <= atol + rtol|b|)
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# end-to-end relative error bounds (examples/quickstart.py asserts 1e-3)
REL = {torch.float32: 1e-3, torch.bfloat16: 2e-2}

# what each kernel's CUDA functions are called in a profiler trace
TRACE_NAMES = {
    "bcsr_matmul": ("bcsr_narrow_kernel", "bcsr_wide_kernel"),
    "cyclic_encode": ("cyclic_encode_kernel",),
    "decode_matmul": ("decode_rows_kernel", "decode_transposed_kernel"),
}

SOURCES = {
    "bcsr_matmul": ("src/repro_torch/kernels/csrc/bcsr_matmul.cu",
                    "src/repro/kernels/bcsr_matmul.py:50"),
    "cyclic_encode": ("src/repro_torch/kernels/csrc/cyclic_encode.cu",
                      "src/repro/kernels/cyclic_encode.py:39"),
    "decode_matmul": ("src/repro_torch/kernels/csrc/decode_matmul.cu",
                      "src/repro/kernels/decode_matmul.py:27"),
}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def host_p50_ms(fn, reps: int) -> float:
    """Median host wall time of ``fn`` ending in a device synchronise."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def rel_err(out: torch.Tensor, ref: torch.Tensor) -> float:
    return float((out.double() - ref).abs().max() / ref.abs().max())


def bound(nbytes: float, flops: float, flops_per_s: float
          ) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def peak_rate(*operands: torch.Tensor) -> float:
    """The card's peak for a product of these operands: bf16 tensor cores
    when every factor is bf16, f32 FFMA otherwise."""
    if all(t.dtype == torch.bfloat16 for t in operands):
        return BF16_FLOPS_PER_S
    return F32_FLOPS_PER_S


# host time a trace holds on each side of the traced calls: the profiler
# keeps only the device activities whose timestamps, once converted to
# the host's clock, fall inside its window, and a launch at either edge
# of a tight window can fall outside it (on an H100, one launch of 20,
# in three traces in a row)
TRACE_MARGIN_S = 0.05
# the host range that holds the traced calls in a trace, and the small
# launches that come before it in the same window
TRACED_RANGE = "chip_smoke.traced"
PRIMER_LAUNCHES = 20


def trace(fn, info: dict | None = None):
    """The device activities of ``fn()`` in a ``torch.profiler`` trace:
    (name, start us, end us) in start order.  ``info``, when given, gets
    the host ops' first start and last end (us) in the traced range and
    the primer's device records (``primer_seen`` of ``primer_launched``).

    The window is primed: ``PRIMER_LAUNCHES`` small launches and a
    synchronise come before ``fn``, and only the activities that start
    inside ``fn``'s host range are kept.  Once a process has spawned
    others, the profiler drops the device records of the first launches
    of a window, a run of them from its start, library kernels as well
    as the port's (up to 7 of 20 after the ``pipe`` path on an H100;
    ``scripts/trace_probe.py``); the primer takes that loss."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(TRACE_MARGIN_S)
        primer = torch.zeros(1, device="cuda")
        for _ in range(PRIMER_LAUNCHES - 1):
            primer.add_(1.0)
        torch.cuda.synchronize()
        with record_function(TRACED_RANGE):
            fn()
            torch.cuda.synchronize()
        time.sleep(TRACE_MARGIN_S)
    events = prof.events()
    span = next(e.time_range for e in events if e.name == TRACED_RANGE)
    device = [e for e in events if e.device_type == DeviceType.CUDA
              and e.name != TRACED_RANGE]   # not the range's device shadow
    acts = [(e.name, e.time_range.start, e.time_range.end)
            for e in device if e.time_range.start >= span.start]
    if info is not None:
        host = [e.time_range for e in events
                if e.device_type == DeviceType.CPU
                and e.time_range.start >= span.start]
        info.update(
            host_start=min((r.start for r in host), default=None),
            host_end=max((r.end for r in host), default=None),
            primer_seen=sum(e.time_range.start < span.start for e in device),
            primer_launched=PRIMER_LAUNCHES)
    return sorted(acts, key=lambda a: a[1])


# a trace that lacks launches the counters saw is taken again, this many
# times in all
TRACE_ATTEMPTS = 5


def trace_whole(what: str, fn, ran, info: dict | None = None
                ) -> tuple[list, int]:
    """``trace(fn)`` and the attempt it took, retaken while ``ran(acts)``
    (the port kernels the trace shows, by name) differs from the launches
    ``fn`` makes on the launch counters; ``info`` gets the whole trace's
    ``trace`` info."""
    seen = []
    for attempt in range(1, TRACE_ATTEMPTS + 1):
        before = launch_counts()
        got: dict = {}
        acts = trace(fn, got)
        launched = {k: v - before[k] for k, v in launch_counts().items()}
        if ran(acts) == launched:
            if info is not None:
                info.update(got)
            return acts, attempt
        # where the device activities lie against the host ops (us): the
        # device starts after the host issues and ends before it syncs
        host_start, host_end = got["host_start"], got["host_end"]
        seen.append({
            "device_activities": len(acts),
            "primer_seen": got["primer_seen"],
            "first_device_after_host_us": (
                None if not acts or host_start is None
                else acts[0][1] - host_start),
            "last_device_before_host_end_us": (
                None if not acts or host_end is None
                else host_end - max(a[2] for a in acts))})
    raise AssertionError(f"{what}: {TRACE_ATTEMPTS} traces show "
                         f"{ran(acts)} port launches, the counters "
                         f"{launched}; traces {seen}")


def kernel_of(activity_name: str) -> str | None:
    """The port kernel a traced device activity belongs to, if any."""
    for name, fns in TRACE_NAMES.items():
        if any(fn in activity_name for fn in fns):
            return name
    return None


# calls traced for a kernel's device time
TRACED_CALLS = 20


def traced_ran(acts) -> dict:
    """Launches of each port kernel in a trace."""
    names = [kernel_of(a[0]) for a in acts]
    return {name: names.count(name) for name in TRACE_NAMES}


def device_ms(name: str, fn, reps: int = TRACED_CALLS,
              info: dict | None = None) -> tuple[float, int]:
    """Mean duration of kernel ``name``'s launches in a trace of ``reps``
    calls of ``fn`` (device time alone, without the host's issue rate),
    and the traces it took."""
    acts, attempts = trace_whole(name, lambda: [fn() for _ in range(reps)],
                                 traced_ran, info)
    acts = [a for a in acts if kernel_of(a[0]) == name]
    if len(acts) != reps:
        raise AssertionError(f"{name}: {len(acts)} traced launches for "
                             f"{reps} calls")
    return sum(end - start for _, start, end in acts) / reps / 1e3, attempts


def check_kernel(name: str, case: str, kernel, plain, library, *,
                 dtype: torch.dtype, nbytes: float, flops: float,
                 flops_per_s: float, reps: int, plain_reps: int,
                 extra_ms: dict | None = None) -> dict:
    """Hold one kernel against its plain version; time all three, and the
    calls of ``extra_ms`` (row key -> call) with the kernel's traced
    ``device_ms`` when given."""
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{name} ({case}): {got.dtype} "
                             f"{tuple(got.shape)}, plain {want.dtype} "
                             f"{tuple(want.shape)}")
    tol = TOL[dtype]
    diff = (got.float() - want.float()).abs()
    excess = float((diff - (tol + tol * want.float().abs())).max())
    row = {
        "name": name, "case": case, "dtype": str(dtype).removeprefix("torch."),
        "shape": list(got.shape), "max_abs_err": float(diff.max()),
        "tol": tol, "ok": excess <= 0.0,
        "ms": cuda_ms(kernel, reps), "plain_ms": cuda_ms(plain, plain_reps),
        "library_ms": None if library is None else cuda_ms(library, reps),
    }
    if extra_ms is not None:
        for key, fn in extra_ms.items():
            row[key] = cuda_ms(fn, reps)
        row["device_ms"], row["traces"] = device_ms(name, kernel)
    row["bound_ms"], row["bound_by"] = bound(nbytes, flops, flops_per_s)
    row["bound_share"] = row["bound_ms"] / row["ms"]
    row["vs_library"] = (None if library is None
                         else row["ms"] / row["library_ms"])
    row["bytes"], row["flops"] = nbytes, flops
    emit("kernels", **row)
    if not row["ok"]:
        raise AssertionError(f"{name} ({case}, {row['dtype']}) disagrees "
                             f"with its plain version: {row}")
    return row


def straggler_masks(rng, n: int, s: int, count: int) -> list[np.ndarray]:
    masks = []
    for _ in range(count):
        done = np.ones(n, bool)
        done[rng.choice(n, size=s, replace=False)] = False
        masks.append(done)
    return masks


def launched_since(before: dict) -> dict:
    return {k: v - before[k] for k, v in launch_counts().items()}


def expect_counts(where: str, counts: dict, **want) -> None:
    if counts != want:
        raise AssertionError(f"{where}: launch counts {counts}, expected "
                             f"{want}")


# ---------------------------------------------------------------------------
# bcsr_matmul / cyclic_encode / decode_matmul checks at one phase's shapes
# ---------------------------------------------------------------------------


def bcsr_bytes(packed, workers, b: torch.Tensor, n_out_rows: int) -> float:
    """Bytes the product must move: the live workers' nonzero tiles, their
    slot indices and counts, the B rows those tiles select (per worker
    when B is per worker, else their union), C written once."""
    tiles = sum(packed.tile_counts[int(i)] for i in workers)
    esz = packed.a_data.element_size()
    idx = packed.a_idx.view(packed.n, packed.mb, -1).cpu().numpy()
    per_worker = b.ndim == 3
    kblocks = [set() for _ in workers] if per_worker else [set()]
    for j, i in enumerate(workers):
        seen = kblocks[j if per_worker else 0]
        for m, cnt in enumerate(packed.slot_counts[int(i)]):
            seen.update(idx[int(i), m, :cnt].tolist())
    k_dim, n_dim = b.shape[-2:]
    b_rows = sum(min(len(s) * packed.bk, k_dim) for s in kblocks)
    return (tiles * packed.bk * packed.bm * esz
            + tiles * 4 + len(workers) * packed.mb * 4
            + b_rows * n_dim * b.element_size()
            + n_out_rows * n_dim * 4)


def bcsr_flops(packed, workers, n_cols: int) -> float:
    tiles = sum(packed.tile_counts[int(i)] for i in workers)
    return 2.0 * tiles * packed.bk * packed.bm * n_cols


def check_bcsr_mv(plan, x, done, case, reps) -> dict:
    ex = plan.executor
    packed, dplan = ex.packed, ex.cache.plan(done)
    b = x.T.contiguous()
    rows = dplan.rows_dev
    live = ex.coded[dplan.rows_dev.long()]            # (k, t, c) dense shards
    dtype = packed.a_data.dtype
    return check_kernel(
        "bcsr_matmul", case,
        lambda: bcsr_matmul(packed.a_data, packed.a_idx, b, rows,
                            mb=packed.mb, counts=packed.counts),
        lambda: bcsr_matmul_plain(packed.a_data, packed.a_idx, b, rows,
                                  mb=packed.mb, counts=packed.counts),
        lambda: torch.matmul(live.transpose(1, 2), b.to(live.dtype)),
        dtype=dtype, nbytes=bcsr_bytes(packed, dplan.rows, b,
                                       ex.k * packed.c_pad),
        flops=bcsr_flops(packed, dplan.rows, b.shape[1]),
        flops_per_s=peak_rate(packed.a_data, b), reps=reps, plain_reps=3)


def check_bcsr_worker(plan, coded_b, worker, case, reps) -> dict:
    """One worker's product alone, the matmat's launch before products
    were grouped, kept for comparison with that launch.  The library
    call gets the dense shard widened to f32 outside the timing, as in
    check_bcsr_grouped."""
    ex = plan.executor
    packed = ex.packed
    a_data, a_idx = packed.worker_view(worker)
    counts = packed.counts[worker * packed.mb:(worker + 1) * packed.mb]
    b = coded_b[worker]
    shard = ex.coded[worker].T.to(b.dtype)
    return check_kernel(
        "bcsr_matmul", case,
        lambda: bcsr_matmul(a_data, a_idx, b, counts=counts),
        lambda: bcsr_matmul_plain(a_data, a_idx, b, counts=counts),
        lambda: torch.matmul(shard, b),
        dtype=a_data.dtype, nbytes=bcsr_bytes(packed, [worker], b,
                                              packed.c_pad),
        flops=bcsr_flops(packed, [worker], b.shape[1]),
        flops_per_s=peak_rate(a_data, b), reps=reps, plain_reps=3)


def check_bcsr_grouped(plan, coded_b, done, case, reps) -> dict:
    """The matmat's one launch over the k live workers, each with its own
    coded B shard; the yardstick is torch.bmm of the dense live shards.
    torch.bmm takes one dtype, so bf16 shards are widened to the f32 of
    the coded B outside the timing: the library computes the same
    function on the same values."""
    ex = plan.executor
    packed, dplan = ex.packed, ex.cache.plan(done)
    rows = dplan.rows_dev
    live_a = ex.coded[rows.long()].transpose(1, 2)        # (k, c, t)
    live_a = live_a.to(coded_b.dtype)
    live_b = coded_b[rows.long()]                         # (k, t, cb)
    return check_kernel(
        "bcsr_matmul", case,
        lambda: bcsr_matmul(packed.a_data, packed.a_idx, coded_b, rows,
                            mb=packed.mb, counts=packed.counts),
        lambda: bcsr_matmul_plain(packed.a_data, packed.a_idx, coded_b, rows,
                                  mb=packed.mb, counts=packed.counts),
        lambda: torch.bmm(live_a, live_b),
        dtype=packed.a_data.dtype,
        nbytes=bcsr_bytes(packed, dplan.rows, coded_b, ex.k * packed.c_pad),
        flops=bcsr_flops(packed, dplan.rows, coded_b.shape[2]),
        flops_per_s=peak_rate(packed.a_data, coded_b), reps=reps,
        plain_reps=2)


def check_encode(blocks, sup, coef, R, case, reps) -> dict:
    n, w = sup.shape
    k, t, c = blocks.shape
    Rd = torch.as_tensor(R, dtype=blocks.dtype, device=blocks.device)
    nbytes = (blocks.numel() * blocks.element_size() + n * t * c * 4
              + sup.numel() * 8)
    return check_kernel(
        "cyclic_encode", case,
        lambda: cyclic_encode(blocks, sup, coef),
        lambda: cyclic_encode_plain(blocks, sup, coef),
        lambda: torch.einsum("nk,ktc->ntc", Rd, blocks),
        dtype=blocks.dtype, nbytes=nbytes, flops=2.0 * n * w * t * c,
        flops_per_s=F32_FLOPS_PER_S, reps=reps, plain_reps=2)


def check_decode(hinv, y, mode: str, reps: int, case: str | None = None,
                 **kw) -> dict:
    """decode_matmul storing one caller's layout (mode), against its plain
    version.  Yardsticks: ``torch.matmul`` of the same operand alone
    (library_ms), and followed by the rearrangement that produced the
    layout before the decode stored it itself (library_rearranged_ms):
    mv and mm decoded Y's pad columns too; gather took the live rows,
    cast and copied them first."""
    k = hinv.shape[0]
    hl = hinv.to(y.dtype)
    if mode == "gather":
        rows, r = kw["rows"], kw["r"]
        live = y[rows.long()].reshape(k, -1)
        nread = live.numel()

        def rearranged():
            ysub = y[rows.long()].to(torch.float32)
            u = hinv @ ysub.reshape(k, -1).contiguous()
            u = torch.movedim(u.reshape((k,) + ysub.shape[1:]), 0, -2)
            return u.reshape(u.shape[:-2] + (-1,))[..., :r].to(y.dtype)
        library = (lambda: torch.matmul(hl, live))
    else:
        _, c_pad, inner = y.shape
        c, flat = kw["c"], y.view(k, -1)
        nread = k * c * inner
        if mode == "mv":
            def merge(u):
                u = u.view(k, c_pad, inner)[:, :c].permute(2, 0, 1)
                return u.reshape(inner, -1)[:, :kw["r"]]
        else:
            kb = kw["kb"]

            def merge(u):
                u = u.view(k, c_pad, inner)[:, :c]
                u = u.reshape(k // kb, kb, c, inner).permute(0, 2, 1, 3)
                return u.reshape(k // kb * c, kb * inner)[:kw["r"], :kw["w"]]

        def rearranged():
            return merge(torch.matmul(hl, flat))
        library = (lambda: torch.matmul(hl, flat))
    out = decode_matmul(hinv, y, mode, **kw)
    nbytes = (hinv.numel() * 4 + nread * y.element_size()
              + out.numel() * out.element_size()
              + (k * 4 if mode == "gather" else 0))
    # ms times the call the executor makes, a launch of the layout it
    # checked once; wrapper_ms the checked call
    layout = prepare_decode(hinv, y, mode, **kw)
    rows = kw.get("rows")

    def call():
        return launch_decode(layout, hinv, y, rows)
    return check_kernel(
        "decode_matmul", case or mode, call,
        lambda: decode_matmul_plain(hinv, y, mode, **kw),
        library, dtype=y.dtype, nbytes=nbytes, flops=2.0 * k * out.numel(),
        flops_per_s=F32_FLOPS_PER_S, reps=reps, plain_reps=reps,
        extra_ms={"library_rearranged_ms": rearranged,
                  "wrapper_ms": lambda: decode_matmul(hinv, y, mode, **kw)})


# ---------------------------------------------------------------------------
# End-to-end error of a decoded result
# ---------------------------------------------------------------------------


def decode_bound(dtype: torch.dtype, kappa: float, t: int) -> float:
    """The relative error a decode may show under one straggler pattern.

    The decode multiplies by the inverse of G[rows], so it amplifies the
    relative error its inputs carry by up to kappa = cond(G[rows]): the
    f32 rounding of t-term sums (2^-24 sqrt(t)) for f32 shards, the bf16
    storage of the shards (2^-9) for bf16 ones.  The stated bound
    (REL) holds where kappa is small; the reference's arithmetic (f32
    inverse, f32 products, bf16 shards) is the same, so an
    ill-conditioned pattern costs it the same.
    """
    eps = 2.0 ** -24 * t ** 0.5 if dtype == torch.float32 else 2.0 ** -9
    return max(REL[dtype], kappa * eps)


def mv_stored_decode(plan, rows: np.ndarray, x: torch.Tensor, r: int):
    """A^T x as the plan defines it, in f64: the stored shards of the
    live workers, times x, decoded by the f32 inverse the decode cache
    holds for this pattern (``decode_cache.py``'s arithmetic)."""
    ex = plan.executor
    g64 = ex.G.cpu().numpy().astype(np.float64)
    hinv = torch.from_numpy(np.linalg.inv(g64[rows]).astype(np.float32))
    live = torch.as_tensor(rows, device=x.device)
    y = torch.einsum("ntc,bt->nbc", ex.coded[live].double(), x.double())
    u = hinv.to(x.device, torch.float64) @ y.reshape(ex.k, -1)
    b = x.shape[0]
    return u.reshape(ex.k, b, -1).transpose(0, 1).reshape(b, -1)[:, :r]


def gathered_decode(plan, done, y: torch.Tensor, r: int) -> torch.Tensor:
    """executor.decode's function in f64: the live rows of the workers'
    results y (n, b, c) decoded by the exact inverse of G[rows]."""
    k = plan.k
    rows = np.flatnonzero(done)[:k]
    hinv = np.linalg.inv(plan.executor.G.cpu().double().numpy()[rows])
    live = y[torch.as_tensor(rows, device=y.device)].double()
    u = torch.from_numpy(hinv).to(y.device) @ live.reshape(k, -1)
    u = torch.movedim(u.reshape(live.shape), 0, -2)
    return u.reshape(u.shape[:-2] + (-1,))[..., :r]


def check_decoded(phase: str, dtype, plan, done, out, ref, t: int,
                  stored=None) -> dict:
    """Hold a decoded result against f64 truth (and, for bf16 shards,
    against the f64 decode of the stored shards)."""
    rows = np.flatnonzero(done)[: plan.k]
    kappa = float(np.linalg.cond(plan.G[rows]))
    limit = decode_bound(dtype, kappa, t)
    row = {"stragglers": np.flatnonzero(~done).tolist(), "kappa": kappa,
           "rel_err": rel_err(out, ref), "bound": limit}
    if stored is not None:
        row["rel_err_vs_stored"] = rel_err(out, stored(rows))
        row["bound_vs_stored"] = REL[dtype]
        if not row["rel_err_vs_stored"] <= REL[dtype]:
            raise AssertionError(f"{phase} {dtype}: {row}")
    if not row["rel_err"] <= limit:      # NaN fails too
        raise AssertionError(f"{phase} {dtype}: {row}")
    return row


# ---------------------------------------------------------------------------
# Phase 3: the coded LM head (matvec)
# ---------------------------------------------------------------------------


def phase_mv(seed: int, dev, gen, rng, t_dim: int = 3072,
             r_dim: int = 32064, batch: int = 8) -> tuple[dict, list]:
    n, s = 16, 2
    A = torch.randn((t_dim, r_dim), generator=gen, device=dev)
    x = torch.randn((batch, t_dim), generator=gen, device=dev)
    masks = [np.ones(n, bool)] + straggler_masks(rng, n, s, 3)
    result, calls = {}, 0

    reset_launch_counts()
    decodes = 0
    for dtype in (torch.float32, torch.bfloat16):
        a_in, x_in = A.to(dtype), x.to(dtype)
        before = launch_counts()
        t0 = time.perf_counter()
        plan = compile_plan(a_in, scheme="proposed", n=n, s=s,
                            backend="cuda", seed=seed)
        torch.cuda.synchronize()
        compile_s = time.perf_counter() - t0
        expect_counts("mv compile", launched_since(before), bcsr_matmul=0,
                      cyclic_encode=1, decode_matmul=0)
        ref = (x_in.double() @ a_in.double())            # (batch, r)
        checks = []
        for done in masks:
            before = launch_counts()
            out = plan.matvec(x_in, done)
            expect_counts("one matvec", launched_since(before),
                          bcsr_matmul=1, cyclic_encode=0, decode_matmul=1)
            calls += 1
            if out.shape != (batch, r_dim) or not torch.isfinite(out).all():
                raise AssertionError(f"mv {dtype}: bad output {out.shape}")
            # bf16 shards: also against the exact decode of what is stored
            stored = None if dtype == torch.float32 else (
                lambda rows: mv_stored_decode(plan, rows, x_in, r_dim))
            checks.append(check_decoded("mv", dtype, plan, done, out, ref,
                                        t_dim, stored))
        # decode-only: the n workers' results for the batch, (n, b, c), as
        # a caller hands them to executor.decode
        ex = plan.executor
        y_workers = torch.randn((n, batch, ex.c), generator=gen,
                                device=dev).to(dtype)
        before = launch_counts()
        out = ex.decode(y_workers, masks[1])
        expect_counts("one decode", launched_since(before), bcsr_matmul=0,
                      cyclic_encode=0, decode_matmul=1)
        decodes += 1
        if out.shape != (batch, r_dim) or out.dtype != dtype:
            raise AssertionError(f"decode {dtype}: {out.dtype} {out.shape}")
        decoded = check_decoded(
            "decode", dtype, plan, masks[1], out,
            gathered_decode(plan, masks[1], y_workers, r_dim), plan.k)
        reps = 20
        p50 = host_p50_ms(lambda: plan.matvec(x_in, masks[1]), reps)
        mask_dev = torch.as_tensor(masks[1], device=dev)
        p50_dev_mask = host_p50_ms(lambda: plan.matvec(x_in, mask_dev), reps)
        calls += 2 * reps
        cache = ex.cache
        key = str(dtype).removeprefix("torch.")
        result[key] = {"plan": plan, "x": x_in, "A": a_in,
                       "y_workers": y_workers, "p50": p50,
                       "done": masks[1]}
        emit("mv", dtype=key, shape=[t_dim, r_dim], batch=batch,
             scheme="proposed", n=n, s=s, k=plan.k,
             weight=plan.scheme.weight(), compile_s=compile_s,
             pack_s=ex.pack_seconds, slots=ex.packed.slots,
             coded_mb=ex.coded.numel() * ex.coded.element_size() / 2**20,
             packed_mb=(ex.packed.a_data.numel()
                        * ex.packed.a_data.element_size() / 2**20),
             patterns=checks, decode=decoded, matvec_p50_ms=p50,
             matvec_p50_ms_cuda_mask=p50_dev_mask,
             cuda_mask_note="a CUDA done mask is copied to the host per "
                            "call (one device-to-host sync)",
             cache_hits=cache.hits, cache_misses=cache.misses)
    counts = launch_counts()
    expect_counts("mv", counts, bcsr_matmul=calls, cyclic_encode=2,
                  decode_matmul=calls + decodes)
    emit("mv", launches=counts, matvec_calls=calls, decode_calls=decodes,
         compiles=2)
    return result, [counts]


def kernels_mv(mv: dict, reps: int) -> list[dict]:
    rows = []
    for data in mv.values():
        plan, x, A = data["plan"], data["x"], data["A"]
        ex = plan.executor
        done = np.ones(plan.n, bool)
        done[[3, 11]] = False
        rows.append(check_bcsr_mv(plan, x, done, "mv", reps))
        # the encode of compile_plan, on the view it reads
        R = mv_encoding_matrix(plan.scheme, plan.seed)
        sup, coef = support_tables(plan.scheme.supports, R)
        blocks = split_block_columns(A, plan.scheme.k_A)
        rows.append(check_encode(
            blocks, torch.as_tensor(sup, device=A.device),
            torch.as_tensor(coef, device=A.device), R, "mv", 3))
        # the decode of one matvec: Y is bcsr_matmul's output, (b, r) out
        dplan = ex.cache.plan(done)
        y = bcsr_matmul(ex.packed.a_data, ex.packed.a_idx, x.T.contiguous(),
                        dplan.rows_dev, mb=ex.packed.mb,
                        counts=ex.packed.counts)
        y = y.view(ex.k, ex.packed.c_pad, -1).to(A.dtype)
        rows.append(check_decode(dplan.hinv_dev, y, "mv", reps,
                                 c=ex.packed.c, r=ex.r))
        # the decode of executor.decode: live rows read in place
        rows.append(check_decode(dplan.hinv_dev, data["y_workers"], "gather",
                                 reps, rows=dplan.rows_dev, r=ex.r))
    return rows


# ---------------------------------------------------------------------------
# Phase 4: the paper's Fig. 4 system at device scale (matmat)
# ---------------------------------------------------------------------------


def block_sparse(gen, dev, t: int, r: int, zeros: float, tile: int = 32):
    keep = torch.rand((t // tile, r // tile), generator=gen, device=dev) >= zeros
    mask = keep.repeat_interleave(tile, 0).repeat_interleave(tile, 1)
    return torch.randn((t, r), generator=gen, device=dev) * mask


def phase_mm(seed: int, dev, gen, rng, t_dim: int = 8192,
             r_dim: int = 4096, w_dim: int = 4096) -> dict:
    n, ka, kb = 20, 4, 4
    A = block_sparse(gen, dev, t_dim, r_dim, 0.98)
    B = block_sparse(gen, dev, t_dim, w_dim, 0.98)
    ref = A.double().T @ B.double()
    masks = straggler_masks(rng, n, n - ka * kb, 2)

    reset_launch_counts()
    t0 = time.perf_counter()
    plan = compile_plan(A, scheme="proposed", n=n, k_A=ka, k_B=kb,
                        backend="cuda", seed=seed)
    torch.cuda.synchronize()
    compile_s = time.perf_counter() - t0
    expect_counts("mm compile", launch_counts(), bcsr_matmul=0,
                  cyclic_encode=1, decode_matmul=0)
    checks = []
    for done in masks:
        before = launch_counts()
        out = plan.matmat(B, done)
        expect_counts("one matmat", launched_since(before),
                      bcsr_matmul=1, cyclic_encode=1, decode_matmul=1)
        if out.shape != (r_dim, w_dim) or not torch.isfinite(out).all():
            raise AssertionError(f"mm: bad output {out.shape}")
        checks.append(check_decoded("mm", torch.float32, plan, done, out,
                                    ref, t_dim))
    reps = 5
    p50 = host_p50_ms(lambda: plan.matmat(B, masks[0]), reps)
    if plan.matmat(B, masks[0]).stride() != (w_dim, 1):
        raise AssertionError("mm: the result is not a contiguous (r, w)")
    calls = len(masks) + reps + 1
    counts = launch_counts()
    expect_counts("mm", counts, bcsr_matmul=calls,
                  cyclic_encode=1 + calls, decode_matmul=calls)
    ex = plan.executor
    coded_b = encode_blocks(split_block_columns(B, kb), plan._sup_b,
                            plan._coef_b, "cuda")
    emit("mm", shape_a=[t_dim, r_dim], shape_b=[t_dim, w_dim],
         tile_zeros=0.98, scheme="proposed", n=n, k_A=ka, k_B=kb,
         s=plan.s, omega=[plan.scheme.omega_A, plan.scheme.omega_B],
         compile_s=compile_s, pack_s=ex.pack_seconds, slots=ex.packed.slots,
         tile_counts=list(ex.packed.tile_counts),
         coded_a_mb=ex.coded.numel() * 4 / 2**20,
         coded_b_mb=coded_b.numel() * 4 / 2**20,
         patterns=checks, matmat_p50_ms=p50,
         cache_hits=ex.cache.hits, cache_misses=ex.cache.misses,
         launches=counts, matmat_calls=calls)
    return {"plan": plan, "B": B, "coded_b": coded_b, "done": masks[0],
            "counts": counts, "p50": p50}


def kernels_mm(mm: dict, reps: int) -> list[dict]:
    plan, B, coded_b = mm["plan"], mm["B"], mm["coded_b"]
    ex, sch = plan.executor, plan.scheme
    done = mm["done"]
    dplan = ex.cache.plan(done)
    worker = int(dplan.rows[0])
    y = bcsr_matmul(ex.packed.a_data, ex.packed.a_idx, coded_b,
                    dplan.rows_dev, mb=ex.packed.mb,
                    counts=ex.packed.counts).view(ex.k, ex.packed.c_pad, -1)
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        # bf16: the same operand's shards, stored as bf16 by a bf16 plan,
        # times the f32 coded B that plan's matmat passes
        shards = plan if dtype is torch.float32 else compile_plan(
            plan._A.to(dtype), scheme=sch, backend="cuda", seed=plan.seed)
        rows.append(check_bcsr_grouped(shards, coded_b, done, "mm", reps))
        rows.append(check_bcsr_worker(shards, coded_b, worker, "mm-worker",
                                      reps))
        del shards
        blocks = split_block_columns(B.to(dtype), sch.k_B)
        rows.append(check_encode(blocks, plan._sup_b, plan._coef_b,
                                 plan._rb, "mm", 3))
        rows.append(check_decode(dplan.hinv_dev, y.to(dtype), "mm", reps,
                                 c=ex.packed.c, r=plan.r, w=B.shape[1],
                                 kb=sch.k_B))
    return rows


# ---------------------------------------------------------------------------
# Phase 5: the device kernels of one call, from a profiler trace
# ---------------------------------------------------------------------------


def busy_us(acts) -> float:
    """Time covered by at least one device activity."""
    total, end = 0.0, float("-inf")
    for _, start, stop in acts:
        if stop > end:
            total += stop - max(start, end)
            end = stop
    return total


def census(label: str, fn, p50_ms: float, want: dict) -> dict:
    """Trace one call of ``fn``: every device activity in order, the
    device's busy time against the call's p50 wall time (host clock,
    untraced), and the port kernels it ran.  The decode must come last."""
    fn()
    torch.cuda.synchronize()
    info: dict = {}
    acts, attempts = trace_whole(label, fn, traced_ran, info)
    names = [kernel_of(a[0]) or a[0].removeprefix("void ").split("<")[0]
             for a in acts]
    busy = busy_us(acts) / 1e3
    row = {"call": label, "device_activities": names,
           "device_busy_ms": busy,
           "device_span_ms": (acts[-1][2] - acts[0][1]) / 1e3 if acts else 0,
           "p50_ms": p50_ms, "busy_share": busy / p50_ms,
           "idle_share": 1.0 - busy / p50_ms, "traces": attempts,
           "primer_seen": info["primer_seen"]}
    emit("census", **row)
    ran = {name: names.count(name) for name in want}
    if ran != want:
        raise AssertionError(f"{label}: traced kernels {ran}, expected {want}")
    if not names or names[-1] != "decode_matmul":
        raise AssertionError(f"{label}: device work after the decode: {names}")
    return row


# ---------------------------------------------------------------------------
# Phase 6: the serving path at full width (repro_torch.launch.serve)
# ---------------------------------------------------------------------------


class StepTimer:
    """CUDA events around each call of the engine's prefill and decode."""

    def __init__(self, engine):
        self.events = {"prefill": [], "decode": []}
        engine._prefill = self._wrap("prefill", engine._prefill)
        engine._decode = self._wrap("decode", engine._decode)

    def _wrap(self, kind: str, fn):
        def call(*args):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args)
            end.record()
            self.events[kind].append((start, end))
            return out
        return call

    def ms(self, kind: str) -> list[float]:
        torch.cuda.synchronize()
        return [s.elapsed_time(e) for s, e in self.events[kind]]


@contextlib.contextmanager
def timed_compiles(seconds: list):
    """Time each ``compile_plan`` the serve engine makes (the coded head's
    encode and pack, ending in a synchronise) into ``seconds``."""
    import repro_torch.serve.engine as engine_module

    real = engine_module.compile_plan

    def timed(*args, **kw):
        t0 = time.perf_counter()
        plan = real(*args, **kw)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        return plan

    engine_module.compile_plan = timed
    try:
        yield
    finally:
        engine_module.compile_plan = real


def launcher_call(fn, *args):
    """Run one of the launcher's steps -> (result, the lines it printed)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args)
    return out, buf.getvalue().splitlines()


def decode_step_bytes(model, batch: int, context: float) -> float:
    """Bytes one decode step must move: every weight once (of the
    embedding only the batch's rows), the K/V of ``context`` positions
    per layer, the logits written once."""
    cfg = model.cfg
    esz = model.embed.element_size()
    weights = sum(p.numel() * p.element_size() for p in model.parameters())
    if not cfg.tie_embeddings:
        weights += (batch - cfg.vocab) * cfg.d_model * esz
    kv = (2 * batch * context * cfg.attn.n_kv_heads * cfg.attn.head_dim
          * esz * cfg.n_layers)
    return weights + kv + batch * cfg.vocab * 4


def left_padded(prompts) -> np.ndarray:
    """A wave's tokens as the engine lays them out (left-padded with 0)."""
    plen = max(len(p) for p in prompts)
    toks = np.zeros((len(prompts), plen), np.int32)
    for j, p in enumerate(prompts):
        toks[j, plen - len(p):] = p
    return toks


def check_cache(model, toks: np.ndarray, max_len: int, limit: float
                ) -> dict:
    """Prefill then one decode step, against a fresh forward over the
    prompt plus that token: each set of logits within ``limit`` x
    max|logit| of the forward's at the same position."""
    with torch.inference_mode():
        last, cache = model.prefill(toks, max_len=max_len)
        nxt = last.argmax(dim=-1)
        step, _ = model.decode_step(cache, nxt[:, None])
        full, _ = model(torch.cat([torch.as_tensor(toks, device=nxt.device),
                                   nxt[:, None].int()], dim=1))
    row = {"dtype": str(model.dtype).removeprefix("torch."),
           "limit": limit}
    for key, got, want in (("prefill", last, full[:, -2]),
                           ("decode", step, full[:, -1])):
        row[f"{key}_rel_err"] = rel_err(got, want.double())
        if not row[f"{key}_rel_err"] <= limit:
            raise AssertionError(f"serve cache {key}: {row}")
    return row


def step_census(model, toks: np.ndarray, max_len: int, reps: int = 5
                ) -> dict:
    """One decode step of a prefilled wave under ``torch.profiler``: its
    device kernels, the device's busy share of the step's p50 wall time
    (host clock, untraced), and the kernels that take the most device
    time.  The step launches none of the port's kernels."""
    with torch.inference_mode():
        _, cache = model.prefill(toks, max_len=max_len)
        nxt = torch.ones((toks.shape[0], 1), dtype=torch.long,
                         device=model.device)

        def step():
            # the same slot is written each time: the cache stays valid
            return model.decode_step(cache, nxt)
        p50 = host_p50_ms(step, reps)
        acts, attempts = trace_whole("decode step", step, traced_ran)
    busy = busy_us(acts) / 1e3
    by_name: dict = {}
    for name, start, end in acts:
        key = name.removeprefix("void ").split("<")[0].split("(")[0][:60]
        by_name[key] = by_name.get(key, 0.0) + (end - start) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    row = {"call": "decode_step", "device_kernels": len(acts),
           "device_busy_ms": busy, "p50_ms": p50, "busy_share": busy / p50,
           "idle_share": 1.0 - busy / p50,
           "top_kernels_ms": [[k, v] for k, v in top], "traces": attempts}
    emit("census", **row)
    if any(traced_ran(acts).values()):
        raise AssertionError(f"decode step: port kernels {traced_ran(acts)}")
    return row


def phase_serve(seed: int, dev, gen, arch: str = "phi3-mini-3.8b",
                smoke: bool = False) -> dict:
    """The launcher's path (``build``, ``make_requests``, ``serve``,
    ``check_coded_head``) with its defaults, then the serve checks."""
    argv = ["--arch", arch, "--coded", "--seed", str(seed),
            "--device", str(dev)] + (["--smoke"] if smoke else [])
    args = launcher.parse_args(argv)
    torch.cuda.reset_peak_memory_stats()

    # the main path: build, serve, the launcher's coded-head check
    reset_launch_counts()
    t0 = time.perf_counter()
    compile_s = []
    with timed_compiles(compile_s):
        (cfg, model, params, engine), printed = launcher_call(
            launcher.build, args)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    expect_counts("serve build", launch_counts(), bcsr_matmul=0,
                  cyclic_encode=1, decode_matmul=0)
    plan = engine.coded
    timer = StepTimer(engine)
    rng = np.random.default_rng(args.seed)
    reqs = launcher.make_requests(args, cfg, rng)
    before = launch_counts()
    t0 = time.perf_counter()
    out, lines = launcher_call(launcher.serve, engine, reqs)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    printed += lines
    expect_counts("serving", launched_since(before), bcsr_matmul=0,
                  cyclic_encode=0, decode_matmul=0)
    before = launch_counts()
    worst, lines = launcher_call(launcher.check_coded_head, args, cfg,
                                 params, engine, rng)
    printed += lines
    expect_counts("launcher coded check", launched_since(before),
                  bcsr_matmul=5, cyclic_encode=0, decode_matmul=5)
    counts = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    tokens = sum(len(r.output) for r in out)
    if len(out) != args.requests or any(
            len(r.output) != args.max_new for r in out):
        raise AssertionError(f"serve: {[len(r.output) for r in out]} "
                             f"tokens for {args.requests} requests")
    if not all(0 <= t < cfg.vocab for r in out for t in r.output):
        raise AssertionError("serve: a token outside the vocabulary")
    prefill_ms = timer.ms("prefill")
    decode_ms = timer.ms("decode")
    contexts = [len(r.prompt) for r in reqs]
    context = float(np.mean(contexts)) + args.max_new / 2
    bound_ms = decode_step_bytes(model, args.batch, context) \
        / HBM_BYTES_PER_S * 1e3

    # the coded head against f64 truth under the engine's own masks
    head = params["embed"].T if cfg.tie_embeddings else params["head"]
    hidden = torch.randn((2, cfg.d_model), generator=gen, device=dev)
    ref = hidden.double() @ head.double()
    dtype = plan.executor.coded.dtype
    patterns, masks = [], []
    for _ in range(5):
        done = engine._straggler_mask()
        masks.append(done)
        before = launch_counts()
        got = engine.coded_logits(hidden, done)
        expect_counts("one coded_logits", launched_since(before),
                      bcsr_matmul=1, cyclic_encode=0, decode_matmul=1)
        if got.shape != (2, cfg.vocab) or got.dtype != hidden.dtype:
            raise AssertionError(f"coded_logits: {got.dtype} {got.shape}")
        patterns.append(check_decoded(
            "serve", dtype, plan, done, got, ref, cfg.d_model,
            lambda rows: mv_stored_decode(plan, rows, hidden, cfg.vocab)))
    coded_p50 = host_p50_ms(lambda: engine.coded_logits(hidden, masks[0]),
                            20)

    # cache consistency, bf16 and then f32 on the same weights
    waves = [r.prompt for r in reqs[: args.batch]]
    toks = left_padded(waves)
    before = launch_counts()
    cache_checks = [check_cache(model, toks, args.max_len, 2e-2)]
    step = step_census(model, toks, args.max_len)
    model32 = build_model(cfg, torch.float32, device=dev)
    model32.load_state_dict(params)
    cache_checks.append(check_cache(model32, toks, args.max_len, 2e-4))
    del model32
    expect_counts("prefill and decode", launched_since(before),
                  bcsr_matmul=0, cyclic_encode=0, decode_matmul=0)

    emit("serve", arch=cfg.name, dtype=str(model.dtype).removeprefix(
        "torch."), params_b=sum(p.numel() for p in model.parameters()) / 1e9,
         requests=args.requests, batch=args.batch, max_new=args.max_new,
         max_len=args.max_len, n=plan.n, s=plan.s, k=plan.k,
         scheme=plan.scheme.name, backend=plan.backend, served=len(out),
         tokens=tokens, serve_s=serve_s, tokens_per_s=tokens / serve_s,
         build_s=build_s, coded_compile_s=compile_s[0],
         prefill_ms=prefill_ms,
         decode_steps=len(decode_ms),
         decode_step_p50_ms=float(np.median(decode_ms)),
         decode_step_ms_min=min(decode_ms), decode_step_ms_max=max(decode_ms),
         bound_ms=bound_ms, bound_by="bytes",
         bound_note="weights + K/V at the mean context over 3.35 TB/s",
         peak_memory_gb=peak_gb, launcher_worst_rel_err=worst,
         coded_patterns=patterns, coded_logits_p50_ms=coded_p50,
         decode_step_busy_share=step["busy_share"],
         cache=cache_checks, launches=counts, printed=printed)
    return {"engine": engine, "hidden": hidden, "done": masks[0],
            "counts": counts, "p50": coded_p50}


def kernels_serve(serve: dict, reps: int) -> list[dict]:
    """The three kernels at the serve geometry: the head's encode at
    build, and one coded_logits call's product and decode."""
    engine, hidden, done = serve["engine"], serve["hidden"], serve["done"]
    plan = engine.coded
    ex = plan.executor
    dplan = ex.cache.plan(done)
    rows = [check_bcsr_mv(plan, hidden, done, "serve", reps)]
    head = engine.params["embed"].T if engine.cfg.tie_embeddings \
        else engine.params["head"]
    R = mv_encoding_matrix(plan.scheme, plan.seed)
    sup, coef = support_tables(plan.scheme.supports, R)
    blocks = split_block_columns(head, plan.scheme.k_A)
    if blocks.stride(-1) != 1:          # a tied head: encode_blocks' copy
        blocks = blocks.contiguous()
    rows.append(check_encode(
        blocks, torch.as_tensor(sup, device=head.device),
        torch.as_tensor(coef, device=head.device), R, "serve", 3))
    y = bcsr_matmul(ex.packed.a_data, ex.packed.a_idx, hidden.T.contiguous(),
                    dplan.rows_dev, mb=ex.packed.mb, counts=ex.packed.counts)
    rows.append(check_decode(dplan.hinv_dev,
                             y.view(ex.k, ex.packed.c_pad, -1), "mv", reps,
                             case="serve", c=ex.packed.c, r=ex.r))
    return rows


# ---------------------------------------------------------------------------
# Phase 7: the edge cluster on the card (repro_torch.cluster)
# ---------------------------------------------------------------------------


def compute_apps() -> list[list[str]]:
    """``nvidia-smi``'s compute apps: [pid, used memory] per process."""
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return [[f.strip() for f in line.split(",")]
            for line in out.splitlines() if line.strip()]


def clean(where: str, reports) -> None:
    """Every round of a clean run: no death, no requeue, no suspicion (a
    worker whose kernel fails dies, and the fleet would route around it)."""
    bad = [(r.round, r.deaths, r.requeues, r.suspected) for r in reports
           if r.deaths or r.requeues or r.suspected]
    if bad:
        raise AssertionError(f"{where}: (round, deaths, requeues, "
                             f"suspected) {bad}")


def card_workers(where: str, cl) -> None:
    if cl.fleet.backend != "cuda" or cl.fleet.device.type != "cuda":
        raise AssertionError(f"{where}: workers compute with "
                             f"{cl.fleet.backend} on {cl.fleet.device}")


def hold_parity(where: str, got, want, dtype, plan, done, ref, t, stored
                ) -> dict:
    """A cluster result against the in-process one (f32, 2e-5 of
    max|want|) and against f64 truth (``check_decoded``)."""
    row = check_decoded(where, dtype, plan, done, got, ref, t, stored)
    row["rel_err_vs_in_process"] = rel_err(got, want.double())
    row["bitwise_in_process"] = bool(torch.equal(got, want))
    if not row["rel_err_vs_in_process"] <= TOL[torch.float32]:
        raise AssertionError(f"{where}: {row}")
    return row


def phase_cluster(seed: int, dev, gen, rng, serve: dict, t_dim: int = 8192,
                  r_dim: int = 4096, w_dim: int = 4096,
                  kernel_reps: int = 50) -> tuple[dict, list]:
    """The serve engine's cluster mode on the serve phase's model, the
    Fig. 4 matmat over ``to_cluster``, and the head over the ``pipe``
    transport, all with card workers, each path's launches counted from
    0; between the first two, the kernel rows at the cluster's shapes and
    the ``census`` of one cluster round; last, a racing round and the
    decode row's trace taken again, which must be whole after the pipe
    children.  -> (the path's launch counts, summed; the kernel rows)."""
    engine0, hidden = serve["engine"], serve["hidden"]
    cfg, model, params = engine0.cfg, engine0.model, engine0.params
    head = params["embed"].T if cfg.tie_embeddings else params["head"]
    ref = hidden.double() @ head.double()
    d = cfg.d_model
    # the cluster engine's own masks (its fault model and seed), given
    # explicitly to both engines; the in-process results are taken first
    faults = StragglerFaults(rng=np.random.default_rng(0))
    masks = [faults.mask(6, 2) for _ in range(5)]
    wants = [engine0.coded_logits(hidden, m) for m in masks]
    A = block_sparse(gen, dev, t_dim, r_dim, 0.98)
    B = block_sparse(gen, dev, t_dim, w_dim, 0.98)
    ref_mm = A.double().T @ B.double()
    n, ka, kb = 20, 4, 4
    plan_mm = compile_plan(A, scheme="proposed", n=n, k_A=ka, k_B=kb,
                           backend="cuda", seed=seed)
    mm_masks = straggler_masks(rng, n, n - ka * kb, 2)
    mm_wants = [plan_mm.matmat(B, m) for m in mm_masks]
    torch.cuda.synchronize()

    # -- the engine in cluster mode: counts from 0 -------------------------
    reset_launch_counts()
    t0 = time.perf_counter()
    engine = ServeEngine(model, params, cfg, batch_size=engine0.batch_size,
                         max_len=engine0.max_len, coded=CodedConfig(
                             enabled=True, n_workers=6, stragglers=2,
                             scheme="proposed", cluster=True,
                             transport="memory"))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    expect_counts("cluster engine build", launch_counts(), bcsr_matmul=0,
                  cyclic_encode=1, decode_matmul=0)
    plan, cl = engine.coded, engine.coded_cluster
    card_workers("engine cluster", cl)
    dtype = plan.executor.coded.dtype
    k = plan.k

    def stored(rows):
        return mv_stored_decode(plan, rows, hidden, cfg.vocab)

    patterns = []
    for done, want in zip(masks, wants):
        before = launch_counts()
        got = engine.coded_logits(hidden, done)
        torch.cuda.synchronize()
        expect_counts("one cluster coded_logits", launched_since(before),
                      bcsr_matmul=k, cyclic_encode=0, decode_matmul=1)
        if got.shape != (2, cfg.vocab) or got.device.type != dev.type:
            raise AssertionError(f"cluster coded_logits: {got.device} "
                                 f"{tuple(got.shape)}")
        patterns.append(hold_parity("cluster", got, want, dtype, plan, done,
                                    ref, d, stored))
    reps = 20
    p50 = host_p50_ms(lambda: engine.coded_logits(hidden, masks[0]), reps)
    reports = list(cl.reports)
    clean("engine cluster", reports)
    last = reports[-reps:]
    emit("cluster", case="engine", arch=cfg.name, transport="memory",
         scheme=plan.scheme.name, n=plan.n, s=plan.s, k=k,
         head_dtype=str(dtype).removeprefix("torch."),
         workers=cl.n_workers, worker_backend=cl.fleet.backend,
         build_s=build_s, patterns=patterns, round_p50_ms=p50,
         rounds=reps, decode_s_p50=float(np.median(
             [r.decode_s for r in last])),
         wall_s_p50=float(np.median([r.wall_s for r in last])),
         bytes_tasks_per_round=last[-1].bytes_tasks,
         bytes_results_per_round=last[-1].bytes_results,
         bytes_shards=cl.bytes_shards)
    calls = len(masks) + reps
    engine_counts = launch_counts()
    expect_counts("cluster engine", engine_counts, bcsr_matmul=calls * k,
                  cyclic_encode=1, decode_matmul=calls)

    # -- the kernels at the cluster's shapes, one cluster round traced -----
    rows, decode_call = kernels_cluster(plan, hidden, masks[0],
                                        cl.handle.shard_blobs[0], kernel_reps)
    census("cluster coded_logits",
           lambda: engine.coded_logits(hidden, masks[0]), p50,
           {"bcsr_matmul": k, "cyclic_encode": 0, "decode_matmul": 1})
    engine.close()

    # -- Fig. 4 matmat over to_cluster: counts from 0 ----------------------
    reset_launch_counts()
    t0 = time.perf_counter()
    cl_mm = plan_mm.to_cluster(transport="memory")
    start_mm_s = time.perf_counter() - t0
    card_workers("mm cluster", cl_mm)
    mm_checks, mm_wall = [], []
    for done, want in zip(mm_masks, mm_wants):
        before = launch_counts()
        t0 = time.perf_counter()
        got = cl_mm.matmat(B, done)
        torch.cuda.synchronize()
        mm_wall.append((time.perf_counter() - t0) * 1e3)
        expect_counts("one cluster matmat", launched_since(before),
                      bcsr_matmul=ka * kb, cyclic_encode=1, decode_matmul=1)
        if got.shape != (r_dim, w_dim) or not torch.isfinite(got).all():
            raise AssertionError(f"cluster mm: bad output {got.shape}")
        mm_checks.append(hold_parity("cluster mm", got, want, torch.float32,
                                     plan_mm, done, ref_mm, t_dim, None))
    mm_reports = list(cl_mm.reports)
    clean("mm cluster", mm_reports)
    cl_mm.shutdown()
    emit("cluster", case="mm", transport="memory", n=n, k_A=ka, k_B=kb,
         s=plan_mm.s, shape_a=[t_dim, r_dim], shape_b=[t_dim, w_dim],
         tile_zeros=0.98, start_s=start_mm_s, patterns=mm_checks,
         matmat_wall_ms=mm_wall,
         decode_s=[r.decode_s for r in mm_reports],
         bytes_tasks_per_round=mm_reports[-1].bytes_tasks,
         bytes_tasks_dense_per_round=mm_reports[-1].bytes_tasks_dense)
    mm_counts = launch_counts()
    expect_counts("cluster mm", mm_counts, bcsr_matmul=len(mm_masks) * ka * kb,
                  cyclic_encode=len(mm_masks), decode_matmul=len(mm_masks))

    # -- the head over the pipe transport: counts from 0 -------------------
    # (card workers in children: their bcsr_matmul launches count there,
    # and each child reports its counts over the pipe's control channel)
    apps_before = compute_apps()
    reset_launch_counts()
    t0 = time.perf_counter()
    cl_pipe = plan.to_cluster(transport="pipe")
    try:
        start_pipe_s = time.perf_counter() - t0
        card_workers("pipe cluster", cl_pipe)
        transport = cl_pipe.transport
        pids = {w: p.pid for w, p in transport._procs.items()}
        prev = first = transport.reports()
        pipe_checks, child_launches = [], []
        for done, want in zip(masks, wants):
            before = launch_counts()
            got = cl_pipe.matvec(hidden, done)
            torch.cuda.synchronize()
            expect_counts("one pipe matvec (parent)", launched_since(before),
                          bcsr_matmul=0, cyclic_encode=0, decode_matmul=1)
            now = transport.reports()
            per_child = {w: {name: c - prev[w]["launches"][name]
                             for name, c in now[w]["launches"].items()}
                         for w in now}
            # one bcsr_matmul in each child that returned a task, k in all
            served = cl_pipe.last_report.completed_per_worker
            want_child = {w: {"bcsr_matmul": served.get(w, 0),
                              "cyclic_encode": 0, "decode_matmul": 0}
                          for w in now}
            if per_child != want_child or sum(
                    c["bcsr_matmul"] for c in per_child.values()) != k:
                raise AssertionError(f"one pipe matvec: children launched "
                                     f"{per_child}, expected {want_child}")
            child_launches.append(sum(c["bcsr_matmul"]
                                      for c in per_child.values()))
            prev = now
            pipe_checks.append(hold_parity("pipe cluster", got, want, dtype,
                                           plan, done, ref, d, stored))
        clean("pipe cluster", cl_pipe.reports)
        apps = compute_apps()
    finally:
        cl_pipe.shutdown()
    # each child, in its own words: its pid, the card, the shard tiles it
    # holds there and the launches it made from its start
    card = torch.cuda.get_device_name(0)
    children = {w: {"pid": r["pid"], "device": r["device"],
                    "device_name": r["device_name"],
                    "memory_allocated": r["memory_allocated"],
                    "launches": r["launches"]} for w, r in prev.items()}
    bad = [w for w, r in prev.items()
           if r["pid"] != pids[w] or r["backend"] != "cuda"
           or not r["device"].startswith("cuda") or r["device_name"] != card
           or r["memory_allocated"] <= 0
           or first[w]["launches"]["bcsr_matmul"] != 0]
    if sorted(prev) != sorted(pids) or bad:
        raise AssertionError(f"pipe children {sorted(pids)} (bad: {bad}) "
                             f"do not compute on the card: {children}")
    app_pids = [a[0] for a in apps]
    by_pid = all(str(p) in app_pids for p in pids.values())
    # a sandbox's pid namespace can hide the children's pids from
    # nvidia-smi (it then shows another pid); the children's own reports
    # above are the proof, the listing is shown beside them
    emit("cluster", case="pipe", transport="pipe", workers=len(pids),
         start_s=start_pipe_s, startup=transport.startup,
         child_pids=sorted(pids.values()), children=children,
         child_bcsr_per_matvec=child_launches,
         compute_apps_before=apps_before, compute_apps=apps,
         children_listed_by_pid=by_pid,
         compute_apps_added=len(apps) - len(apps_before),
         patterns=pipe_checks,
         round_wall_s=[r.wall_s for r in cl_pipe.reports])
    pipe_counts = launch_counts()
    expect_counts("cluster pipe (parent)", pipe_counts, bcsr_matmul=0,
                  cyclic_encode=0, decode_matmul=len(masks))
    # the children's launches, from their own counters (0 at their spawn,
    # after this window's reset)
    pipe_counts = {name: c + sum(r["launches"][name] for r in prev.values())
                   for name, c in pipe_counts.items()}
    expect_counts("cluster pipe", pipe_counts, bcsr_matmul=len(masks) * k,
                  cyclic_encode=0, decode_matmul=len(masks))
    counts = {name: engine_counts[name] + mm_counts[name] + pipe_counts[name]
              for name in engine_counts}
    emit("cluster", launches=counts, engine=engine_counts, mm=mm_counts,
         pipe=pipe_counts, engine_calls=calls, matmat_calls=len(mm_masks),
         pipe_calls=len(masks))

    # -- racing: decode from the fastest k under latency faults -------------
    before = launch_counts()
    with plan.to_cluster(transport="memory", faults=StragglerFaults(
            time_scale=0.05, seed=seed)) as race:
        got = race.matvec(hidden)
        torch.cuda.synchronize()
        rep = race.last_report
    raced = launched_since(before)
    if rep.n_done != k or raced["decode_matmul"] != 1 or not (
            k <= raced["bcsr_matmul"] <= plan.n):
        raise AssertionError(f"racing: {rep.as_dict()} launches {raced}")
    clean("racing", [rep])
    race_row = check_decoded("racing", dtype, plan, rep.pattern, got, ref, d,
                             stored)
    emit("cluster", case="racing", time_scale=0.05, n_done=rep.n_done,
         rows=rep.rows.tolist(), wall_s=rep.wall_s, decode_s=rep.decode_s,
         launches=raced, check=race_row)

    # -- the decode row's trace again, after the pipe children and the race:
    # one earlier run lost 5 of 20 launches from this trace in this state
    info: dict = {}
    retrace_ms, takes = device_ms("decode_matmul", decode_call, info=info)
    emit("cluster", case="retrace", kernel="decode_matmul",
         calls=TRACED_CALLS, device_ms=retrace_ms, traces=takes,
         device_ms_before=rows[-1]["device_ms"],
         primer_seen=info["primer_seen"],
         primer_launched=info["primer_launched"])
    return counts, rows


def kernels_cluster(plan, hidden, done, blob: bytes, reps: int
                    ) -> tuple[list[dict], object]:
    """bcsr_matmul on one card worker's task of the head (its re-tiled
    f32 form, from the shard frame ``blob``) and the fleet's decode of
    the head, each against its plain version.  -> (the rows, a call of
    that decode's launch, for a later trace)."""
    dev = hidden.device
    shard = PlanShard.decode(blob)
    task = CardTask(shard, shard.tasks[0], dev)
    packed = task.packed
    b = torch.zeros((shard.t_pad, hidden.shape[0]), device=dev)
    b[: shard.t] = hidden.T
    dense = unpack_coded_blocks(packed)[0].T.contiguous()     # (c, t)
    rows = [check_kernel(
        "bcsr_matmul", "cluster",
        lambda: bcsr_matmul(packed.a_data, packed.a_idx, b, mb=packed.mb,
                            counts=packed.counts),
        lambda: bcsr_matmul_plain(packed.a_data, packed.a_idx, b,
                                  mb=packed.mb, counts=packed.counts),
        lambda: torch.matmul(dense, b),
        dtype=torch.float32, nbytes=bcsr_bytes(packed, [0], b,
                                               packed.c_pad),
        flops=bcsr_flops(packed, [0], b.shape[1]),
        flops_per_s=F32_FLOPS_PER_S, reps=reps, plain_reps=3)]
    # the fleet's decode: the k live (c_pad, b) results of 8x8 shards
    ex = plan.executor
    dplan = ex.cache.plan(done)
    y = bcsr_matmul(ex.packed.a_data, ex.packed.a_idx, hidden.T.contiguous(),
                    dplan.rows_dev, mb=ex.packed.mb, counts=ex.packed.counts)
    y = y.view(ex.k, ex.packed.c_pad, -1)[:, : shard.c_pad].contiguous()
    kw = {"c": ex.packed.c, "r": ex.r}
    rows.append(check_decode(dplan.hinv_dev, y, "mv", reps, case="cluster",
                             **kw))
    layout = prepare_decode(dplan.hinv_dev, y, "mv", **kw)
    return rows, lambda: launch_decode(layout, dplan.hinv_dev, y, None)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--parent", type=Path,
                    help="also compare p50s with this checkout, in turns")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device; none found")
    dev = torch.device("cuda")
    # full f32 products everywhere, including the library yardsticks
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    emit("device", nvidia_smi=smi, name=torch.cuda.get_device_name(0),
         capability=list(torch.cuda.get_device_capability()),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, tf32="off (matmul and cudnn)")

    t0 = time.perf_counter()
    _build.library()
    emit("build", seconds=time.perf_counter() - t0,
         cached=_build.build_info["cached"], library=_build.build_info["path"])

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    rng = np.random.default_rng(args.seed)
    mv, (mv_counts,) = phase_mv(args.seed, dev, gen, rng)
    rows = kernels_mv(mv, reps=200)
    f32 = mv["float32"]
    census("matvec", lambda: f32["plan"].matvec(f32["x"], f32["done"]),
           f32["p50"], {"bcsr_matmul": 1, "cyclic_encode": 0,
                        "decode_matmul": 1})
    del mv, f32
    mm = phase_mm(args.seed, dev, gen, rng)
    rows += kernels_mm(mm, reps=10)
    census("matmat", lambda: mm["plan"].matmat(mm["B"], mm["done"]),
           mm["p50"], {"bcsr_matmul": 1, "cyclic_encode": 1,
                       "decode_matmul": 1})
    mm_counts = mm["counts"]
    del mm
    torch.cuda.synchronize()
    serve = phase_serve(args.seed, dev, gen)
    rows += kernels_serve(serve, reps=50)
    census("coded_logits",
           lambda: serve["engine"].coded_logits(serve["hidden"],
                                                serve["done"]),
           serve["p50"], {"bcsr_matmul": 1, "cyclic_encode": 0,
                          "decode_matmul": 1})
    serve_counts = serve["counts"]
    cluster_counts, cluster_rows = phase_cluster(args.seed, dev, gen, rng,
                                                 serve)
    rows += cluster_rows
    del serve
    torch.cuda.synchronize()

    if args.parent is not None:
        root = Path(__file__).resolve().parent
        ab = subprocess.run(
            [sys.executable, str(root / "scripts" / "ab_smoke.py"),
             str(args.parent), str(root)],
            capture_output=True, text=True, timeout=900)
        for line in ab.stdout.splitlines():
            emit("ab", **json.loads(line))
        if ab.returncode != 0:
            raise AssertionError(f"ab_smoke.py failed: {ab.stderr[-2000:]}")

    table = []
    for name, (source, replaces) in SOURCES.items():
        main_row = next(r for r in rows if r["name"] == name
                        and r["case"] == "mv" and r["dtype"] == "float32")
        table.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": (mv_counts[name] + mm_counts[name]
                         + serve_counts[name] + cluster_counts[name]),
            "max_abs_err": main_row["max_abs_err"], "ms": main_row["ms"],
            "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"],
            "bound_by": main_row["bound_by"],
            "library_ms": main_row["library_ms"],
            "shape": main_row["shape"],
        })
    print(json.dumps({"kernels": table}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
