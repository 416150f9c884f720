#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA Hopper card.

    python3 chip_smoke.py [--seed N]

Phases, one JSON line each:

  0. device -- the card's name and power limit (``nvidia-smi``) and its
     compute capability;
  1. build  -- the four CUDA kernels built from ``src/repro_torch/
     kernels/csrc`` (or loaded from ``build/repro_torch/``);
  1b. mla   -- ``mla_decode_attention`` (latent attention's absorbed
     decode) at the Kimi-K2 decode cell's shape, 1024 sessions of 64
     heads over 2,200 cached positions of a 3,072-position buffer, and
     at 133, 8 and 1 sessions: held, with its plain version, against
     attention in f64, where its largest error must be at most 1.1x the
     plain chain's; its time, the plain version's and the least time by
     bytes;
  1c. mla step -- the decode cell's model on its main path: kimi-k2-
     instruct at published widths cut to 5 layers and 8 held experts,
     bf16, 1024 sessions at position 2,199 of a 3,072-position latent
     cache (32 prefilled prompts, each cache repeated 32 times): three
     ``decode_step``s launch the latent kernel once a layer, the held
     experts' once an MoE layer, and nothing else, and the first step's
     logits are held against the same step through both plain chains by
     the cell's measure and limits; the step's time, the plain chains',
     and the most slots a held expert took in a step;
  1d. held  -- ``held_expert_ffn`` (the held experts' decode FFN) at the
     decode cell's shape, 1024 tokens routed by a seeded router over 384
     experts, 8 held, published widths: held, with its plain version,
     against the f64 product, where its largest error must be at most
     1.1x the plain version's, and bitwise equal over two calls; its
     time, the plain version's, the dense chain's it replaced, and the
     least time by bytes;
  1e. sparse step -- the DeepSeek-V3.2 cell's model on its main path:
     deepseek-v3.2 at published widths cut to 5 layers and 8 held
     experts, bf16, 128 sessions at position 33,279 of a 33,792-position
     cache drawn at random: one ``decode_step`` selects 2,048 rows a
     session, launches the latent kernel twice a layer (128 heads, 64 a
     launch) and the held experts' once an MoE layer at 128 tokens, and
     nothing else; held against the same step through both plain chains:
     their selections the same in layer 0 (the share alike after it
     reported), the logits on the kernel chain's selections within 1c's
     limits; the step's time and the plain chains'; then the step as the
     cell runs it, replayed as one CUDA graph (``DecodeGraph``): its
     layer 0 selection the eager step's, its logits within 1c's limits
     of them (whether bitwise equal is reported), and its time;
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
     clean round has no death, requeue or suspicion;
  8. edge -- the cluster across processes and hosts, and under chaos, on
     the same head with card workers, one line per sub-phase with its
     wall time: the plan spans of one ``compile_plan`` and one
     ``retune`` under ``REPRO_TRACE`` (2 ``cyclic_encode``); the head
     over ``to_cluster(transport="tcp")`` (six spawned card children,
     worker 4 slowed 40x, their start-up and the 600 MB shard attach,
     six sha256 acks, the 5 masks and the all-alive one bitwise the
     in-process engine and within max(REL, kappa eps) of f64, 1
     ``decode_matmul`` per round in the parent and one ``bcsr_matmul``
     per returned task in each child by its own report); 8 traced
     racing rounds whose attribution names worker 4 first and lowest
     in ``observed_rates()``; worker 2 removed and replaced by a remote
     ``python -m repro_torch.cluster.worker --connect`` card process,
     caught up (re-encode to five hosts and back, its digest acked),
     two rounds bitwise, its own stdout report; the head over
     ``to_cluster(transport="shm")`` (header-only task bytes, no
     ``/dev/shm`` entry left after shutdown); ``run_chaos`` with card
     workers on ``memory`` at head width under the JAX package's storm
     and on ``tcp`` at the JAX package's geometry (seed 3), every
     resolved value bitwise its replay;
  9. front -- the serve front door and autoscaling on the same head, one
     line per sub-phase with its wall time, every fleet of card workers
     (``memory`` unless said): the engine's router mode
     (``CodedConfig(router=Router(), ...)``: the 5 masks and the
     all-alive one bitwise the in-process engine, k ``bcsr_matmul`` + 1
     ``decode_matmul`` a call; a second engine shares the endpoint, only
     the owner's close unregisters it); two tenants' paused burst (weights
     1:3) over two replicas, whose dispatch log must follow the stride;
     an ``Autoscaler`` adding two replicas (no encode), draining back to
     one and refused the last; one tenant's adaptive burst, whose width
     must reach batches of 64 columns (``bcsr_matmul``'s wide layout),
     then idle calls back to width 1, and static widths of 1 to 64 calls
     in closed loops (calls/s, each call's submit-to-result latency, and
     the worker task's ``bcsr_matmul`` at each N);
     ``CodedFleet(grow_encodings=True)`` scaled from 6 to 8 (a larger
     code, two ``cyclic_encode``, one per join, three masks bitwise the
     chosen plan) and back (the first compile, bitwise); a
     ``RemotePool`` whose ``--connect`` card processes dial a tcp
     coordinator, a seventh provisioned and decommissioned, each report
     naming the card; ``run_chaos`` with the autoscaler on.  The three
     kernels are held against their plain versions at every plan the
     grow and the chaos run re-encoded to.  Race-mode
     rounds launch k to n ``bcsr_matmul`` (a cancel may land after a
     worker started) and one ``decode_matmul`` per call; every routed
     result is bitwise the in-process plan under its round's pattern;
 10. models -- the coded consumers and the other model families, one
     line per sub-phase with its wall time: ``moe-serve``,
     granite-moe-1b-a400m at full depth and width in bf16 through the
     launcher's steps and defaults (coded head n=6, s=2, 1024 x 49155,
     8 requests, 16 new tokens), checked as the serve phase checks phi3
     (the cache at a capacity where no slot drops, with the share of
     routing choices equal to a fresh forward's, and the dropped-slot
     share at the published capacity 1.25 while serving); ``coded-moe``,
     ``CodedMoE`` on its first layer in f32 (32 experts, d 1024, h 512,
     top-8) on that layer's input at a decode step of 8 and a prefill of
     8 x 9 tokens, against ``moe_block`` under the all-alive and 3 random
     masks (max(REL, kappa eps) with kappa the worst of the layer's 96
     plans, and whether the reference test's 1e-4 held; aux 1e-6), 96
     ``cyclic_encode`` at build and 96 ``bcsr_matmul`` + 96
     ``decode_matmul`` a call, then through a
     ``CodedFleet`` of 6 ``memory`` card workers holding the engine's
     head too, bitwise the in-process calls; ``coded-grads``,
     ``CodedAggregator.build(6, 2)`` over payloads of one layer's size,
     all C(6,2) patterns against the f64 sum (one solve each, then
     hits), on ``to_cluster()`` card workers and on that fleet (2e-5);
     one line each for mamba2-1.3b, zamba2-2.7b and phi-3-vision-4.2b
     through the launcher (full depth, bf16, the coded head under 5
     masks, 16 decode steps against a fresh forward; the vision model
     also with 256 image embeddings through ``prefill``), and
     whisper-tiny with 1500 frames through ``prefill`` and 16 decode
     steps (the launcher refuses audio).  Kernel rows at granite's, the
     families' and the expert plans' shapes;
 11. train -- training on the card, after what the earlier phases hold
     is freed (the free memory printed), one line per sub-phase with its
     wall time: ``train-full``, phi3-mini-3.8b at full depth and width
     in bf16 through ``repro_torch.launch.train``'s ``build`` and
     ``train`` steps and defaults (AdamW with f32 moments, batch 8, seq
     128, lr 3e-4), 12 steps without a checkpoint, with the
     engine-shaped coded head (n=6, s=2 over the (3072, 32064) head)
     registered as the trainer's coded plan, served by a ``memory``
     cluster of card workers and retuned every 4 steps: each retune 1
     ``cyclic_encode`` of a snapshot of the live head and a re-ship,
     then 3 engine masks, each 1 ``bcsr_matmul`` + 1 ``decode_matmul``
     within max(REL, kappa eps) of hidden @ the live head in f64 and the
     cluster round bitwise; the loss must fall (the mean of the last 4
     below the first 4); the step p50, tokens/s, peak memory, the bound
     (``cell_flops`` over 989 TFLOP/s + AdamW's bytes over 3.35 TB/s)
     and a ``census`` of one step; ``train-f32``, the model cut to 2
     layers, one bf16 and one f32 step on the same weights (loss within
     2e-2, grad norm within 2^-9); ``train-resume``, the smoke config in
     f32: 6 steps against 3 + a checkpoint + a fresh trainer resumed to
     6 (rtol 1e-5, atol 1e-6), int8 compression, 2 microbatches.  Kernel
     rows at the retuned plan's shapes;
 12. mesh -- the mesh (``repro_torch.parallel``), after what phase 11
     holds is freed (the free memory printed), one line per sub-phase:
     ``mesh-kimi``, kimi-k2-1t-a32b at full width (d_model 7168, 64
     heads with 8 KV heads, 384 experts top-8 with d_expert 2048, vocab
     163840) cut to 1 layer, bf16, drawn from ``--seed`` on the card
     through the launcher's ``build`` (the launcher reads the cut
     config), its parameters placed by ``param_shardings`` on a one-rank
     NCCL (1, 1) ('data', 'model') mesh (zero-copy), served through the
     launcher's ``serve`` and ``check_coded_head`` with its defaults (8
     requests, batch 4, 16 new tokens, coded head n=6, s=2 over the
     (7168, 163840) head) inside ``expert_parallel``, every MoE call
     through ``moe_block_ep`` (none around it); then ``moe_block_ep``
     against ``moe_block`` on the served layer's input at a capacity
     where no slot drops (bf16 on the whole layer within the bf16 limit,
     f32 on its first 48 experts within 1e-4), the prefill and 16 decode
     steps under EP against a fresh forward without it, a traced decode
     step, the coded head under 5 engine masks within max(REL, kappa
     eps), and the three kernels at kimi's head; ``mesh-restore``, a
     smoke checkpoint written by the port's trainer on the card restored
     by ``restore_resharded`` onto the card mesh, bitwise;
     ``mesh-dryrun``, ``python -m repro_torch.launch.dryrun`` on
     256-rank fake process groups at full width, one process per cell,
     all at once: kimi's ``train_4k`` through ``moe_ep`` (one
     microbatch), whisper-tiny's ``decode_32k``, and one cell per fault
     the dry run's repair fixed (``DRYRUN_CELLS``), each ``ok``; the
     roofline over them (host only, started with phase 11);
 13. examples -- the ten port examples (``examples/torch/``) on the card
     with their defaults, each a subprocess with a temporary working
     directory and its own time limit, four at a time: its exit code,
     wall time and last line (``train_lm`` with its checkpoints in that
     directory).  ``quickstart``, ``edge_offload`` and ``serve_coded``
     also run in this process (``runpy``), with the launches they must
     make: quickstart 1 ``cyclic_encode`` of A at compile and, per
     matmat, 1 of B + 1 ``bcsr_matmul`` + 1 ``decode_matmul``;
     edge_offload 1 encode and 1 + 1 per matvec; serve_coded 1 encode at
     the engine's build, none while serving, 1 + 1 per coded call.

Launch counters are set to 0 just before each main path (mv, mm,
serve, cluster, each edge, front and models sub-phase, train-full,
mesh-kimi and each in-process example)
and read
just after; a child
process's launches come from its own report: every encode must have gone through
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
import concurrent.futures
import contextlib
import dataclasses
import gc
import hashlib
import io
import itertools
import json
import os
import socket
import subprocess
import sys
import tempfile
import threading
import time
import warnings
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import repro_torch.obs.trace as trace_mod  # noqa: E402
from repro_torch.api import CodedFleet, compile_plan  # noqa: E402
from repro_torch.cluster import (  # noqa: E402
    ChaosEvent,
    StragglerFaults,
    adversarial_faults,
    run_chaos,
    scripted_schedule,
)
from repro_torch.cluster.fleet import wait_settled  # noqa: E402
from repro_torch.cluster.wire import (  # noqa: E402
    PlanShard,
    plan_packed,
    shard_plan,
)
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
    held_expert_ffn,
    held_expert_ffn_plain,
    held_slots,
    launch_counts,
    mla_decode_attention,
    mla_decode_attention_plain,
    reset_launch_counts,
)
from repro_torch.kernels.decode_matmul import (  # noqa: E402
    launch_decode,
    prepare_decode,
)
from repro_torch.launch import serve as launcher  # noqa: E402
from repro_torch.launch import train as train_launcher  # noqa: E402
from repro_torch.analysis.flops import cell_flops  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.data import DataConfig, SyntheticTokens, make_pipeline  # noqa: E402,E501
from repro_torch.optim import (  # noqa: E402
    AdamWConfig,
    CompressionConfig,
    apply_updates,
)
from repro_torch.train import TrainConfig, Trainer  # noqa: E402
import repro_torch.models.dsa as dsa_module  # noqa: E402
from repro_torch.models.decode_graph import DecodeGraph  # noqa: E402
import repro_torch.models.mla as mla_module  # noqa: E402
import repro_torch.models.moe as moe_module  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.models import build_model, join_caches  # noqa: E402
from repro_torch.models.moe import CodedMoE, moe_block  # noqa: E402
from repro_torch.obs import attribute  # noqa: E402
from repro_torch.parallel import CodedAggregator, expert_parallel  # noqa: E402
from repro_torch.parallel.sharding import reference_key  # noqa: E402
from repro_torch.runtime import encode_blocks, support_tables  # noqa: E402
from repro_torch.runtime.pack import unpack_coded_blocks  # noqa: E402
from repro_torch.scale import (  # noqa: E402
    Autoscaler,
    ProvisionError,
    QueueDepthPolicy,
    RemotePool,
    SchedulePolicy,
)
from repro_torch.serve import Router, ServeEngine  # noqa: E402

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
    "mla_decode_attention": ("mla_decode_kernel",),
    # the last of its five launches a call
    "held_expert_ffn": ("held_combine_kernel",),
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


def expect_between(where: str, counts: dict, **bounds) -> None:
    """Each named count within its (low, high) bounds; None: unbounded."""
    bad = {name: counts[name] for name, (lo, hi) in bounds.items()
           if counts[name] < lo or (hi is not None and counts[name] > hi)}
    if bad:
        raise AssertionError(f"{where}: launch counts {counts}, expected "
                             f"within {bounds}")


def expect_counts(where: str, counts: dict, **want) -> None:
    """Every count as named; a kernel left unnamed must not have run."""
    want = {**dict.fromkeys(counts, 0), **want}
    if counts != want:
        raise AssertionError(f"{where}: launch counts {counts}, expected "
                             f"{want}")


# ---------------------------------------------------------------------------
# Phase 1b: latent attention's absorbed decode
# ---------------------------------------------------------------------------

# the decode cell's sessions, and fewer; its positions mid-window, in its
# buffer; Kimi-K2's heads, latent and rotated widths, and softmax scale
MLA_SESSIONS = (1024, 133, 8, 1)
MLA_LENGTH, MLA_BUFFER = 2200, 3072
MLA_HEADS, MLA_LATENT, MLA_ROPE = 64, 512, 64
MLA_SCALE = 0.13086


def mla_expanded(q_hat, q_pe, c, kr, length, scale, chunk=64):
    """Attention over keys [c | kr] and values c in f64, by sessions."""
    out = []
    for at in range(0, q_hat.shape[0], chunk):
        q = torch.cat([q_hat[at:at + chunk], q_pe[at:at + chunk]], -1)
        k = torch.cat([c[at:at + chunk, :length], kr[at:at + chunk, :length]],
                      -1)
        w = torch.softmax(scale * q.double() @ k.double().transpose(1, 2), -1)
        out.append(w @ c[at:at + chunk, :length].double())
    return torch.cat(out)


def phase_mla(seed: int, dev, reps: int = 20) -> list[dict]:
    """Phase 1b -> one kernel row per session count.  The
    plain chain rounds its scores to bf16 and the kernel keeps them in
    f32, so the two differ by the plain chain's own error: each is held
    against attention in f64 instead, the kernel to 1.1x the plain
    chain's largest error, as ``tests/test_torch_cuda.py`` holds it."""
    rows = []
    for b in MLA_SESSIONS:
        gen = torch.Generator(device=dev).manual_seed(seed + b)
        args = tuple(
            torch.randn(shape, generator=gen, device=dev).bfloat16()
            for shape in ((b, MLA_HEADS, MLA_LATENT), (b, MLA_HEADS, MLA_ROPE),
                          (b, MLA_BUFFER, MLA_LATENT),
                          (b, MLA_BUFFER, MLA_ROPE))) + (MLA_LENGTH, MLA_SCALE)
        ref = mla_expanded(*args)
        got = mla_decode_attention(*args)
        plain = mla_decode_attention_plain(*args)
        # each session's cache read once, its query read and its output
        # written once
        nbytes = 2 * b * (MLA_LENGTH * (MLA_LATENT + MLA_ROPE)
                          + MLA_HEADS * (2 * MLA_LATENT + MLA_ROPE))
        flops = 2 * b * MLA_HEADS * MLA_LENGTH * (2 * MLA_LATENT + MLA_ROPE)
        row = {
            "name": "mla_decode_attention", "case": f"B={b} L={MLA_LENGTH}",
            "dtype": "bfloat16", "shape": list(got.shape),
            "max_abs_err": float((got.double() - ref).abs().max()),
            "plain_max_abs_err": float((plain.double() - ref).abs().max()),
            "ms": cuda_ms(lambda: mla_decode_attention(*args), reps),
            "plain_ms": cuda_ms(lambda: mla_decode_attention_plain(*args), 5),
            "library_ms": None,
        }
        row["ok"] = row["max_abs_err"] <= 1.1 * row["plain_max_abs_err"]
        row["bound_ms"], row["bound_by"] = bound(nbytes, flops,
                                                 BF16_FLOPS_PER_S)
        row["bound_share"] = row["bound_ms"] / row["ms"]
        row["bytes"], row["flops"] = nbytes, flops
        emit("kernels", **row)
        if not row["ok"]:
            raise AssertionError(f"mla_decode_attention ({row['case']}): "
                                 f"error {row['max_abs_err']} against f64, "
                                 f"the plain chain's "
                                 f"{row['plain_max_abs_err']}")
        rows.append(row)
        del args, ref, got, plain
    return rows


# ---------------------------------------------------------------------------
# Phase 1c: the kernel on the decode cell's main path
# ---------------------------------------------------------------------------

# the decode cell's model: published widths, its layers and held experts
MLA_ARCH, MLA_LAYERS, MLA_HELD = "kimi-k2-instruct", 5, 8
# sessions prefilled a call, as the cell prefills them
MLA_GROUP = 32
# a row's largest logit difference from the plain chain's step, as a share
# of its largest logit: the median and 90th percentile over rows, held to
# the cell's limits on its rows' error against its reference
MLA_STEP_LIMITS = {"median": 4e-2, "p90": 5e-2}


def phase_mla_step(seed: int, dev, steps: int = 3, reps: int = 5
                   ) -> tuple[dict, dict]:
    """Phase 1c -> (the launches of ``steps`` decode steps, the step's
    row).  Both chains read the same prefilled cache."""
    cfg = get_config(MLA_ARCH).with_(n_layers=MLA_LAYERS)
    cfg = cfg.with_(moe=dataclasses.replace(cfg.moe, n_held=MLA_HELD,
                                            held_from=0))
    model = build_model(cfg, torch.bfloat16, device=dev)
    model.init(torch.Generator(device=dev).manual_seed(seed))
    b, pos = MLA_SESSIONS[0], MLA_LENGTH - 1
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    prompts = torch.randint(0, cfg.vocab, (MLA_GROUP, pos), device=dev,
                            generator=gen)
    toks = torch.randint(0, cfg.vocab, (b, steps), device=dev, generator=gen)
    with torch.inference_mode():
        part = model.prefill(prompts, pos)[1]
        cache = join_caches([part] * (b // MLA_GROUP), MLA_BUFFER)
    del part

    def step_at(i: int) -> torch.Tensor:
        cache["step"] = pos + i
        return model.decode_step(cache, toks[:, i:i + 1])[0]

    held = [blk.held_tokens for blk in model.layers
            if hasattr(blk, "held_tokens")]
    with torch.inference_mode():
        real = mla_module.takes, moe_module.takes
        mla_module.takes = moe_module.takes = lambda *route: False
        try:
            reset_launch_counts()
            want = step_at(0)
            plain_ms = cuda_ms(lambda: step_at(0), reps)
            expect_counts("mla step (plain chain)", launch_counts())
        finally:
            mla_module.takes, moe_module.takes = real
        reset_launch_counts()
        most = 0             # the most slots a held expert took in a step

        def counted_step(i: int) -> torch.Tensor:
            nonlocal most
            before = torch.stack(held)
            out = step_at(i)
            most = max(most, int((torch.stack(held) - before).max()))
            return out

        got = counted_step(0)
        for i in range(1, steps):
            counted_step(i)
        torch.cuda.synchronize()
        counts = launch_counts()
        expect_counts("mla step", counts,
                      mla_decode_attention=steps * cfg.n_layers,
                      held_expert_ffn=steps * len(held))
        ms = cuda_ms(lambda: step_at(0), reps)
    errs = ((got.float() - want.float()).abs().amax(1)
            / want.float().abs().amax(1))
    err = {"median": float(errs.median()),
           "p90": float(errs.quantile(0.9)), "max": float(errs.max())}
    row = {"case": f"{MLA_ARCH} decode_step B={b} L={pos + 1} "
                   f"({cfg.n_layers} layers)",
           "steps": steps, "logits_rel_err": err, "step_ms": ms,
           "plain_step_ms": plain_ms, "held_slots_most": most,
           "finite": bool(torch.isfinite(got).all())}
    emit("mla_step", launches=counts, **row)
    if not row["finite"] or any(err[k] > limit
                                for k, limit in MLA_STEP_LIMITS.items()):
        raise AssertionError(f"mla step: logits {err} from the plain "
                             f"chain's (limits {MLA_STEP_LIMITS}), finite "
                             f"{row['finite']}")
    del model, cache, want, got
    return counts, row


# ---------------------------------------------------------------------------
# Phase 1e: the sparse decode step at the DeepSeek-V3.2 cell's shapes
# ---------------------------------------------------------------------------

# the sparse cell's model and sessions; a position mid-stretch of its
# cache, so that every session selects index_topk of them
SPARSE_ARCH, SPARSE_SESSIONS = "deepseek-v3.2", 128
SPARSE_LENGTH, SPARSE_BUFFER = 33280, 33792


def phase_sparse_step(seed: int, dev, reps: int = 5) -> dict:
    """Phase 1e -> the step's row.  The cache is drawn N(0, 1), not
    prefilled: 4.3M prompt tokens would take minutes, and both chains
    read the same one.  Past layer 0 the two chains' inputs differ by
    their rounding, and a position whose index ties the 2048th within it
    may change sides, which moves a row's output as much as any other
    position (over this random cache up to 15% of a row's positions do,
    on the card): so the plain chain's logits are taken on the kernel
    chain's selections (``dsa.index_topk`` replayed).  Its own
    selections are the kernel chain's in layer 0, whose input is the
    same; the least share of a row's positions the two chains chose
    alike is reported for every layer."""
    cfg = get_config(SPARSE_ARCH).with_(n_layers=MLA_LAYERS, first_dense=1)
    cfg = cfg.with_(moe=dataclasses.replace(cfg.moe, n_held=MLA_HELD,
                                            held_from=0))
    model = build_model(cfg, torch.bfloat16, device=dev)
    model.init(torch.Generator(device=dev).manual_seed(seed))
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    b, k = SPARSE_SESSIONS, cfg.indexer.topk
    toks = torch.randint(0, cfg.vocab, (b, 1), device=dev, generator=gen)
    n_moe = sum(hasattr(blk, "held_tokens") for blk in model.layers)
    with torch.inference_mode():
        cache = model.init_cache(b, SPARSE_BUFFER)
        for layer in cache["layers"]:
            for t in layer.values():
                t.normal_(generator=gen)
    chosen, replay = [], []
    index_topk = dsa_module.index_topk

    def recorded(*args):
        out = replay.pop(0) if replay else index_topk(*args)
        chosen.append(out)
        return out

    def step() -> torch.Tensor:
        cache["step"] = SPARSE_LENGTH - 1
        return model.decode_step(cache, toks)[0]

    def taken() -> list:
        out = [c.sort(-1).values for c in chosen[:cfg.n_layers]]
        chosen.clear()
        return out

    dsa_module.index_topk = recorded
    real = mla_module.takes, moe_module.takes
    try:
        with torch.inference_mode():
            reset_launch_counts()
            got = step()
            torch.cuda.synchronize()
            counts = launch_counts()
            expect_counts("sparse step", counts,
                          mla_decode_attention=2 * cfg.n_layers,
                          held_expert_ffn=n_moe)
            got_chose = taken()
            ms = cuda_ms(step, reps)
            graph = DecodeGraph(model, cache)

            def graph_step() -> torch.Tensor:
                cache["step"] = SPARSE_LENGTH - 1
                return graph(cache, toks)[0]
            replayed = graph_step()
            chosen.clear()
            graph_chose = model.layers[0].selected.sort(-1).values
            graph_ms = cuda_ms(graph_step, reps)
            del graph
            chosen.clear()
            mla_module.takes = moe_module.takes = lambda *route: False
            reset_launch_counts()
            step()
            own_chose = taken()
            plain_ms = cuda_ms(step, reps)
            expect_counts("sparse step (plain chain)", launch_counts())
            chosen.clear()
            replay.extend(got_chose)
            want = step()
    finally:
        dsa_module.index_topk = index_topk
        mla_module.takes, moe_module.takes = real
    # per row, the share of the kernel chain's positions the plain chain
    # chose too (both sorted)
    shared = [float((c.gather(-1, torch.searchsorted(c, a).clamp(max=k - 1))
                     == a).float().mean(-1).min())
              for a, c in zip(got_chose, own_chose)]
    errs = ((got.float() - want.float()).abs().amax(1)
            / want.float().abs().amax(1))
    err = {"median": float(errs.median()),
           "p90": float(errs.quantile(0.9)), "max": float(errs.max())}
    g_errs = ((replayed.float() - got.float()).abs().amax(1)
              / got.float().abs().amax(1))
    g_err = {"median": float(g_errs.median()),
             "p90": float(g_errs.quantile(0.9)), "max": float(g_errs.max())}
    row = {"case": f"{SPARSE_ARCH} decode_step B={b} L={SPARSE_LENGTH} "
                   f"({cfg.n_layers} layers)",
           "selected": list(got_chose[0].shape),
           "least_shared_by_layer": shared,
           "logits_rel_err": err, "step_ms": ms, "plain_step_ms": plain_ms,
           "graph_rel_err": g_err,
           "graph_bitwise": bool(torch.equal(replayed, got)),
           "graph_step_ms": graph_ms,
           "finite": bool(torch.isfinite(got).all())}
    emit("sparse_step", launches=counts, **row)
    if (not row["finite"] or shared[0] != 1.0
            or got_chose[0].shape != (b, 1, k)
            or not torch.equal(graph_chose, got_chose[0])
            or any(err[name] > limit or g_err[name] > limit
                   for name, limit in MLA_STEP_LIMITS.items())):
        raise AssertionError(f"sparse step: {row}")
    del model, cache, want, got, replayed
    return row


# ---------------------------------------------------------------------------
# Phase 1d: the held experts' decode FFN
# ---------------------------------------------------------------------------

# one decode step of the cell's MoE layer: 1024 tokens routed over 384
# experts, top 8, 8 held, at Kimi-K2's widths
HELD_TOKENS, HELD_LAYERS = 1024, 4


def held_f64(x, w_gate, w_up, w_down, weights, key, held: int
             ) -> torch.Tensor:
    """The held experts' FFN in f64 over each expert's routed tokens,
    nothing rounded: the yardstick of the kernel's and the plain
    version's error."""
    out = torch.zeros(x.shape, dtype=torch.float64, device=x.device)
    for e in range(held):
        tok, place = (key == e).nonzero(as_tuple=True)
        if not len(tok):
            continue
        xe = x[tok].double()
        h = F.silu(xe @ w_gate[e].double()) * (xe @ w_up[e].double())
        out.index_add_(0, tok, (h @ w_down[e].double())
                       * weights[tok, place].double()[:, None])
    return out


def phase_held(seed: int, dev, reps: int = 20) -> dict:
    """Phase 1d -> the kernel's row.  ``held_expert_ffn`` at the decode
    cell's shapes on seeded routing, its slot lists built on the card:
    held, with its plain version, against the f64 product, where its
    largest error must be at most 1.1x the plain version's; its time
    (the slot lists built on the card, then the products) against the
    least time by bytes (each held expert's weights read once, the routed
    rows read and the f32 output written once), the plain version's, and
    the dense chain's it replaced (every held expert over every token,
    weighted and summed in f32) as the library yardstick."""
    cfg = get_config(MLA_ARCH)
    moe = dataclasses.replace(cfg.moe, n_held=MLA_HELD, held_from=0)
    d, fe, held, t = cfg.d_model, moe.d_expert, moe.held, HELD_TOKENS
    gen = torch.Generator(device=dev).manual_seed(seed + 7)

    def draw(*shape, std=0.02, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=gen, device=dev) * std).to(dtype)

    x = draw(t, d, std=1.0)
    router, bias = draw(d, moe.n_experts, dtype=torch.float32), \
        draw(moe.n_experts, std=0.01, dtype=torch.float32)
    w_gate, w_up, w_down = draw(held, d, fe), draw(held, d, fe), \
        draw(held, fe, d)
    w, top_e = moe_module.route_sigmoid(router, bias, x, moe)
    key = torch.where(top_e < held, top_e, held)
    args = (x, w_gate, w_up, w_down, w, key)

    before = held_expert_ffn.launches
    got = held_expert_ffn(*args)
    if held_expert_ffn.launches != before + 1:
        raise AssertionError("held_expert_ffn: not one launch a call")
    again = held_expert_ffn(*args)
    plain = held_expert_ffn_plain(*args)
    ref = held_f64(x, w_gate, w_up, w_down, w, key, held)

    def dense():
        """Every held expert over every token, weighted and summed in
        f32: the decode arm this kernel replaced."""
        cw = torch.zeros((t, held + 1), dtype=torch.float32, device=dev)
        cw.scatter_(1, key, w)
        ye = torch.matmul(F.silu(torch.matmul(x, w_gate))
                          * torch.matmul(x, w_up), w_down)
        return (ye.float() * cw[:, :held].t()[:, :, None]).sum(0)

    ends = held_slots(key, held)[1]
    counts = torch.diff(ends[:held], prepend=ends.new_zeros(1)).tolist()
    n = sum(counts)
    nbytes = 3 * held * d * fe * 2 + n * d * 2 + t * d * 4
    flops = 2 * n * 3 * d * fe
    row = {
        "name": "held_expert_ffn",
        "case": f"t={t} d={d} fe={fe} held={held} k={moe.top_k}",
        "dtype": "bfloat16", "shape": list(got.shape),
        "slots": n, "slots_per_expert": counts, "slots_most": max(counts),
        "max_abs_err": float((got.double() - ref).abs().max()),
        "plain_max_abs_err": float((plain.double() - ref).abs().max()),
        "dense_max_abs_err": float((dense().double() - ref).abs().max()),
        "bitwise_repeat": bool(torch.equal(got, again)),
        "ms": cuda_ms(lambda: held_expert_ffn(*args), reps),
        "plain_ms": cuda_ms(lambda: held_expert_ffn_plain(*args), 3),
        "library_ms": cuda_ms(dense, reps),
    }
    row["ok"] = (row["max_abs_err"] <= 1.1 * row["plain_max_abs_err"]
                 and row["bitwise_repeat"])
    row["bound_ms"], row["bound_by"] = bound(nbytes, flops, BF16_FLOPS_PER_S)
    row["bound_share"] = row["bound_ms"] / row["ms"]
    row["step_ms"] = HELD_LAYERS * row["ms"]
    row["step_library_ms"] = HELD_LAYERS * row["library_ms"]
    row["bytes"], row["flops"] = nbytes, flops
    emit("kernels", **row)
    if not row["ok"]:
        raise AssertionError(f"held_expert_ffn: error {row['max_abs_err']} "
                             f"against f64, the plain version's "
                             f"{row['plain_max_abs_err']}, bitwise repeat "
                             f"{row['bitwise_repeat']}")
    return row


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


def decode_step_bytes(model, batch: int, context: float,
                      expert_share: float = 1.0) -> float:
    """Bytes one decode step must move: every weight once (of the
    embedding only the batch's rows; of an MoE layer's experts the share
    ``expert_share`` the step routes to), the K/V of ``context``
    positions per attention layer, a mamba layer's conv window and state
    read and written, the logits written once."""
    cfg = model.cfg
    esz = model.embed.element_size()
    weights = 0.0
    for name, p in model.named_parameters():
        share = expert_share if ".moe.w_" in name else 1.0
        weights += p.numel() * p.element_size() * share
    if not cfg.tie_embeddings:
        weights += (batch - cfg.vocab) * cfg.d_model * esz
    cache = 0.0
    for c in model.init_cache(batch, 1)["layers"]:
        if "state" in c:
            cache += 2 * sum(v.numel() * v.element_size() for v in c.values())
        else:
            cache += context * sum(c[n].numel() * c[n].element_size()
                                   for n in ("k", "v"))
    return weights + cache + batch * cfg.vocab * 4


def expert_share(log: "RouteLog", n_experts: int, batch: int) -> float:
    """The mean share of an MoE layer's experts that a decode step's
    tokens route to (the calls of ``batch`` tokens)."""
    shares = [len(torch.unique(top_e)) / n_experts
              for top_e, _ in log.calls if top_e.shape[0] == batch]
    return float(np.mean(shares)) if shares else 1.0


def left_padded(prompts) -> np.ndarray:
    """A wave's tokens as the engine lays them out (left-padded with 0)."""
    plen = max(len(p) for p in prompts)
    toks = np.zeros((len(prompts), plen), np.int32)
    for j, p in enumerate(prompts):
        toks[j, plen - len(p):] = p
    return toks


class RouteLog:
    """Every routing of an MoE layer while active: each call's top-k
    experts (t, k), recomputed with the routing's own f32 product, and
    its capacity-keep mask (t * k), in call order (layer by layer)."""

    def __enter__(self) -> "RouteLog":
        self.calls = []
        self._real = real = moe_module._route_tokens

        def logged(router, tokens, moe, cap):
            out = real(router, tokens, moe, cap)
            with moe_module._full_f32():
                logits = torch.einsum("td,de->te", tokens.float(),
                                      router.float())
            top_e = torch.topk(torch.softmax(logits, dim=-1), moe.top_k,
                               dim=-1)[1]
            self.calls.append((top_e, out[3]))
            return out

        moe_module._route_tokens = logged
        return self

    def __exit__(self, *exc) -> None:
        moe_module._route_tokens = self._real

    def dropped_share(self) -> float:
        kept = sum(int(keep.sum()) for _, keep in self.calls)
        return 1.0 - kept / max(1, sum(k.numel() for _, k in self.calls))


@contextlib.contextmanager
def no_drop(model):
    """An MoE model at a capacity factor where no slot can drop
    (n_experts / top_k: every expert gets a slot for every token); a
    model without MoE as it is."""
    cfg = model.cfg
    if cfg.moe is None:
        yield cfg
        return
    wide = cfg.with_(moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
    # the model and each layer, which keeps the config it was built with
    holders = [m for m in model.modules() if getattr(m, "cfg", None) is cfg]
    for m in holders:
        m.cfg = wide
    try:
        yield wide
    finally:
        for m in holders:
            m.cfg = cfg


def route_agreement(calls: list, n_layers: int, b: int, p: int,
                    steps: int) -> float:
    """The share of (token, layer, slot) choices of a prefill of p tokens
    and ``steps`` decode steps equal to a fresh forward's over all of
    them (``calls``: the routings of the prefill, each step and the
    forward, each layer by layer)."""
    pre = calls[:n_layers]
    dec = [calls[(1 + i) * n_layers:(2 + i) * n_layers]
           for i in range(steps)]
    fwd = calls[(1 + steps) * n_layers:(2 + steps) * n_layers]
    same = total = 0
    s = p + steps
    for layer in range(n_layers):
        full = fwd[layer][0].view(b, s, -1)
        got = [pre[layer][0].view(b, p, -1)] + [
            d[layer][0].view(b, 1, -1) for d in dec]
        want = [full[:, :p]] + [full[:, p + i:p + i + 1]
                                for i in range(steps)]
        for g, w in zip(got, want):
            same += int((g == w).sum())
            total += g.numel()
    return same / total


def check_cache(model, toks: np.ndarray, max_len: int, limit: float,
                steps: int = 1, cached=contextlib.nullcontext, **kw) -> dict:
    """Prefill, then ``steps`` greedy decode steps, against one fresh
    forward over the prompt and those tokens: each set of logits within
    ``limit`` x max|logit| of the forward's at the same position.  An MoE
    model runs at a capacity where nothing drops (a fresh forward over
    more tokens drops other slots), and the line reports the share of
    routing choices equal to the forward's.  ``kw``: the family's prefix
    (``image_embeds``, ``frames``); ``cached()``: the context the prefill
    and the decode steps run in (the forward runs outside it)."""
    with torch.inference_mode(), no_drop(model), RouteLog() as log:
        with cached():
            last, cache = model.prefill(toks, max_len=max_len, **kw)
            got, fed = [last], []
            for _ in range(steps):
                nxt = got[-1].argmax(dim=-1)[:, None]
                fed.append(nxt)
                out, cache = model.decode_step(cache, nxt)
                got.append(out)
        full, _ = model(torch.cat([torch.as_tensor(toks, device=last.device)]
                                  + [f.int() for f in fed], dim=1), **kw)
    row = {"dtype": str(model.dtype).removeprefix("torch."),
           "limit": limit, "decode_steps": steps}
    want = full[:, -steps - 1:]
    errs = [rel_err(g, want[:, i].double()) for i, g in enumerate(got)]
    row["prefill_rel_err"] = errs[0]
    row["decode_rel_err"] = max(errs[1:])
    if model.cfg.moe is not None:
        row["capacity_factor"] = model.cfg.moe.n_experts / model.cfg.moe.top_k
        row["dropped_share"] = log.dropped_share()
        row["route_agreement"] = route_agreement(
            log.calls, model.cfg.n_layers, toks.shape[0], toks.shape[1],
            steps)
        if row["dropped_share"] != 0.0:
            raise AssertionError(f"serve cache: slots dropped {row}")
    for key in ("prefill", "decode"):
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
        return device_census("decode_step", step, p50)


def device_census(label: str, fn, p50_ms: float) -> dict:
    """One call of ``fn`` under ``torch.profiler``: its device kernels,
    the device's busy share of ``p50_ms`` (the call's wall time, host
    clock, untraced) and the kernels that take the most device time.
    The call launches none of the port's kernels."""
    acts, attempts = trace_whole(label, fn, traced_ran)
    busy = busy_us(acts) / 1e3
    by_name: dict = {}
    for name, start, end in acts:
        key = name.removeprefix("void ").split("<")[0].split("(")[0][:60]
        by_name[key] = by_name.get(key, 0.0) + (end - start) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    row = {"call": label, "device_kernels": len(acts),
           "device_busy_ms": busy, "p50_ms": p50_ms,
           "busy_share": busy / p50_ms, "idle_share": 1.0 - busy / p50_ms,
           "top_kernels_ms": [[k, v] for k, v in top], "traces": attempts}
    emit("census", **row)
    if any(traced_ran(acts).values()):
        raise AssertionError(f"{label}: port kernels {traced_ran(acts)}")
    return row


def check_head(plan, engine, cfg, params, gen, dev, where: str
               ) -> tuple[list, list, torch.Tensor]:
    """The coded head against f64 truth under 5 of the engine's own
    masks (its last logit column too: a head whose vocab does not divide
    by k is padded at the encode and cut at the decode), 1
    ``bcsr_matmul`` + 1 ``decode_matmul`` per call -> (pattern rows,
    masks, hidden)."""
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
        expect_counts(f"{where}: one coded_logits", launched_since(before),
                      bcsr_matmul=1, cyclic_encode=0, decode_matmul=1)
        if got.shape != (2, cfg.vocab) or got.dtype != hidden.dtype:
            raise AssertionError(f"coded_logits: {got.dtype} {got.shape}")
        row = check_decoded(
            where, dtype, plan, done, got, ref, cfg.d_model,
            lambda rows: mv_stored_decode(plan, rows, hidden, cfg.vocab))
        row["last_column_rel_err"] = float(
            (got[:, -1].double() - ref[:, -1]).abs().max() / ref.abs().max())
        if not row["last_column_rel_err"] <= row["bound"]:
            raise AssertionError(f"{where} last column: {row}")
        patterns.append(row)
    return patterns, masks, hidden


def phase_serve(seed: int, dev, gen, arch: str = "phi3-mini-3.8b",
                smoke: bool = False, line: tuple = ("serve", {}),
                steps: int = 1, bf16_limit: float = 2e-2,
                extra=None) -> dict:
    """The launcher's path (``build``, ``make_requests``, ``serve``,
    ``check_coded_head``) with its defaults, then the serve checks: the
    coded head under 5 engine masks, the cache against a fresh forward
    over ``steps`` decode steps (bf16 within ``bf16_limit``, and f32 on
    the same weights within 2e-4), a traced decode step, and
    ``extra(model, toks)``'s fields when given.  The line goes out as
    ``line`` (phase, fields)."""
    argv = ["--arch", arch, "--coded", "--seed", str(seed),
            "--device", str(dev)] + (["--smoke"] if smoke else [])
    args = launcher.parse_args(argv)
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()

    # the main path: build, serve, the launcher's coded-head check
    reset_launch_counts()
    t0 = time.perf_counter()
    compile_s = []
    with timed_compiles(compile_s):
        (cfg, model, params, engine), printed = launcher_call(
            launcher.build, args)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    expect_counts(f"{cfg.name} build", launch_counts(), bcsr_matmul=0,
                  cyclic_encode=1, decode_matmul=0)
    plan = engine.coded
    timer = StepTimer(engine)
    rng = np.random.default_rng(args.seed)
    reqs = launcher.make_requests(args, cfg, rng)
    before = launch_counts()
    t0 = time.perf_counter()
    with RouteLog() as routed:
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
    moe_fields = {}
    share = 1.0
    if cfg.moe is not None:
        share = expert_share(routed, cfg.moe.n_experts, args.batch)
        moe_fields = {"capacity_factor": cfg.moe.capacity_factor,
                      "dropped_share": routed.dropped_share(),
                      "decode_expert_share": share}
    bound_ms = decode_step_bytes(model, args.batch, context, share) \
        / HBM_BYTES_PER_S * 1e3

    patterns, masks, hidden = check_head(plan, engine, cfg, params, gen,
                                         dev, cfg.name)
    coded_p50 = host_p50_ms(lambda: engine.coded_logits(hidden, masks[0]),
                            20)

    # cache consistency, bf16 and then f32 on the same weights
    waves = [r.prompt for r in reqs[: args.batch]]
    toks = left_padded(waves)
    before = launch_counts()
    cache_checks = [check_cache(model, toks, args.max_len, bf16_limit,
                                steps)]
    step = step_census(model, toks, args.max_len)
    model32 = build_model(cfg, torch.float32, device=dev)
    model32.load_state_dict(params)
    cache_checks.append(check_cache(model32, toks, args.max_len, 2e-4,
                                    steps))
    del model32
    extra_fields = extra(model, toks) if extra is not None else {}
    expect_counts("prefill and decode", launched_since(before),
                  bcsr_matmul=0, cyclic_encode=0, decode_matmul=0)

    emit(line[0], **line[1], arch=cfg.name,
         dtype=str(model.dtype).removeprefix("torch."),
         params_b=sum(p.numel() for p in model.parameters()) / 1e9,
         layers=cfg.n_layers, d_model=cfg.d_model, vocab=cfg.vocab,
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
         bound_note="weights (routed experts only) + K/V at the mean "
                    "context + mamba state over 3.35 TB/s",
         peak_memory_gb=peak_gb, launcher_worst_rel_err=worst,
         coded_patterns=patterns, coded_logits_p50_ms=coded_p50,
         decode_step_busy_share=step["busy_share"],
         cache=cache_checks, launches=counts, **moe_fields, **extra_fields,
         printed=printed, wall_s=time.perf_counter() - t_phase)
    return {"engine": engine, "hidden": hidden, "done": masks[0],
            "counts": counts, "p50": coded_p50, "model": model,
            "params": params, "cfg": cfg, "args": args}


def encode_row(plan, case: str, reps: int = 3) -> dict:
    """``cyclic_encode`` at a compiled plan's shapes: the encode of its
    operand that the compile ran."""
    dev = plan.device
    R = mv_encoding_matrix(plan.scheme, plan.seed)
    sup, coef = support_tables(plan.scheme.supports, R)
    blocks = split_block_columns(plan._A, plan.scheme.k_A)
    if blocks.stride(-1) != 1:          # a tied head: encode_blocks' copy
        blocks = blocks.contiguous()
    return check_encode(blocks, torch.as_tensor(sup, device=dev),
                        torch.as_tensor(coef, device=dev), R, case, reps)


def kernels_product(plan, x, done, case: str, reps: int) -> list[dict]:
    """``bcsr_matmul`` and ``decode_matmul`` of one matvec of ``plan``
    (x (N, t): N columns) under ``done``."""
    ex = plan.executor
    dplan = ex.cache.plan(done)
    rows = [check_bcsr_mv(plan, x, done, case, reps)]
    y = bcsr_matmul(ex.packed.a_data, ex.packed.a_idx, x.T.contiguous(),
                    dplan.rows_dev, mb=ex.packed.mb, counts=ex.packed.counts)
    rows.append(check_decode(dplan.hinv_dev,
                             y.view(ex.k, ex.packed.c_pad, -1), "mv", reps,
                             case=case, c=ex.packed.c, r=ex.r))
    return rows


def kernels_serve(serve: dict, reps: int, case: str = "serve"
                  ) -> list[dict]:
    """The three kernels at the serve geometry: the head's encode at
    build, and one coded_logits call's product and decode."""
    plan = serve["engine"].coded
    rows = kernels_product(plan, serve["hidden"], serve["done"], case, reps)
    return rows[:1] + [encode_row(plan, case)] + rows[1:]


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


def card_fleet(where: str, fleet) -> None:
    if fleet.backend != "cuda" or fleet.device.type != "cuda":
        raise AssertionError(f"{where}: workers compute with "
                             f"{fleet.backend} on {fleet.device}")


def card_workers(where: str, cl) -> None:
    card_fleet(where, cl.fleet)


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
                  kernel_reps: int = 50) -> tuple[dict, list, dict]:
    """The serve engine's cluster mode on the serve phase's model, the
    Fig. 4 matmat over ``to_cluster``, and the head over the ``pipe``
    transport, all with card workers, each path's launches counted from
    0; between the first two, the kernel rows at the cluster's shapes and
    the ``census`` of one cluster round; last, a racing round and the
    decode row's trace taken again, which must be whole after the pipe
    children.  -> (the path's launch counts, summed; the kernel rows;
    what the edge phase holds its results to)."""
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
    rows, decode_call = kernels_cluster(
        plan, hidden, masks[0], PlanShard.decode(cl.handle.shard_blobs[0]),
        kernel_reps)
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
            want_child = {w: {**dict.fromkeys(per_child[w], 0),
                              "bcsr_matmul": served.get(w, 0)}
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
    edge = {"plan": plan, "hidden": hidden, "masks": masks, "wants": wants,
            "ref": ref, "dtype": dtype, "d": d, "stored": stored,
            "engine": engine0}
    return counts, rows, edge


def kernels_cluster(plan, hidden, done, shard: PlanShard, reps: int,
                    case: str = "cluster") -> tuple[list[dict], object]:
    """bcsr_matmul on one card worker's task of the plan (its re-tiled
    f32 form, from ``shard``) and the fleet's decode of the plan, each
    against its plain version.  -> (the rows, a call of that decode's
    launch, for a later trace)."""
    dev = hidden.device
    task = CardTask(shard, shard.tasks[0], dev)
    packed = task.packed
    b = torch.zeros((shard.t_pad, hidden.shape[0]), device=dev)
    b[: shard.t] = hidden.T
    dense = unpack_coded_blocks(packed)[0].T.contiguous()     # (c, t)
    rows = [check_kernel(
        "bcsr_matmul", case,
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
    rows.append(check_decode(dplan.hinv_dev, y, "mv", reps, case=case,
                             **kw))
    layout = prepare_decode(dplan.hinv_dev, y, "mv", **kw)
    return rows, lambda: launch_decode(layout, dplan.hinv_dev, y, None)


def reencode_rows(plan, x, done, case: str, reps: int) -> list[dict]:
    """The three kernels at the shapes a fleet re-encoded to: the
    compile's encode, a card worker's task and the fleet's decode of a
    round at ``x``'s width under ``done``."""
    shard = shard_plan(plan, plan.n, packed=plan_packed(plan))[0]
    rows, _ = kernels_cluster(plan, x, done, shard, reps, case)
    return [encode_row(plan, case)] + rows


# ---------------------------------------------------------------------------
# Phase 8: the edge cluster across processes and hosts, and under chaos
# ---------------------------------------------------------------------------

# the tcp fleet's slowed worker (the attribution check names it)
EDGE_SLOW = 4
# how long a remote worker may take to join and be caught up (its CUDA
# context, then the re-encode back to full strength and its shard)
REMOTE_WAIT_S = 300.0
# the tcp chaos run's warm-up: four card children start and attach
# before the schedule's epoch (six were ready in 9-11 s in the pipe path)
CHAOS_TCP_WARMUP_S = 30.0
# the JAX package's storm of test_memory_within_budget_all_resolve_bitwise
CHAOS_STORM = [
    ChaosEvent(kind="slow", t0=0.2, t1=1.0, worker=2, delay_s=0.1),
    ChaosEvent(kind="kill", t0=0.5, t1=1.2, worker=1),
    ChaosEvent(kind="join", t0=0.8),
    ChaosEvent(kind="leave", t0=1.1, worker=3),
    ChaosEvent(kind="reconnect", t0=1.6, worker=1),
]


def wait_for(what: str, pred, timeout: float) -> float:
    t0 = time.perf_counter()
    while not pred():
        if time.perf_counter() - t0 > timeout:
            raise AssertionError(f"{what}: not within {timeout} s")
        time.sleep(0.05)
    return time.perf_counter() - t0


def add_counts(*counts: dict) -> dict:
    return {name: sum(c.get(name, 0) for c in counts) for name in SOURCES}


def children_on_card(where: str, reports: dict, pids: dict) -> dict:
    """Each child in its own words: its pid, the card, device memory its
    shard holds, its launches."""
    card = torch.cuda.get_device_name(0)
    bad = [w for w, r in reports.items()
           if r["pid"] != pids[w] or r["backend"] != "cuda"
           or not r["device"].startswith("cuda") or r["device_name"] != card
           or r["memory_allocated"] <= 0]
    if sorted(reports) != sorted(pids) or bad:
        raise AssertionError(f"{where}: children {sorted(pids)} (bad: {bad}) "
                             f"do not compute on the card: {reports}")
    return {w: {"pid": r["pid"], "device_name": r["device_name"],
                "memory_allocated": r["memory_allocated"],
                "launches": r["launches"]} for w, r in reports.items()}


def edge_rounds(where: str, cl, e: dict, masks, wants) -> tuple:
    """Explicit-mask rounds over a process cluster: per round the parent
    launches one ``decode_matmul`` and no ``bcsr_matmul``, and each child
    one ``bcsr_matmul`` per task it returned (by its own report); each
    result is bitwise the in-process engine's and within max(REL, κ·ε)
    of f64.  -> (the checks, children's launches per round, the last
    reports)."""
    tr, plan = cl.transport, e["plan"]
    prev = tr.reports()
    checks, per_round = [], []
    for done, want in zip(masks, wants):
        before = launch_counts()
        got = cl.matvec(e["hidden"], done)
        torch.cuda.synchronize()
        expect_counts(f"one {where} matvec (parent)", launched_since(before),
                      bcsr_matmul=0, cyclic_encode=0, decode_matmul=1)
        now = tr.reports()
        per_child = {w: {name: c - prev[w]["launches"][name]
                         for name, c in now[w]["launches"].items()}
                     for w in now}
        served = cl.last_report.completed_per_worker
        if sorted(per_child) != sorted(prev) or \
                sum(served.values()) < plan.k:
            raise AssertionError(f"one {where} matvec: children "
                                 f"{sorted(per_child)}, served {served}")
        for w, c in per_child.items():
            expect_counts(f"one {where} matvec (child {w})", c,
                          bcsr_matmul=served.get(w, 0), cyclic_encode=0,
                          decode_matmul=0)
        per_round.append(sum(served.values()))
        prev = now
        row = hold_parity(where, got, want, e["dtype"], plan, done, e["ref"],
                          e["d"], e["stored"])
        if not row["bitwise_in_process"]:
            raise AssertionError(f"{where}: not bitwise the in-process "
                                 f"engine: {row}")
        checks.append(row)
    clean(where, cl.reports)
    return checks, per_round, prev


def check_chaos(where: str, res, calls: int) -> dict:
    """A chaos run's outcomes: every call resolved or failed with a
    structured error, every resolved value bitwise its replay and close
    to the fault-free result (run_chaos asserts both), none failed
    within the budget."""
    c = res.counts()
    if sum(c.values()) != calls or (res.max_concurrent <= res.s
                                    and c["failed"]):
        raise AssertionError(f"{where}: {res.as_dict()}")
    resolved = [o for o in res.outcomes if o.outcome != "failed"]
    if not resolved or not all(o.bitwise and o.correct for o in resolved):
        raise AssertionError(f"{where}: {res.outcomes}")
    return res.as_dict()


def phase_edge(seed: int, dev, e: dict) -> dict:
    """The edge cluster across processes and hosts, on the serve phase's
    head (n=6, s=2) with card workers: (e1) the plan spans of one
    compile and one retune; (a) the head over ``tcp`` with six spawned
    card children, one of them slowed, under the cluster phase's 5 masks
    and the all-alive one; (e2) 8 traced racing rounds on that fleet,
    whose attribution names the slowed worker; (b) worker 2 removed and
    replaced by a remote ``python -m repro_torch.cluster.worker
    --connect`` process on the card; (c) the head over ``shm``; (d)
    ``run_chaos`` with card workers on ``memory`` at head width and on
    ``tcp`` at the JAX package's geometry.  -> the path's launches, the
    children's included."""
    plan, hidden = e["plan"], e["hidden"]
    n, k = plan.n, plan.k
    all_alive = np.ones(n, bool)
    masks = list(e["masks"]) + [all_alive]
    wants = list(e["wants"]) + [e["engine"].coded_logits(hidden, all_alive)]
    torch.cuda.synchronize()
    totals = []

    # -- (e1) the plan spans, on the process-global tracer -----------------
    t_sub = time.perf_counter()
    os.environ["REPRO_TRACE"] = "1"
    trace_mod._GLOBAL = None
    tracer = trace_mod.default_tracer()
    gen = torch.Generator(device=dev).manual_seed(seed + 8)
    small = block_sparse(gen, dev, 1024, 512, 0.5)
    reset_launch_counts()
    sp = compile_plan(small, scheme="proposed", n=n, s=plan.s,
                      backend=plan.backend)
    sp.retune(block_sparse(gen, dev, 1024, 512, 0.5))
    torch.cuda.synchronize()
    span_counts = launch_counts()
    expect_counts("edge compile + retune", span_counts, bcsr_matmul=0,
                  cyclic_encode=2, decode_matmul=0)
    totals.append(span_counts)
    spans = [{"name": ev["name"], "args": ev["args"]}
             for ev in tracer.events() if ev["cat"] == "plan"]
    # the retune re-picks the backend: on the card, cuda again
    if [(s_["name"], s_["args"]["backend"]) for s_ in spans] != [
            ("plan.encode", plan.backend), ("plan.compile", plan.backend),
            ("plan.encode", sp.backend)]:
        raise AssertionError(f"edge plan spans: {spans}")
    emit("edge", case="plan-spans", spans=spans, launches=span_counts,
         wall_s=time.perf_counter() - t_sub)
    del sp, small

    # -- (a) tcp, six spawned card children --------------------------------
    t_sub = time.perf_counter()
    reset_launch_counts()
    t0 = time.perf_counter()
    cl = plan.to_cluster(transport="tcp", faults=adversarial_faults(
        [EDGE_SLOW], slowdown=40.0, time_scale=2e-3))
    remote = None
    try:
        start_s = time.perf_counter() - t0
        card_workers("tcp cluster", cl)
        tr, h, fleet = cl.transport, cl.handle, cl.fleet
        pids = {w: p.pid for w, p in tr._procs.items()}
        ready = max(s_["ready_s"] for s_ in tr.startup.values())
        want_acks = {w: hashlib.sha256(blob).hexdigest()
                     for w, blob in enumerate(h.shard_blobs)}
        wait_for("tcp shard acks", lambda: tr.shard_acks == want_acks, 60.0)
        t0 = time.perf_counter()
        checks, per_round, reps_a = edge_rounds("tcp", cl, e, masks, wants)
        rounds_s = time.perf_counter() - t0
        children = children_on_card("tcp", reps_a, pids)
        rep = cl.last_report
        a_counts = launch_counts()
        expect_counts("edge tcp (parent)", a_counts, bcsr_matmul=0,
                      cyclic_encode=0, decode_matmul=len(masks))
        a_child = {name: sum(r["launches"][name] for r in reps_a.values())
                   for name in SOURCES}
        expect_counts("edge tcp (children)", a_child,
                      bcsr_matmul=sum(per_round), cyclic_encode=0,
                      decode_matmul=0)
        totals += [a_counts, a_child]
        emit("edge", case="tcp", transport="tcp", workers=len(pids),
             start_s=start_s, ready_s_max=ready,
             attach_s=start_s - ready, startup=tr.startup,
             bytes_shards=cl.bytes_shards, shard_acks=len(tr.shard_acks),
             children=children, child_bcsr_per_round=per_round,
             patterns=checks, rounds_s=rounds_s,
             bytes_tasks_per_round=rep.bytes_tasks,
             round_wall_s=[r.wall_s for r in cl.reports],
             launches=a_counts, child_launches=a_child,
             wall_s=time.perf_counter() - t_sub)

        # -- (e2) 8 traced racing rounds: attribution names the slow one ---
        t_sub = time.perf_counter()
        reset_launch_counts()
        prev = tr.reports()
        raced = []
        for _ in range(8):
            got = cl.matvec(hidden)
            torch.cuda.synchronize()
            r_ = cl.last_report
            raced.append(check_decoded("tcp racing", e["dtype"], plan,
                                       r_.pattern, got, e["ref"], e["d"],
                                       e["stored"]))
        e_counts = launch_counts()
        expect_counts("edge traced rounds (parent)", e_counts,
                      bcsr_matmul=0, cyclic_encode=0, decode_matmul=8)
        now = tr.reports()
        e_child = {name: sum(now[w]["launches"][name]
                             - prev[w]["launches"][name] for w in now)
                   for name in SOURCES}
        # every round's k fastest answered; a cancel may land before a
        # slow child starts its task, so between 8k and 8n in all
        expect_between("edge traced rounds (children)", e_child,
                       bcsr_matmul=(8 * k, 8 * n), cyclic_encode=(0, 0),
                       decode_matmul=(0, 0))
        totals += [e_counts, e_child]
        attrib = attribute(tracer.events())
        rates = fleet.observed_rates()
        if attrib.suspects()[0] != EDGE_SLOW or rates is None or \
                min(rates, key=rates.get) != EDGE_SLOW:
            raise AssertionError(f"edge attribution: suspects "
                                 f"{attrib.suspects()}, rates {rates}")
        emit("edge", case="traced", rounds=len(attrib.rounds),
             suspects=attrib.suspects(), slowed=EDGE_SLOW,
             compute_rates=rates, phase_totals_s=attrib.phase_totals(),
             table=attrib.table().splitlines(), racing=raced,
             launches=e_counts, child_launches=e_child,
             wall_s=time.perf_counter() - t_sub)

        # -- (b) worker 2 leaves, a remote card worker joins as 2 ----------
        t_sub = time.perf_counter()
        reset_launch_counts()
        prev = {w: r for w, r in tr.reports().items() if w != 2}
        fleet.remove_worker(2)
        root = Path(__file__).resolve().parent
        # the remote computes where the fleet's workers do: on the card
        remote = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.cluster.worker",
             "--connect", f"127.0.0.1:{tr.port}", "--id", "2",
             "--device", str(fleet.device)],
            env={**os.environ, "PYTHONPATH": str(root / "src")},
            stdout=subprocess.PIPE, text=True)
        ps = h._ps

        def caught_up() -> bool:
            return (h.plan is plan and ps.n_shards == n
                    and not ps.pending_reencode and tr.alive(2)
                    and any(pid == h.plan_id for pid, _ in
                            fleet._held.get(2, ())))

        join_s = wait_for("remote worker 2 caught up", caught_up,
                          REMOTE_WAIT_S)
        idx = next(i for pid, i in fleet._held[2] if pid == h.plan_id)
        digest = hashlib.sha256(ps.shard_blobs[idx]).hexdigest()
        wait_for("remote shard ack", lambda: tr.shard_acks.get(2) == digest,
                 60.0)
        rows2 = sorted(row for row, o in ps.owner.items() if o == 2)
        pick = next((i for i, m in enumerate(e["masks"]) if m[rows2].all()),
                    None)
        if pick is None:
            raise AssertionError(f"no cluster mask needs worker 2's rows "
                                 f"{rows2}")
        b_masks, b_wants = [all_alive, masks[pick]], [wants[-1], wants[pick]]
        b_checks, b_reports = [], []
        for done, want in zip(b_masks, b_wants):
            got = cl.matvec(hidden, done)
            torch.cuda.synchronize()
            b_reports.append(cl.last_report)
            row = hold_parity("remote", got, want, e["dtype"], plan, done,
                              e["ref"], e["d"], e["stored"])
            if not row["bitwise_in_process"]:
                raise AssertionError(f"remote: not bitwise (a): {row}")
            b_checks.append(row)
        clean("remote", b_reports)
        now = {w: r for w, r in tr.reports().items() if w != 2}
        b_local = {name: sum(now[w]["launches"][name]
                             - prev[w]["launches"][name] for w in now)
                   for name in SOURCES}
        b_counts = launch_counts()
        # the parent: one re-encode per compiled shrink (the leave), none
        # for the return to full strength (the first compile is reused)
        expect_counts("edge remote (parent)", b_counts, bcsr_matmul=0,
                      cyclic_encode=len(ps._plan_cache), decode_matmul=2)
        served2 = sum(r.completed_per_worker.get(2, 0) for r in b_reports)
        served = sum(sum(r.completed_per_worker.values()) for r in b_reports)
        if served2 < 1:
            raise AssertionError(f"edge remote: worker 2 served none of "
                                 f"{[r.completed_per_worker for r in b_reports]}")
        expect_counts("edge remote (local children)", b_local,
                      bcsr_matmul=served - served2, cyclic_encode=0,
                      decode_matmul=0)
    finally:
        cl.shutdown()
        if remote is not None:
            try:
                out, _ = remote.communicate(timeout=60)
            finally:
                if remote.poll() is None:
                    remote.kill()
                    remote.wait()
    report = json.loads(out.strip().splitlines()[-1])
    if remote.returncode != 0 or report["backend"] != fleet.backend or \
            report["device_name"] != torch.cuda.get_device_name(0):
        raise AssertionError(f"remote worker: rc {remote.returncode}, "
                             f"report {report}")
    expect_counts("remote worker (its report)", report["launches"],
                  bcsr_matmul=served2, cyclic_encode=0, decode_matmul=0)
    totals += [b_counts, b_local, report["launches"]]
    emit("edge", case="remote", join_s=join_s, rows=rows2,
         mask=masks[pick].tolist(), patterns=b_checks, remote=report,
         reencodes=len(ps._plan_cache), launches=b_counts,
         local_child_launches=b_local, wall_s=time.perf_counter() - t_sub)
    os.environ.pop("REPRO_TRACE", None)
    trace_mod._GLOBAL = None

    # -- (c) shm, six card children ----------------------------------------
    t_sub = time.perf_counter()
    reset_launch_counts()
    t0 = time.perf_counter()
    cl = plan.to_cluster(transport="shm")
    try:
        start_s = time.perf_counter() - t0
        card_workers("shm cluster", cl)
        tr = cl.transport
        prefix = tr.prefix
        pids = {w: p.pid for w, p in tr._procs.items()}
        ready = max(s_["ready_s"] for s_ in tr.startup.values())
        t0 = time.perf_counter()
        checks, per_round, reps_c = edge_rounds("shm", cl, e, masks, wants)
        rounds_s = time.perf_counter() - t0
        children = children_on_card("shm", reps_c, pids)
        rep = cl.last_report
        c_counts = launch_counts()
        expect_counts("edge shm (parent)", c_counts, bcsr_matmul=0,
                      cyclic_encode=0, decode_matmul=len(masks))
        c_child = {name: sum(r["launches"][name] for r in reps_c.values())
                   for name in SOURCES}
        expect_counts("edge shm (children)", c_child,
                      bcsr_matmul=sum(per_round), cyclic_encode=0,
                      decode_matmul=0)
        totals += [c_counts, c_child]
        wire = cl.fleet.wire_totals()
    finally:
        cl.shutdown()
    left = [f for f in os.listdir("/dev/shm") if f.startswith(prefix)]
    if left:
        raise AssertionError(f"shm: segments left after shutdown: {left}")
    emit("edge", case="shm", transport="shm", workers=len(pids),
         start_s=start_s, ready_s_max=ready, attach_s=start_s - ready,
         startup=tr.startup, bytes_shards=wire["bytes_shards"],
         children=children, child_bcsr_per_round=per_round,
         patterns=checks, rounds_s=rounds_s,
         bytes_tasks_per_round=rep.bytes_tasks,
         bytes_copied_per_round=rep.bytes_copied,
         bytes_tasks_dense_per_round=rep.bytes_tasks_dense,
         transport_bytes_copied=wire["transport_bytes_copied"],
         round_wall_s=[r.wall_s for r in cl.reports], segments_left=0,
         launches=c_counts, child_launches=c_child,
         wall_s=time.perf_counter() - t_sub)

    # -- (d) chaos with card workers -----------------------------------------
    t_sub = time.perf_counter()
    calls = 16
    reset_launch_counts()
    res = run_chaos(CHAOS_STORM, transport="memory", n=n, s=plan.s,
                    t=hidden.shape[1], r=e["ref"].shape[1], seed=seed,
                    calls=calls, spacing_s=0.1, warmup_s=10.0, device=dev)
    torch.cuda.synchronize()
    d_counts = launch_counts()
    mem = check_chaos("chaos memory", res, calls)
    resolved = calls - mem["futures"]["failed"]
    # the fault-free results, the replays and the fleet's decodes (and
    # its warm call); the workers' products run in this process
    if not res.joiner_serving:
        raise AssertionError(f"chaos memory: the joiner is not serving: "
                             f"{mem}")
    expect_between("chaos memory", d_counts,
                   bcsr_matmul=(calls + resolved + 1, None),
                   cyclic_encode=(1, None),
                   decode_matmul=(calls + 2 * resolved + 1,) * 2)
    totals.append(d_counts)
    emit("edge", case="chaos-memory", result=mem, launches=d_counts,
         shape=[hidden.shape[1], e["ref"].shape[1]],
         wall_s=time.perf_counter() - t_sub)

    t_sub = time.perf_counter()
    calls = 8
    sched = scripted_schedule(seed=3, n=4, s=1, duration=1.5, n_events=3)
    reset_launch_counts()
    res = run_chaos(sched, transport="tcp", n=4, s=1, seed=3, calls=calls,
                    spacing_s=0.15, warmup_s=CHAOS_TCP_WARMUP_S,
                    suspect_after=1.0, device=dev)
    torch.cuda.synchronize()
    d_counts = launch_counts()
    tcp = check_chaos("chaos tcp", res, calls)
    resolved = calls - tcp["futures"]["failed"]
    # the children's products run in the children; the parent makes the
    # fault-free results, the replays and the fleet's decodes
    expect_counts("chaos tcp (parent)", {
        "bcsr_matmul": d_counts["bcsr_matmul"],
        "decode_matmul": d_counts["decode_matmul"]},
        bcsr_matmul=calls + resolved, decode_matmul=calls + 2 * resolved + 1)
    totals.append(d_counts)
    emit("edge", case="chaos-tcp", result=tcp, warmup_s=CHAOS_TCP_WARMUP_S,
         first_submit_after_epoch_s=res.outcomes[0].t_submit,
         launches=d_counts, wall_s=time.perf_counter() - t_sub)
    counts = add_counts(*totals)
    emit("edge", launches=counts)
    return counts


# ---------------------------------------------------------------------------
# Phase 9: the serve front door and autoscaling on the card
# ---------------------------------------------------------------------------

# the fairness burst's tenants and weights, and its calls per tenant
FRONT_WEIGHTS = {"free": 1.0, "pro": 3.0}
FRONT_CALLS = 32
# one tenant's adaptive burst (calls of two columns each)
FRONT_BURST = 96
# the router's static widths, in calls of two columns; the worker task's
# bcsr_matmul is timed at these N.  Each width runs closed-loop windows
# of FRONT_STATIC_ROUNDS full rounds' calls (at least
# FRONT_STATIC_MIN_CALLS), with twice the width's calls in callers
FRONT_STATIC = (1, 4, 16, 32, 64)
FRONT_STATIC_ROUNDS = 32
FRONT_STATIC_MIN_CALLS = 128
FRONT_STATIC_WINDOWS = 2
# how long a scaled fleet may take to settle on its new encoding (a
# re-encode compiles the head on the card and re-ships its shards)
SETTLE_S = 120.0


def stride_order(weights: dict, log: list) -> list:
    """The tenant each dispatch of ``log`` must go to under weighted-fair
    stride with the batch widths it shows: the smallest pass among the
    tenants with calls still queued (ties by name), each dispatch adding
    its columns over the tenant's weight."""
    left = {t: sum(e["calls"] for e in log if e["tenant"] == t)
            for t in weights}
    passes = {t: 0.0 for t in weights}
    order = []
    for e in log:
        pick = min((t for t in weights if left[t] > 0),
                   key=lambda t: (passes[t], t))
        order.append(pick)
        passes[pick] += e["cols"] / weights[pick]
        left[e["tenant"]] -= e["calls"]
    return order


def routed_burst(router, endpoint: str, calls: list) -> dict:
    """Queue ``calls`` ((tenant, x) pairs) on a paused router, resume,
    wait for every result; -> the futures, the results, the burst's wall
    seconds and each call's seconds from the resume to its result (how
    far into the queue's drain it came, not a call's latency)."""
    done_at: dict = {}
    router.pause()
    futs = [router.submit(endpoint, x, tenant=tenant) for tenant, x in calls]
    for i, f in enumerate(futs):
        f.add_done_callback(
            lambda _f, i=i: done_at.setdefault(i, time.perf_counter()))
    t0 = time.perf_counter()
    router.resume()
    outs = [f.result(300) for f in futs]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return {"futs": futs, "outs": outs, "wall_s": wall,
            "drain_s": [done_at[i] - t0 for i in range(len(futs))]}


def closed_loop(router, endpoint: str, xs: list, callers: int) -> dict:
    """``callers`` threads, each submitting its next call as soon as its
    last one returned, until ``xs`` is spent; -> the futures and results
    in ``xs``' order, the window's wall seconds (first submit to the last
    result on the device) and each call's latency: seconds from its
    submit to its result (the decode enqueued on the stream)."""
    futs, outs, lat = [None] * len(xs), [None] * len(xs), [0.0] * len(xs)
    order = iter(range(len(xs)))
    lock = threading.Lock()

    def caller():
        while True:
            with lock:
                i = next(order, None)
            if i is None:
                return
            t = time.perf_counter()
            futs[i] = router.submit(endpoint, xs[i], tenant="pro")
            outs[i] = futs[i].result(300)
            lat[i] = time.perf_counter() - t

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(callers) as pool:
        for job in [pool.submit(caller) for _ in range(callers)]:
            job.result()
    torch.cuda.synchronize()
    return {"futs": futs, "outs": outs, "lat_s": lat,
            "wall_s": time.perf_counter() - t0}


def race_rounds(where: str, futs, counts: dict, plan) -> int:
    """Launches of race-mode rounds: per round each of the n live workers
    may run its task before the cancel lands (k to n ``bcsr_matmul``),
    and each call's slice one ``decode_matmul``.  -> the rounds."""
    reports = list({id(f.report): f.report for f in futs}.values())
    clean(where, reports)
    rounds = len(reports)
    expect_between(where, counts,
                   bcsr_matmul=(plan.k * rounds, plan.n * rounds),
                   cyclic_encode=(0, 0), decode_matmul=(len(futs),) * 2)
    return rounds


def replays_bitwise(where: str, plan, xs, burst: dict) -> None:
    """Each routed result bitwise the in-process plan under its round's
    observed pattern (taken after the launch window closed)."""
    bad = [i for i, (x, f, out) in enumerate(zip(xs, burst["futs"],
                                                burst["outs"]))
           if not torch.equal(out, plan.matvec(x, f.report.pattern))]
    if bad:
        raise AssertionError(f"{where}: calls {bad} are not bitwise the "
                             f"in-process plan under their pattern")


def router_card_replicas(where: str, router, endpoint: str) -> None:
    for r in router._endpoints[endpoint].replicas:
        card_fleet(f"{where} (replica {r.index})", r.fleet)


def width_rows(plan, hidden, blob: bytes, reps: int) -> list[dict]:
    """One card worker's task of the head (its re-tiled f32 form) times
    N operand columns, at each of the router's static widths: the
    kernel's width curve, each row held against its plain version."""
    dev = hidden.device
    shard = PlanShard.decode(blob)
    task = CardTask(shard, shard.tasks[0], dev)
    packed = task.packed
    dense = unpack_coded_blocks(packed)[0].T.contiguous()     # (c, t)
    gen = torch.Generator(device=dev).manual_seed(1)
    rows = []
    for calls in FRONT_STATIC:
        n_cols = 2 * calls
        b = torch.zeros((shard.t_pad, n_cols), device=dev)
        b[: shard.t] = torch.randn((shard.t, n_cols), generator=gen,
                                   device=dev)
        rows.append(check_kernel(
            "bcsr_matmul", f"front N={n_cols}",
            lambda b=b: bcsr_matmul(packed.a_data, packed.a_idx, b,
                                    mb=packed.mb, counts=packed.counts),
            lambda b=b: bcsr_matmul_plain(packed.a_data, packed.a_idx, b,
                                          mb=packed.mb, counts=packed.counts),
            lambda b=b: torch.matmul(dense, b),
            dtype=torch.float32, nbytes=bcsr_bytes(packed, [0], b,
                                                   packed.c_pad),
            flops=bcsr_flops(packed, [0], n_cols),
            flops_per_s=F32_FLOPS_PER_S, reps=reps, plain_reps=3,
            extra_ms={}))
    return rows


def front_context(seed: int, dev, e: dict) -> dict:
    """What the front sub-phases share: the edge phase's head, its masks
    with the all-alive one, the in-process engine's results for them, and
    a seeded source of decode-step operands on the card."""
    plan, hidden, engine0 = e["plan"], e["hidden"], e["engine"]
    n = plan.n
    all_alive = np.ones(n, bool)
    gen = torch.Generator(device=dev).manual_seed(seed + 9)
    d = e["d"]

    def xs_of(count):
        return [torch.randn((2, d), generator=gen, device=dev)
                for _ in range(count)]

    return {"plan": plan, "hidden": hidden, "ref": e["ref"], "e": e,
            "n": n, "k": plan.k, "d": d, "vocab": engine0.cfg.vocab,
            "seed": seed, "dev": dev, "all_alive": all_alive,
            "masks": list(e["masks"]) + [all_alive],
            "wants": list(e["wants"]) + [engine0.coded_logits(hidden,
                                                              all_alive)],
            "xs_of": xs_of, "cfg": engine0.cfg, "model": engine0.model,
            "params": engine0.params, "engine0": engine0}


def front_engine(c: dict):
    """(a) The engine's router mode: an engine registers its endpoint and
    serves the head through it, a second engine shares it."""
    plan, hidden, ref, e = c["plan"], c["hidden"], c["ref"], c["e"]
    n, k, d, masks, wants = c["n"], c["k"], c["d"], c["masks"], c["wants"]
    cfg, model, params = c["cfg"], c["model"], c["params"]
    engine0 = c["engine0"]
    totals = []
    t_sub = time.perf_counter()
    router = Router()
    try:
        reset_launch_counts()

        def routed_engine(tenant):
            return ServeEngine(
                model, params, cfg, batch_size=engine0.batch_size,
                max_len=engine0.max_len, coded=CodedConfig(
                    enabled=True, n_workers=6, stragglers=2,
                    scheme="proposed", router=router, endpoint="lm-head",
                    tenant=tenant, cluster_workers=6, transport="memory"))

        t0 = time.perf_counter()
        engine = routed_engine("pro")
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        expect_counts("router engine build", launch_counts(), bcsr_matmul=0,
                      cyclic_encode=1, decode_matmul=0)
        if not (engine._owns_endpoint and router.has_endpoint("lm-head")):
            raise AssertionError("router engine: endpoint not registered")
        router_card_replicas("router engine", router, "lm-head")
        checks = []
        for done, want in zip(masks, wants):
            before = launch_counts()
            got = engine.coded_logits(hidden, done)
            torch.cuda.synchronize()
            # one task per row the mask admits: k, or n for all alive
            expect_counts("one routed coded_logits", launched_since(before),
                          bcsr_matmul=int(done.sum()), cyclic_encode=0,
                          decode_matmul=1)
            row = hold_parity("router engine", got, want, e["dtype"], plan,
                              done, ref, d, e["stored"])
            if not row["bitwise_in_process"]:
                raise AssertionError(f"router engine: not bitwise the "
                                     f"in-process engine: {row}")
            checks.append(row)
        a_counts = launch_counts()
        # a second engine on the now registered endpoint shares it
        shared = routed_engine("free")
        got = shared.coded_logits(hidden, masks[0])
        torch.cuda.synchronize()
        if shared._owns_endpoint or not torch.equal(got, wants[0]):
            raise AssertionError("router engine: the second engine does not "
                                 "share the endpoint bitwise")
        tenants = {t: v["counters"] for t, v in router.metrics()[
            "endpoints"]["lm-head"]["tenants"].items()}
        shared.close()
        kept = router.has_endpoint("lm-head")
        engine.close()
        if not kept or router.has_endpoint("lm-head"):
            raise AssertionError(f"router engine: endpoint kept after the "
                                 f"shared close {kept}, after the owner's "
                                 f"{router.has_endpoint('lm-head')}")
        shared_counts = launch_counts()
    finally:
        router.close()
    expect_counts("router engines", shared_counts,
                  bcsr_matmul=sum(int(m.sum()) for m in masks[:1] + masks),
                  cyclic_encode=2, decode_matmul=len(masks) + 1)
    totals.append(shared_counts)
    emit("front", case="router-engine", endpoint="lm-head", tenant="pro",
         transport="memory", workers=6, build_s=build_s, patterns=checks,
         launches_owner=a_counts, launches=shared_counts, tenants=tenants,
         wall_s=time.perf_counter() - t_sub)
    return totals


def front_replicas(c: dict):
    """(b) Two tenants' paused burst over two replicas, then (e) an
    ``Autoscaler`` scaling the replicas up and back to one."""
    plan, xs_of = c["plan"], c["xs_of"]
    totals = []
    t_sub = time.perf_counter()
    router = Router()
    try:
        t0 = time.perf_counter()
        router.register("head", plan, replicas=2, n_workers=6,
                        transport="memory")
        register_s = time.perf_counter() - t0
        router_card_replicas("router fair", router, "head")
        for name, w in FRONT_WEIGHTS.items():
            router.set_tenant(name, weight=w)
        xs = xs_of(2 * FRONT_CALLS)
        calls = [(t, xs[j * 2 + i]) for j in range(FRONT_CALLS)
                 for i, t in enumerate(FRONT_WEIGHTS)]
        reset_launch_counts()
        burst = routed_burst(router, "head", calls)
        b_counts = launch_counts()
        rounds = race_rounds("router fair", burst["futs"], b_counts, plan)
        log = router.dispatch_log("head")
        order = stride_order(FRONT_WEIGHTS, log)
        if [e_["tenant"] for e_ in log] != order:
            raise AssertionError(f"router fair: dispatch order "
                                 f"{[e_['tenant'] for e_ in log]}, stride "
                                 f"{order}")
        share, left = {t: 0 for t in FRONT_WEIGHTS}, dict.fromkeys(
            FRONT_WEIGHTS, FRONT_CALLS)
        for e_ in log:
            if min(left.values()) <= 0:
                break
            share[e_["tenant"]] += e_["cols"]
            left[e_["tenant"]] -= e_["calls"]
        used = sorted({e_["replica"] for e_ in log})
        if used != [0, 1]:
            raise AssertionError(f"router fair: replicas used {used}")
        replays_bitwise("router fair", plan, [x for _, x in calls], burst)
        totals.append(b_counts)
        emit("front", case="router-fair", weights=FRONT_WEIGHTS,
             calls_per_tenant=FRONT_CALLS, cols_per_call=2,
             register_s=register_s, replicas_used=used,
             dispatch=[[e_["tenant"], e_["calls"], e_["cols"], e_["width"],
                        e_["replica"]] for e_ in log],
             contended_cols=share, rounds=rounds, burst_wall_s=burst["wall_s"],
             drain_p50_s=float(np.median(burst["drain_s"])),
             launches=b_counts,
             wall_s=time.perf_counter() - t_sub)

        # -- (e) the router's replicas scaled by an Autoscaler -------------
        t_sub = time.perf_counter()
        scaler = Autoscaler(router, endpoint="head", n_workers=6,
                            transport="memory",
                            policy=QueueDepthPolicy(high=8, low=1),
                            min_members=1, max_members=4, cooldown_s=0.0)
        xs = xs_of(FRONT_CALLS)
        router.pause()
        futs = [router.submit("head", x, tenant="pro") for x in xs]
        reset_launch_counts()
        t0 = time.perf_counter()
        up = scaler.step(now=0.0)
        up_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        expect_counts("scale replicas up", launch_counts(), bcsr_matmul=0,
                      cyclic_encode=0, decode_matmul=0)
        if (up.action, up.applied, scaler.pool.size()) != ("up", 2, 4):
            raise AssertionError(f"scale replicas: {up}")
        router_card_replicas("scale replicas", router, "head")
        # batches of 4 calls, so the backlog spreads over the replicas
        router.configure("head", adaptive=False, width=8)
        router.resume()
        outs = [f.result(300) for f in futs]
        torch.cuda.synchronize()
        e_counts = launch_counts()
        e_rounds = race_rounds("scale replicas", futs, e_counts, plan)
        served = sorted({e_["replica"] for e_ in router.dispatch_log("head")
                         [len(log):]})
        if served != [0, 1, 2, 3]:
            raise AssertionError(f"scale replicas: served by {served}")
        replays_bitwise("scale replicas", plan, xs,
                        {"futs": futs, "outs": outs})
        downs = [scaler.step(now=1.0 + i) for i in range(3)]
        if [x.applied for x in downs] != [-1, -1, -1] or \
                scaler.pool.size() != 1:
            raise AssertionError(f"scale replicas down: {downs}")
        hold = scaler.step(now=10.0)
        try:
            scaler.pool.decommission(scaler.pool.members()[0])
            refused = None
        except ProvisionError as err:
            refused = str(err)
        if refused is None or "last live replica" not in refused:
            raise AssertionError(f"scale replicas: the last replica was "
                                 f"not protected: {refused}")
        scaler.close()
        totals.append(e_counts)
        emit("front", case="scale-replicas", backlog_calls=len(xs),
             up_s=up_s, decisions=scaler.decision_log(), hold=hold.reason,
             replicas_served=served, rounds=e_rounds, refused=refused,
             launches=e_counts, wall_s=time.perf_counter() - t_sub)
    finally:
        router.close()
    return totals


def front_width(c: dict):
    """(c) One tenant's adaptive burst, idle calls, the static widths, and
    the worker task's ``bcsr_matmul`` at each static width."""
    plan, hidden, xs_of = c["plan"], c["hidden"], c["xs_of"]
    n, k = c["n"], c["k"]
    totals = []
    t_sub = time.perf_counter()
    router = Router()
    try:
        router.register("head", plan, replicas=1, n_workers=6,
                        transport="memory")
        router_card_replicas("router width", router, "head")
        h0 = router._endpoints["head"].replicas[0].handle
        xs = xs_of(FRONT_BURST)
        reset_launch_counts()
        burst = routed_burst(router, "head", [("pro", x) for x in xs])
        c_counts = launch_counts()
        rounds = race_rounds("router width", burst["futs"], c_counts, plan)
        log = router.dispatch_log("head")
        widest = max(e_["cols"] for e_ in log)
        if widest < 64:
            raise AssertionError(f"router width: widest batch {widest} "
                                 f"columns: {log}")
        round_cols = sorted({id(f.report): 2 * f.report.calls
                             for f in burst["futs"]}.values())
        replays_bitwise("router width", plan, xs, burst)
        totals.append(c_counts)
        idle = []
        reset_launch_counts()
        for _ in range(16):
            router.call("head", xs[0], tenant="pro")
            idle.append(router.metrics()["endpoints"]["head"]["width"])
            if idle[-1] == 1:
                break
        torch.cuda.synchronize()
        idle_counts = launch_counts()
        expect_between("router width idle", idle_counts,
                       bcsr_matmul=(k * len(idle), n * len(idle)),
                       cyclic_encode=(0, 0),
                       decode_matmul=(len(idle),) * 2)
        if idle[-1] != 1:
            raise AssertionError(f"router width: idle widths {idle}")
        totals.append(idle_counts)
        emit("front", case="router-width", mode="adaptive",
             calls=FRONT_BURST, cols=2 * FRONT_BURST,
             dispatch=[[e_["calls"], e_["cols"], e_["width"]] for e_ in log],
             widest_cols=widest, round_cols=round_cols, rounds=rounds,
             burst_wall_s=burst["wall_s"], idle_widths=idle,
             launches=c_counts, idle_launches=idle_counts,
             wall_s=time.perf_counter() - t_sub)
        static = []
        for calls in FRONT_STATIC:
            t_sub = time.perf_counter()
            router.configure("head", adaptive=False, width=2 * calls)
            n_calls = max(FRONT_STATIC_MIN_CALLS, FRONT_STATIC_ROUNDS * calls)
            rates, p50s, p99s, batches, rounds = [], [], [], [], []
            for _ in range(FRONT_STATIC_WINDOWS):
                xs = xs_of(n_calls)
                n_log = len(router.dispatch_log("head"))
                reset_launch_counts()
                run = closed_loop(router, "head", xs, 2 * calls)
                s_counts = launch_counts()
                rounds.append(race_rounds(f"router width {calls}",
                                          run["futs"], s_counts, plan))
                batches += [e_["calls"] for e_ in
                            router.dispatch_log("head")[n_log:]]
                replays_bitwise(f"router width {calls}", plan, xs, run)
                totals.append(s_counts)
                rates.append(n_calls / run["wall_s"])
                p50s.append(float(np.median(run["lat_s"])) * 1e3)
                p99s.append(float(np.percentile(run["lat_s"], 99)) * 1e3)
                del xs, run
            row = {"width_calls": calls, "width_cols": 2 * calls,
                   "callers": 2 * calls, "calls": n_calls,
                   "windows": FRONT_STATIC_WINDOWS, "rounds": rounds,
                   "batches": len(batches),
                   "mean_batch_calls": float(np.mean(batches)),
                   "max_batch_calls": max(batches),
                   "calls_per_s": float(np.median(rates)),
                   "calls_per_s_each": rates,
                   "lat_p50_ms": float(np.median(p50s)),
                   "lat_p50_ms_each": p50s, "lat_p99_ms_each": p99s,
                   "launches_last": s_counts}
            static.append(row)
            emit("front", case="router-width", mode="static", **row,
                 wall_s=time.perf_counter() - t_sub)
        blob = h0.shard_blobs[0]
    finally:
        router.close()
    curve = width_rows(plan, hidden, blob, reps=50)
    return totals, static, curve


def front_grow(c: dict):
    """(d) ``CodedFleet(grow_encodings=True)`` scaled from n to n + 2 and
    back.  -> (launches, the kernel rows at each re-encoded plan's
    shapes)."""
    plan, hidden, ref, e = c["plan"], c["hidden"], c["ref"], c["e"]
    n, k, d, vocab = c["n"], c["k"], c["d"], c["vocab"]
    seed, dev, wants = c["seed"], c["dev"], c["wants"]
    all_alive = c["all_alive"]
    totals = []
    t_sub = time.perf_counter()
    with CodedFleet(n, device=dev, backend=plan.backend,
                    grow_encodings=True) as fleet:
        card_fleet("scale grow", fleet)
        h = fleet.attach(plan)
        ps = h._ps
        first = h.matvec(hidden, all_alive)
        if not torch.equal(first, wants[-1]):
            raise AssertionError("scale grow: not bitwise before growth")
        scaler = Autoscaler(fleet, policy=SchedulePolicy(
            [(0, n), (1, n + 2), (3, n)]), min_members=2,
                            max_members=n + 4, cooldown_s=0.0)
        scaler.step(now=0.0)
        reset_launch_counts()
        t0 = time.perf_counter()
        up = scaler.step(now=2.0)
        wait_settled(h, n + 2, SETTLE_S)
        torch.cuda.synchronize()
        grow_s = time.perf_counter() - t0
        grow_counts = launch_counts()
        grown = h.plan
        if (up.action, up.applied) != ("up", 2) or not (
                grown.n > n and grown.k > k and grown.s >= plan.s):
            raise AssertionError(f"scale grow: {up}, grown (n, k, s) = "
                                 f"{(grown.n, grown.k, grown.s)}")
        # two joins: one re-encode and one compile each
        expect_counts("scale grow up", grow_counts, bcsr_matmul=0,
                      cyclic_encode=2, decode_matmul=0)
        compiles = len(ps._plan_cache)
        grid, grid_counts = [], []
        rng = np.random.default_rng(seed + 9)
        for _ in range(3):
            done = np.ones(grown.n, bool)
            done[rng.choice(grown.n, size=grown.s, replace=False)] = False
            before = launch_counts()
            got = h.matvec(hidden, done)
            torch.cuda.synchronize()
            grid_counts.append(launched_since(before))
            expect_counts("one grown matvec", grid_counts[-1],
                          bcsr_matmul=grown.k, cyclic_encode=0,
                          decode_matmul=1)
            want = grown.matvec(hidden, done)
            row = check_decoded("scale grow", e["dtype"], grown, done, got,
                                ref, d, lambda rows: mv_stored_decode(
                                    grown, rows, hidden, vocab))
            row["bitwise_in_process"] = bool(torch.equal(got, want))
            if not row["bitwise_in_process"]:
                raise AssertionError(f"scale grow: not bitwise the grown "
                                     f"plan in process: {row}")
            grid.append(row)
        totals += [grow_counts, *grid_counts]
        reset_launch_counts()
        scaler.step(now=3.0)
        wait_settled(h, n + 1, SETTLE_S)
        torch.cuda.synchronize()
        down_counts = launch_counts()
        # one re-encode: the 7-worker compile of the way up, or a new
        # one where the measured rates cut the roster unevenly
        expect_between("scale grow down to 7", down_counts,
                       bcsr_matmul=(0, 0), cyclic_encode=(0, 1),
                       decode_matmul=(0, 0))
        totals.append(down_counts)
        reset_launch_counts()
        last = scaler.step(now=3.5)
        wait_settled(h, n, SETTLE_S)
        back = h.matvec(hidden, all_alive)
        torch.cuda.synchronize()
        back_counts = launch_counts()
        expect_counts("scale grow back to 6", back_counts, bcsr_matmul=n,
                      cyclic_encode=0, decode_matmul=1)
        if last.applied != -1 or h.plan is not plan or \
                not torch.equal(back, first):
            raise AssertionError("scale grow: the return to 6 is not the "
                                 "first compile, bitwise")
        totals.append(back_counts)
        scaler.close()
        decisions = scaler.decision_log()
        encoded = list(ps._plan_cache.values())
    rows = []
    for p in encoded:                   # every plan a re-encode compiled
        rows += reencode_rows(p, hidden,
                              straggler_masks(rng, p.n, p.s, 1)[0],
                              f"grow n={p.n} k={p.k}", reps=20)
    emit("front", case="scale-grow", grown={"n": grown.n, "k": grown.k,
                                            "s": grown.s,
                                            "scheme": grown.scheme.name},
         compiles_up=compiles, compiles=len(ps._plan_cache), grow_s=grow_s,
         patterns=grid, decisions=decisions, launches_up=grow_counts,
         launches_down=down_counts, launches_back=back_counts,
         wall_s=time.perf_counter() - t_sub)
    return totals, rows


def front_remote(c: dict):
    """(f) A ``RemotePool`` of ``--connect`` card processes dialing a tcp
    coordinator."""
    plan, hidden, ref, e = c["plan"], c["hidden"], c["ref"], c["e"]
    n, d, dev, masks, wants = c["n"], c["d"], c["dev"], c["masks"], c["wants"]
    totals = []
    t_sub = time.perf_counter()
    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    port = probe.getsockname()[1]
    probe.close()
    root = Path(__file__).resolve().parent
    env = {**os.environ, "PYTHONPATH": str(root / "src")}
    procs: dict = {}

    def launch(worker_id, port_):
        # on the card: the worker's default device
        procs[worker_id] = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.cluster.worker",
             "--connect", f"127.0.0.1:{port_}", "--id", str(worker_id)],
            env=env, stdout=subprocess.PIPE, text=True)

    for w in range(n):
        launch(w, port)
    served: list = []
    reports: dict = {}
    reset_launch_counts()
    try:
        t0 = time.perf_counter()
        fleet = CodedFleet(n, transport="tcp", device=dev,
                           transport_opts={"spawn": False, "port": port})
        try:
            dial_s = time.perf_counter() - t0
            card_fleet("remote pool", fleet)
            h = fleet.attach(plan)
            attach_s = time.perf_counter() - t0 - dial_s
            f_checks = []

            def remote_round(done, want):
                got = h.matvec(hidden, done)
                torch.cuda.synchronize()
                served.append(sum(h.last_report.completed_per_worker
                                  .values()))
                row = hold_parity("remote pool", got, want, e["dtype"], plan,
                                  done, ref, d, e["stored"])
                if not row["bitwise_in_process"]:
                    raise AssertionError(f"remote pool: not bitwise: {row}")
                f_checks.append(row)

            for done, want in zip(masks, wants):
                remote_round(done, want)
            pool = RemotePool(fleet, launch)
            t0 = time.perf_counter()
            joiner = pool.provision()
            provision_s = time.perf_counter() - t0
            if joiner != n or pool.size() != n + 1:
                raise AssertionError(f"remote pool: joined {joiner}, size "
                                     f"{pool.size()}")
            for done, want in zip(masks, wants):
                remote_round(done, want)
            pool.decommission(joiner)
            if pool.size() != n:
                raise AssertionError(f"remote pool: size {pool.size()} after "
                                     f"the decommission")
            remote_round(masks[-1], wants[-1])
            clean("remote pool", h.reports)
        finally:
            fleet.close()
        for w, p in procs.items():
            out, _ = p.communicate(timeout=60)
            reports[w] = json.loads(out.strip().splitlines()[-1])
            reports[w]["returncode"] = p.returncode
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    torch.cuda.synchronize()
    f_counts = launch_counts()
    card = torch.cuda.get_device_name(0)
    bad = [w for w, r in reports.items()
           if r["returncode"] != 0 or r["backend"] != fleet.backend
           or r["device_name"] != card]
    if sorted(reports) != list(range(n + 1)) or bad:
        raise AssertionError(f"remote pool workers {bad}: {reports}")
    f_child = {name: sum(r["launches"][name] for r in reports.values())
               for name in SOURCES}
    expect_counts("remote pool (parent)", f_counts, bcsr_matmul=0,
                  cyclic_encode=0, decode_matmul=len(served))
    expect_counts("remote pool (workers)", f_child, bcsr_matmul=sum(served),
                  cyclic_encode=0, decode_matmul=0)
    totals += [f_counts, f_child]
    emit("front", case="scale-remote", transport="tcp", port_dialed=port,
         dial_s=dial_s, attach_s=attach_s, provision_s=provision_s,
         joiner=joiner, patterns=f_checks, served_per_round=served,
         workers={w: {k_: r[k_] for k_ in ("pid", "device_name", "launches")}
                  for w, r in reports.items()},
         launches=f_counts, worker_launches=f_child,
         wall_s=time.perf_counter() - t_sub)
    return totals


def chaos_rows(res, t: int, r: int, dev, reps: int) -> list[dict]:
    """The three kernels at each shape a chaos run's fleet re-encoded to
    (its event log: n, k and the capacities of an uneven cut), each plan
    compiled on ``run_chaos``'s operand, rebuilt from the run's seed."""
    shapes = sorted({(ev["n"], ev["k"], tuple(ev["capacities"] or ()))
                     for ev in res.events if ev["kind"] == "reencode"})
    rng = np.random.default_rng(res.seed)
    mask = rng.random((t // 8, r // 8)) >= 0.9
    A = torch.from_numpy((rng.standard_normal((t, r)) * np.kron(
        mask, np.ones((8, 8)))).astype(np.float32)).to(dev)
    x = torch.from_numpy(rng.standard_normal((1, t)).astype(np.float32)
                         ).to(dev)
    rows = []
    for n_, k_, caps in shapes:
        scheme = (dict(scheme="proposed-hetero", capacities=list(caps))
                  if caps else dict(scheme="proposed", n=n_))
        p = compile_plan(A, **scheme, k_A=k_, backend="cuda", device=dev)
        case = f"chaos n={n_} k={k_}" + (f" caps={list(caps)}" if caps
                                         else "")
        rows += reencode_rows(p, x, straggler_masks(rng, p.n, p.s, 1)[0],
                              case, reps)
        del p
    return rows


def front_chaos(c: dict):
    """(g) ``run_chaos`` with the autoscaler on.  -> (launches, the kernel
    rows at each shape its fleet re-encoded to)."""
    plan, hidden, ref = c["plan"], c["hidden"], c["ref"]
    n, seed, dev = c["n"], c["seed"], c["dev"]
    totals = []
    t_sub = time.perf_counter()
    calls = 16
    sched = scripted_schedule(seed=7, n=n, s=plan.s, duration=2.0,
                              n_events=5)
    reset_launch_counts()
    res = run_chaos(sched, transport="memory", n=n, s=plan.s,
                    t=hidden.shape[1], r=ref.shape[1], seed=7, calls=calls,
                    spacing_s=0.1, warmup_s=10.0, device=dev,
                    autoscale={"policy": SchedulePolicy([(0, 6), (0.5, 8),
                                                         (1.5, 6)]),
                               "min_members": 2, "max_members": 10,
                               "interval_s": 0.1, "cooldown_s": 0.2})
    torch.cuda.synchronize()
    g_counts = launch_counts()
    chaos = check_chaos("chaos autoscale", res, calls)
    resolved = calls - chaos["futures"]["failed"]
    actions = [x["action"] for x in res.autoscale]
    if "up" not in actions or "down" not in actions:
        raise AssertionError(f"chaos autoscale: decisions {res.autoscale}")
    expect_between("chaos autoscale", g_counts,
                   bcsr_matmul=(calls + resolved + 1, None),
                   cyclic_encode=(1, None),
                   decode_matmul=(calls + 2 * resolved + 1,) * 2)
    totals.append(g_counts)
    emit("front", case="chaos-autoscale", result=chaos,
         decisions=[x for x in res.autoscale if x["action"] != "hold"],
         ups=actions.count("up"), downs=actions.count("down"),
         launches=g_counts, shape=[hidden.shape[1], ref.shape[1]],
         wall_s=time.perf_counter() - t_sub)
    return totals, chaos_rows(res, hidden.shape[1], ref.shape[1], dev,
                              reps=20)


def phase_front(seed: int, dev, e: dict) -> tuple[dict, list]:
    """The serve front door and autoscaling on the serve phase's head
    (n=6, s=2), every fleet of card workers: (a) the engine's router mode;
    (b) two tenants' paused burst over two replicas; (e) the router's
    replicas scaled up and down by an ``Autoscaler``; (c) the adaptive
    width across the kernel's narrow-to-wide switch, and the static
    widths; (d) ``CodedFleet(grow_encodings=True)`` scaled up and back;
    (f) ``RemotePool`` dialing ``--connect`` card workers into a tcp
    coordinator; (g) ``run_chaos`` with the autoscaler on.  -> (the
    path's launches, the remote workers' included; the kernel rows at the
    width curve's, the grown plans' and the chaos re-encodes' shapes)."""
    c = front_context(seed, dev, e)
    torch.cuda.synchronize()
    totals = front_engine(c) + front_replicas(c)
    width_counts, static, rows = front_width(c)
    grow_counts, grow_rows = front_grow(c)
    totals += width_counts + grow_counts + front_remote(c)
    chaos_counts, chaos_krows = front_chaos(c)
    totals += chaos_counts
    counts = add_counts(*totals)
    emit("front", launches=counts, static_widths=static)
    return counts, rows + grow_rows + chaos_krows


# ---------------------------------------------------------------------------
# Phase 10: the coded consumers and the remaining model families
# ---------------------------------------------------------------------------

MOE_ARCH = "granite-moe-1b-a400m"
# served through the launcher, each with its coded head
FAMILY_ARCHS = ("mamba2-1.3b", "zamba2-2.7b", "phi-3-vision-4.2b")
AUDIO_ARCH = "whisper-tiny"
FAMILY_STEPS = 16
MOE_REPS = 5


def bf16_drift_limit(n_layers: int) -> float:
    """The bf16 cache check's limit for a deep family: each layer stores
    its output in bf16 (relative error 2^-9) and a random-weight stack
    carries every one of them to the logits, so the prefill and a fresh
    forward, which order their sums differently, drift apart with depth
    (``scripts/bf16_probe.py``: mamba2-1.3b 0.96% at 6 layers, 4.4% at
    48; f32 on the same weights within 1e-5).  2e-2 at least, as the
    serve phase; the f32 check (2e-4) is the correctness gate."""
    return max(2e-2, n_layers * 2.0 ** -9)


def mixed_masks(rng, n: int, s: int, count: int) -> list[np.ndarray]:
    """``count`` random masks of 1 to s stragglers."""
    return [straggler_masks(rng, n, int(rng.integers(1, s + 1)), 1)[0]
            for _ in range(count)]


def moe_layer_inputs(model, toks: np.ndarray) -> tuple:
    """Layer 0's MoE input (the normed residual) for a prefill of
    ``toks`` and one decode step after it, in f32."""
    seen = []
    real = moe_module.moe_block

    def grab(p, x, moe):
        seen.append(x.float())
        return real(p, x, moe)

    moe_module.moe_block = grab
    try:
        with torch.inference_mode():
            last, cache = model.prefill(toks, max_len=64)
            model.decode_step(cache, last.argmax(dim=-1)[:, None])
    finally:
        moe_module.moe_block = real
    n = model.cfg.n_layers
    return seen[0].clone(), seen[n].clone()


def moe_kappa(cm, done) -> float:
    """The largest cond(G[rows]) over a ``CodedMoE``'s plans (one seed
    per expert) under ``done``."""
    rows = np.flatnonzero(np.asarray(done))[: cm.n - cm.s]
    return max(float(np.linalg.cond(pl.G[rows]))
               for pl in cm.gate + cm.up + cm.down)


def hold_moe(where: str, got, aux, want, aux_want, done, kappa: float,
             t: int) -> dict:
    """``CodedMoE`` against ``moe_block``: aux within 1e-6, the output
    within max(REL, kappa eps) of max|want| (``decode_bound``; kappa the
    worst of the layer's plans).  The reference test's rtol=atol=1e-4
    (``tests/test_api_plan.py``, at d=16) is reported beside it: the
    decode amplifies the f32 sums' rounding by up to kappa, and one seed
    per expert makes some pattern ill-conditioned for some expert."""
    diff = (got - want).abs()
    excess = float((diff - (1e-4 + 1e-4 * want.abs())).max())
    row = {"stragglers": np.flatnonzero(~np.asarray(done)).tolist(),
           "kappa_max": kappa, "max_abs_err": float(diff.max()),
           "rel_err": rel_err(got, want.double()),
           "bound": decode_bound(torch.float32, kappa, t),
           "within_1e-4": excess <= 0.0,
           "aux_err": abs(float(aux) - float(aux_want))}
    if not row["rel_err"] <= row["bound"] or not row["aux_err"] <= 1e-6:
        raise AssertionError(f"{where}: {row}")
    return row


def models_coded_moe(seed: int, dev, serve: dict) -> tuple:
    """``CodedMoE`` on granite's first MoE layer at full width in f32 (32
    experts, d 1024, h 512, top-8, capacity 1.25), on that layer's input
    from the served model at a decode step of 8 and a prefill of 8 x 9
    tokens: in process, then through a ``CodedFleet`` of 6 ``memory``
    card workers that also holds the engine's coded head.  -> (launches,
    kernel rows, the fleet, the masks)."""
    t_sub = time.perf_counter()
    model, cfg = serve["model"], serve["cfg"]
    moe = cfg.moe
    p = {name: w.detach().float() for name, w in model.layers[0].moe.items()}
    rng = np.random.default_rng(seed + 10)
    toks = np.asarray([[1] + rng.integers(2, cfg.vocab, 8).tolist()
                       for _ in range(8)], np.int32)
    x_pre, x_dec = moe_layer_inputs(model, toks)
    xs = {"decode": x_dec, "prefill": x_pre}

    reset_launch_counts()
    t0 = time.perf_counter()
    cm = CodedMoE(p, moe, n_workers=6, stragglers=2, seed=seed)
    torch.cuda.synchronize()
    compile_s = time.perf_counter() - t0
    expect_counts("coded-moe build", launch_counts(), bcsr_matmul=0,
                  cyclic_encode=3 * moe.n_experts, decode_matmul=0)
    if set(cm.backends()) != {"cuda"}:
        raise AssertionError(f"coded-moe backends {set(cm.backends())}")
    e3 = 3 * moe.n_experts
    masks = [np.ones(6, bool)] + mixed_masks(rng, 6, 2, 3)
    checks, routes, local = {}, {}, {}
    for key, x in xs.items():
        with RouteLog() as log:
            want, aux_want = moe_block(p, x, moe)
        routes[key] = {"tokens": x.shape[0] * x.shape[1],
                       "capacity": moe_module._capacity(
                           x.shape[0] * x.shape[1], moe),
                       "dropped_share": log.dropped_share()}
        checks[key] = []
        for done in masks:
            before = launch_counts()
            got, aux = cm(x, done)
            torch.cuda.synchronize()
            expect_counts(f"coded-moe {key} call", launched_since(before),
                          bcsr_matmul=e3, cyclic_encode=0, decode_matmul=e3)
            checks[key].append(hold_moe(
                f"coded-moe {key}", got, aux, want, aux_want, done,
                moe_kappa(cm, done), cfg.d_model))
            local[key, len(checks[key]) - 1] = (got, aux)
    p50 = {key: host_p50_ms(lambda x=x: cm(x, masks[1]), MOE_REPS)
           for key, x in xs.items()}
    counts = launch_counts()

    # the same layer through a fleet shared with the engine's coded head
    fleet = CodedFleet(6, transport="memory", max_inflight=8, device=dev,
                       backend="cuda")
    card_fleet("coded-moe fleet", fleet)
    head = fleet.attach(serve["engine"].coded)
    hidden, hdone = serve["hidden"], serve["done"]
    if not torch.equal(head.matvec(hidden, hdone),
                       serve["engine"].coded.matvec(hidden, hdone)):
        raise AssertionError("coded-moe fleet: the head is not bitwise")
    reset_launch_counts()
    t0 = time.perf_counter()
    fm = CodedMoE(p, moe, n_workers=6, stragglers=2, seed=seed, fleet=fleet)
    torch.cuda.synchronize()
    attach_s = time.perf_counter() - t0
    expect_counts("coded-moe fleet build", launch_counts(), bcsr_matmul=0,
                  cyclic_encode=e3, decode_matmul=0)
    bitwise = 0
    for key, x in xs.items():
        for j, done in enumerate(masks):
            before = launch_counts()
            got, aux = fm(x, done)
            torch.cuda.synchronize()
            expect_counts(f"coded-moe fleet {key} call",
                          launched_since(before),
                          bcsr_matmul=e3 * int(np.sum(done)),
                          cyclic_encode=0, decode_matmul=e3)
            want, aux_want = local[key, j]
            if not torch.equal(got, want) or float(aux) != float(aux_want):
                raise AssertionError(
                    f"coded-moe fleet {key}: not bitwise in process under "
                    f"{np.flatnonzero(~done).tolist()}: "
                    f"{float((got - want).abs().max())}")
            bitwise += 1
    fleet_p50 = {key: host_p50_ms(lambda x=x: fm(x, masks[1]), MOE_REPS)
                 for key, x in xs.items()}
    fleet_counts = launch_counts()
    emit("models", sub="coded-moe", arch=cfg.name, layer=0,
         experts=moe.n_experts, top_k=moe.top_k, d_model=cfg.d_model,
         d_expert=moe.d_expert, capacity_factor=moe.capacity_factor,
         dtype="float32", n=6, s=2, plans=e3, compile_s=compile_s,
         routes=routes, in_process=checks,
         call_p50_ms=p50, fleet_call_p50_ms=fleet_p50,
         fleet_attach_s=attach_s, fleet_bitwise=bitwise,
         launches=counts, fleet_launches=fleet_counts,
         wall_s=time.perf_counter() - t_sub)

    # the three kernels at the expert shapes, N = 4 and 24
    rows = [encode_row(cm.gate[0], "expert gate"),
            encode_row(cm.down[0], "expert down")]
    for key, x in xs.items():
        cap = moe_module._capacity(x.shape[0] * x.shape[1], moe)
        t = x.shape[0] * x.shape[1]
        _, _, tok_id, _, dest = moe_module._route_tokens(
            p["router"], x.reshape(t, -1), moe, cap)
        xe = moe_module._dispatch(x.reshape(t, -1), tok_id, dest,
                                  moe.n_experts, cap)
        act = (torch.nn.functional.silu(cm.gate[0].matvec(xe[0], masks[1]))
               * cm.up[0].matvec(xe[0], masks[1]))
        rows += kernels_product(cm.gate[0], xe[0], masks[1],
                                f"expert gate N={cap}", 50)
        rows += kernels_product(cm.down[0], act, masks[1],
                                f"expert down N={cap}", 50)
    totals = add_counts(counts, fleet_counts)
    return totals, rows, fleet, masks


def models_coded_grads(seed: int, dev, gen, model, fleet, masks) -> dict:
    """``CodedAggregator.build(6, 2)`` on the card over payloads the size
    of one granite layer's parameters: every C(6,2) pattern against the
    direct f64 sum (one solve each, then cache hits), then through
    ``to_cluster()`` on ``memory`` card workers and through the coded-moe
    fleet, each within 2e-5 of the in-process aggregate
    (``tests/test_cluster.py``, ``tests/test_fleet.py``)."""
    t_sub = time.perf_counter()
    reset_launch_counts()
    agg = CodedAggregator.build(6, 2, seed=seed, device=dev)
    k = agg.scheme.k_A
    shapes = {name: tuple(w.shape)
              for name, w in model.layers[0].named_parameters()}
    grads = [{name: torch.randn(shape, generator=gen, device=dev)
              for name, shape in shapes.items()} for _ in range(k)]
    payloads = [agg.worker_payload(i, grads) for i in range(6)]
    truth = {name: sum(g[name].double() for g in grads) for name in shapes}
    numel = sum(int(np.prod(sh)) for sh in shapes.values())
    patterns = list(itertools.combinations(range(6), 2))
    rows, worst = [], 0.0
    for rep in range(2):
        for pat in patterns:
            done = np.ones(6, bool)
            done[list(pat)] = False
            out = agg.aggregate(payloads, done)
            if rep:
                continue
            rows_k = np.flatnonzero(done)[:k]
            kappa = float(np.linalg.cond(agg.plan().G[rows_k]))
            err = max(rel_err(out[name], truth[name]) for name in shapes)
            limit = decode_bound(torch.float32, kappa, k)
            if not err <= limit:
                raise AssertionError(f"coded-grads {pat}: {err} > {limit}")
            worst = max(worst, err)
            rows.append([list(pat), kappa, err])
    cache = agg.plan()._decode_cache()
    solves, hits = cache.misses, cache.hits
    if (solves, hits) != (len(patterns), len(patterns)):
        raise AssertionError(f"coded-grads: {solves} solves, {hits} hits "
                             f"for 2 x {len(patterns)} aggregates")
    torch.cuda.synchronize()

    def hold(where, got, want) -> float:
        """Each leaf within rtol=atol=2e-5 of the in-process one -> the
        largest difference."""
        worst = 0.0
        for n in shapes:
            diff = (got[n].to(want[n].device) - want[n]).abs()
            if not bool((diff <= 2e-5 + 2e-5 * want[n].abs()).all()):
                raise AssertionError(f"coded-grads {where} {n}: "
                                     f"{float(diff.max())}")
            worst = max(worst, float(diff.max()))
        return worst

    done = masks[1]
    want = agg.aggregate(payloads, done)
    t0 = time.perf_counter()
    with agg.to_cluster(transport="memory") as cl:
        card_workers("coded-grads cluster", cl)
        got = agg.aggregate(payloads, done, cluster=cl)
        clean("coded-grads cluster", [cl.last_report])
    cluster_s = time.perf_counter() - t0
    cluster_err = hold("cluster", got, want)
    handle = agg.to_cluster(fleet=fleet)
    t0 = time.perf_counter()
    got = agg.aggregate(payloads, done, cluster=handle)
    fleet_s = time.perf_counter() - t0
    fleet_err = hold("fleet", got, want)
    handle.detach()
    counts = launch_counts()
    emit("models", sub="coded-grads", n=6, s=2, k=k,
         payload_params=numel, payload_mb=numel * 4 / 1e6,
         patterns=len(patterns), solves=solves, hits=hits,
         worst_rel_err_vs_f64=worst, per_pattern=rows,
         cluster_s=cluster_s, fleet_s=fleet_s,
         cluster_max_abs_diff=cluster_err, fleet_max_abs_diff=fleet_err,
         cluster_stragglers=np.flatnonzero(~done).tolist(),
         launches=counts, wall_s=time.perf_counter() - t_sub)
    return counts


def models_families(seed: int, dev, gen, smoke: bool = False
                    ) -> tuple[list, list]:
    """The other families at full depth and width in bf16: mamba2, zamba2
    and phi-3-vision through the launcher with their coded heads (and the
    vision model's 256 image embeddings through ``prefill`` and 16 decode
    steps), then whisper with 1500 frames through ``prefill`` and 16
    decode steps (the launcher refuses audio); each cache within
    ``bf16_drift_limit`` in bf16 and 2e-4 in f32 of a fresh forward.
    -> (launches, kernel rows at each head)."""
    counts, rows = [], []
    for arch in FAMILY_ARCHS:
        extra = None
        if arch == "phi-3-vision-4.2b":
            def extra(model, toks):
                image = torch.randn(
                    (toks.shape[0], model.cfg.vision_tokens,
                     model.cfg.d_model), generator=gen,
                    device=dev).to(model.dtype)
                return {"image_prefix": check_cache(
                    model, toks, 512, bf16_drift_limit(model.cfg.n_layers),
                    FAMILY_STEPS, image_embeds=image)}
        n_layers = (get_smoke_config if smoke else get_config)(arch).n_layers
        serve = phase_serve(seed, dev, gen, arch=arch, smoke=smoke,
                            line=("models", {"sub": arch, "reduced": []}),
                            steps=FAMILY_STEPS,
                            bf16_limit=bf16_drift_limit(n_layers),
                            extra=extra)
        counts.append(serve["counts"])
        rows += kernels_serve(serve, reps=20, case=f"{arch} head")
        del serve
        torch.cuda.empty_cache()
    counts.append(models_whisper(seed, dev, gen, smoke))
    return counts, rows


def models_whisper(seed: int, dev, gen, smoke: bool = False) -> dict:
    """whisper-tiny, bf16 then f32 on the same weights: 1500 random
    frames and a wave of 4 prompts through ``prefill`` and 16 decode
    steps, against a fresh forward."""
    t_sub = time.perf_counter()
    cfg = (get_smoke_config if smoke else get_config)(AUDIO_ARCH)
    reset_launch_counts()
    model = build_model(cfg, torch.bfloat16, device=dev)
    params = model.init(gen)
    rng = np.random.default_rng(seed + 11)
    toks = left_padded([[1] + rng.integers(2, cfg.vocab,
                                           rng.integers(2, 9)).tolist()
                        for _ in range(4)])
    frames = torch.randn((4, cfg.encoder.n_frames, cfg.d_model),
                         generator=gen, device=dev)
    checks = [check_cache(model, toks, 128, bf16_drift_limit(cfg.n_layers),
                          FAMILY_STEPS, frames=frames)]
    with torch.inference_mode():
        t0 = time.perf_counter()
        _, cache = model.prefill(toks, max_len=128, frames=frames)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        nxt = torch.ones((4, 1), dtype=torch.long, device=dev)
        step_p50 = host_p50_ms(lambda: model.decode_step(cache, nxt), 10)
    model32 = build_model(cfg, torch.float32, device=dev)
    model32.load_state_dict(params)
    checks.append(check_cache(model32, toks, 128, 2e-4, FAMILY_STEPS,
                              frames=frames))
    counts = launch_counts()
    expect_counts("whisper", counts, bcsr_matmul=0, cyclic_encode=0,
                  decode_matmul=0)
    emit("models", sub=AUDIO_ARCH, arch=cfg.name, reduced=[],
         dtype="bfloat16", layers=cfg.n_layers,
         encoder_layers=cfg.encoder.n_layers, frames=cfg.encoder.n_frames,
         d_model=cfg.d_model, vocab=cfg.vocab,
         params_m=sum(p.numel() for p in model.parameters()) / 1e6,
         prefill_ms=prefill_ms, decode_step_p50_ms=step_p50, cache=checks,
         launches=counts, wall_s=time.perf_counter() - t_sub)
    return counts


def phase_models(seed: int, dev, gen, smoke: bool = False
                 ) -> tuple[dict, list]:
    """Phase 10: granite-moe-1b served at full depth and width through the
    launcher (its coded head, its kernel rows); ``CodedMoE`` on one of its
    layers in process and through a fleet; ``CodedAggregator`` over one
    layer's parameters in process, on a cluster and on that fleet; the
    other families.  ``smoke``: the smoke configs, for a rehearsal on the
    CPU.  -> (the path's launches, kernel rows)."""
    serve = phase_serve(seed, dev, gen, arch=MOE_ARCH, smoke=smoke,
                        line=("models", {"sub": "moe-serve", "reduced": []}))
    totals = [serve["counts"]]
    rows = kernels_serve(serve, reps=20, case="granite head")
    moe_counts, moe_rows, fleet, masks = models_coded_moe(seed, dev, serve)
    totals.append(moe_counts)
    rows += moe_rows
    try:
        totals.append(models_coded_grads(seed, dev, gen, serve["model"],
                                         fleet, masks))
    finally:
        fleet.close()
    del serve
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    family_counts, family_rows = models_families(seed, dev, gen, smoke)
    totals += family_counts
    counts = add_counts(*totals)
    emit("models", sub="total", launches=counts)
    return counts, rows + family_rows


# ---------------------------------------------------------------------------
# Phase 11: training on the card (repro_torch.launch.train)
# ---------------------------------------------------------------------------

TRAIN_ARCH = "phi3-mini-3.8b"
TRAIN_STEPS = 12
TRAIN_RETUNE_EVERY = 4
# engine masks held after each retune
TRAIN_MASKS = 3
# train-f32: one bf16 step against one f32 step on the same weights; the
# loss within REL's bf16 bound, and the global grad norm within one bf16
# ulp (2^-9) relative: the norm sums ~4e8 squared grads whose bf16
# roundings are independent and average out, so only a systematic fault
# of the bf16 backward reaches one ulp (measured on an H100 80GB HBM3 at
# 700 W: 6.7e-6)
TRAIN_BF16_LOSS_REL = 2e-2
TRAIN_BF16_GNORM_REL = 2.0 ** -9
# train-resume: tests/test_substrate.py's mid-run resume tolerance
RESUME_TOL = dict(rtol=1e-5, atol=1e-6)


def live_cuda_tensors(top: int = 6) -> list:
    """The largest tensors still alive on the card: [shape, dtype, GB,
    the types of the objects that hold them]."""
    with warnings.catch_warnings():    # isinstance on deprecated aliases
        warnings.simplefilter("ignore")
        found = [o for o in gc.get_objects()
                 if isinstance(o, torch.Tensor) and o.device.type == "cuda"]
    found.sort(key=lambda t: -t.numel() * t.element_size())
    return [[list(t.shape), str(t.dtype).removeprefix("torch."),
             t.numel() * t.element_size() / 1e9,
             sorted({type(r).__name__ for r in gc.get_referrers(t)
                     if r is not found})[:6]]
            for t in found[:top]]


def free_memory(where: str, phase: str = "train") -> dict:
    """Collect what earlier phases left (reference cycles included), give
    the allocator's cached blocks back and report the card's free memory
    and what still holds the most of it."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    row = {"free_gb": free / 1e9, "total_gb": total / 1e9,
           "allocated_gb": torch.cuda.memory_allocated() / 1e9,
           "largest_live": live_cuda_tensors()}
    emit(phase, sub=where, **row)
    return row


def adamw_bytes(params: dict, opt_state: dict) -> float:
    """Bytes one AdamW update must move: each parameter, its gradient
    (the parameter's dtype) and both moments read once, the parameter and
    both moments written once."""
    total = 0
    for name, p in params.items():
        moments = (opt_state["m"][name].element_size()
                   + opt_state["v"][name].element_size())
        total += p.numel() * (3 * p.element_size() + 2 * moments)
    return float(total)


def hold_retunes(trainer, plan, cluster, hidden, faults, checks: list):
    """Wrap ``trainer._retune``: each retune must launch exactly one
    ``cyclic_encode`` (of a snapshot of the live head, not the head
    itself) and re-ship the cluster's shards; then, under
    ``TRAIN_MASKS`` engine masks, one in-process matvec (1
    ``bcsr_matmul`` + 1 ``decode_matmul``) within max(REL, kappa eps) of
    hidden @ the live head in f64, and the cluster's round (k
    ``bcsr_matmul`` in its card workers + 1 ``decode_matmul``) bitwise
    the in-process result."""
    real = trainer._retune
    dtype = plan.executor.coded.dtype

    def retune(params, step):
        before = launch_counts()
        real(params, step)
        torch.cuda.synchronize()
        where = f"train retune after step {step}"
        expect_counts(where, launched_since(before), bcsr_matmul=0,
                      cyclic_encode=1, decode_matmul=0)
        entry = trainer.retunes[-1]
        if not entry.get("reshipped_bytes", 0) > 0:
            raise AssertionError(f"{where}: no shards re-shipped: {entry}")
        live = params["head"].detach()
        if plan._A is params["head"] or not torch.equal(plan._A, live):
            raise AssertionError(f"{where}: the plan does not hold a "
                                 f"snapshot of the live head")
        ref = hidden.double() @ live.double()
        patterns = []
        for _ in range(TRAIN_MASKS):
            done = faults.mask(plan.n, plan.s)
            before = launch_counts()
            got = plan.matvec(hidden, done)
            torch.cuda.synchronize()
            expect_counts(f"{where}: one matvec", launched_since(before),
                          bcsr_matmul=1, cyclic_encode=0, decode_matmul=1)
            row = check_decoded(
                where, dtype, plan, done, got, ref, live.shape[0],
                lambda rows: mv_stored_decode(plan, rows, hidden, plan.r))
            before = launch_counts()
            over = cluster.matvec(hidden, done)
            torch.cuda.synchronize()
            expect_counts(f"{where}: one cluster round",
                          launched_since(before), bcsr_matmul=plan.k,
                          cyclic_encode=0, decode_matmul=1)
            row["cluster_bitwise"] = bool(torch.equal(over, got))
            if not row["cluster_bitwise"]:
                raise AssertionError(f"{where}: the cluster round differs "
                                     f"from the in-process plan: "
                                     f"{rel_err(over, got.double())}")
            patterns.append(row)
        clean(where, cluster.reports)
        checks.append({"step": step, "backend": entry["backend"],
                       "reshipped_bytes": entry["reshipped_bytes"],
                       "patterns": patterns})

    trainer._retune = retune


def train_full(seed: int, dev, smoke: bool = False) -> tuple[dict, list]:
    """phi3-mini-3.8b at full depth and width in bf16 through the
    launcher's ``build`` and ``train`` steps and defaults (AdamW, f32
    moments, batch 8, seq 128, lr 3e-4, warmup steps // 10), 12 steps,
    no checkpoint (params + m + v as f32 would be ~46 GB of archive).
    The engine-shaped coded head (n=6, s=2 over the (3072, 32064) head)
    is registered as a coded plan served by a ``memory`` cluster of card
    workers and retuned every 4 steps (``hold_retunes``).  -> (the
    path's launches, kernel rows at the retuned plan's shapes)."""
    t_sub = time.perf_counter()
    argv = ["--arch", TRAIN_ARCH, "--steps", str(TRAIN_STEPS),
            "--seed", str(seed), "--device", str(dev)] \
        + (["--smoke"] if smoke else [])
    args = train_launcher.parse_args(argv)
    torch.cuda.reset_peak_memory_stats()

    # the main path: build, the coded head, train with its retunes
    reset_launch_counts()
    (cfg, model, trainer, dcfg), printed = launcher_call(
        train_launcher.build, args)
    # the coded head is compiled as the serve engine compiles it, over
    # the head the fit draws from --seed (drawn here from the same seed)
    model.init(torch.Generator(dev).manual_seed(args.seed))
    coded = CodedConfig(enabled=True, n_workers=6, stragglers=2)
    t0 = time.perf_counter()
    plan = compile_plan(model.head.detach().clone(), scheme=coded.scheme,
                        n=coded.n_workers, s=coded.stragglers,
                        seed=coded.seed, backend="auto", device=dev)
    torch.cuda.synchronize()
    compile_s = time.perf_counter() - t0
    expect_counts("train head compile", launch_counts(), bcsr_matmul=0,
                  cyclic_encode=1, decode_matmul=0)
    cluster = plan.to_cluster(transport="memory")
    try:
        card_workers("train", cluster)
        trainer.coded_plans = [(plan, lambda p: p["head"], cluster)]
        trainer.cfg = dataclasses.replace(trainer.cfg,
                                          retune_every=TRAIN_RETUNE_EVERY)
        hidden = torch.randn((2, cfg.d_model),
                             generator=torch.Generator(dev).manual_seed(
                                 seed + 19), device=dev)
        checks: list = []
        hold_retunes(trainer, plan, cluster, hidden,
                     StragglerFaults(rng=np.random.default_rng(seed)),
                     checks)
        t0 = time.perf_counter()
        (params, opt_state, history), lines = launcher_call(
            train_launcher.train, args, trainer, dcfg)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        printed += lines
        counts = launch_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        retunes = TRAIN_STEPS // TRAIN_RETUNE_EVERY
        per_mask = {"bcsr_matmul": 1 + plan.k, "decode_matmul": 2}
        expect_counts("train-full", counts,
                      bcsr_matmul=retunes * TRAIN_MASKS
                      * per_mask["bcsr_matmul"],
                      cyclic_encode=1 + retunes,
                      decode_matmul=retunes * TRAIN_MASKS
                      * per_mask["decode_matmul"])
        if len(checks) != retunes or len(trainer.retunes) != retunes:
            raise AssertionError(f"train-full: {len(checks)} retunes "
                                 f"checked, {trainer.retunes}")

        losses = [h["loss"] for h in history]
        if len(history) != TRAIN_STEPS or not np.all(np.isfinite(losses)):
            raise AssertionError(f"train-full: losses {losses}")
        first, last = float(np.mean(losses[:4])), float(np.mean(losses[-4:]))
        if not last < first:
            raise AssertionError(f"train-full: the loss did not fall: mean "
                                 f"of the first 4 {first}, last 4 {last}")
        step_ms = [h["dt"] * 1e3 for h in history]
        p50 = float(np.median(step_ms[1:]))         # step 0 warms up
        shape = ShapeConfig("train", args.seq, args.batch, "train")
        flops = cell_flops(cfg, shape, microbatches=args.microbatches)
        nbytes = adamw_bytes(params, opt_state)
        bound_ms = (flops.total / BF16_FLOPS_PER_S
                    + nbytes / HBM_BYTES_PER_S) * 1e3

        # one more step under the profiler (the path's counts are read)
        batch = {k: torch.as_tensor(v, device=dev) for k, v in
                 SyntheticTokens(dcfg).batch_at(TRAIN_STEPS).items()}
        box = {"opt": opt_state}

        def step():
            box["opt"], _, metrics = trainer._step(params, box["opt"], None,
                                                   batch)
            return float(metrics["loss"])
        step_row = device_census("train_step", step, p50)
        # the step's two halves: the loss and grads (forward, the remat
        # forward, backward), then AdamW alone on those grads
        grads_ms = host_p50_ms(lambda: trainer._grads(params, batch), 3)
        _, grads = trainer._grads(params, batch)

        def adamw():
            _, box["opt"], _ = apply_updates(trainer.opt_cfg, params, grads,
                                             box["opt"])
        adamw_ms = host_p50_ms(adamw, 3)
        adamw_row = device_census("adamw", adamw, adamw_ms)
        del grads

        done = checks[-1]["patterns"][0]["stragglers"]
        mask = np.ones(plan.n, bool)
        mask[done] = False
        rows = kernels_product(plan, hidden, mask, "train head", reps=20)
        rows = rows[:1] + [encode_row(plan, "train head")] + rows[1:]
        clean("train-full", cluster.reports)
    finally:
        cluster.shutdown()
    emit("train", sub="train-full", arch=cfg.name, reduced=[],
         dtype=str(model.dtype).removeprefix("torch."),
         params_b=sum(p.numel() for p in params.values()) / 1e9,
         layers=cfg.n_layers, d_model=cfg.d_model, vocab=cfg.vocab,
         steps=len(history), batch=args.batch, seq=args.seq, lr=args.lr,
         moment_dtype=trainer.opt_cfg.moment_dtype, remat=cfg.remat,
         losses=losses, loss_first4_mean=first, loss_last4_mean=last,
         grad_norms=[h["grad_norm"] for h in history],
         step_ms=step_ms, step_p50_ms=p50,
         tokens_per_s=args.batch * args.seq / (p50 / 1e3),
         peak_memory_gb=peak_gb, fit_s=fit_s, coded_compile_s=compile_s,
         bound_ms=bound_ms, bound_flops=flops.total,
         bound_flops_ms=flops.total / BF16_FLOPS_PER_S * 1e3,
         bound_adamw_bytes=nbytes,
         bound_adamw_ms=nbytes / HBM_BYTES_PER_S * 1e3,
         bound_note="cell_flops(train, microbatches=1) over 989 TFLOP/s "
                    "(bf16 dense) + AdamW's bytes over 3.35 TB/s",
         model_flops=flops.model_flops, bound_share=bound_ms / p50,
         step_kernels=step_row["device_kernels"],
         step_busy_share=step_row["busy_share"],
         grads_p50_ms=grads_ms, adamw_p50_ms=adamw_ms,
         adamw_kernels=adamw_row["device_kernels"],
         adamw_busy_ms=adamw_row["device_busy_ms"],
         adamw_bound_share=nbytes / HBM_BYTES_PER_S * 1e3 / adamw_ms,
         n=plan.n, s=plan.s, k=plan.k, backend=plan.backend,
         retunes=checks, stragglers=trainer.stragglers, launches=counts,
         printed=printed, wall_s=time.perf_counter() - t_sub)
    del model, trainer, params, opt_state, box, plan, cluster
    return counts, rows


def one_step(model, steps_cfg: dict, dcfg) -> dict:
    """One launcher-default AdamW step of ``model`` on its current
    weights -> the step's history entry."""
    model.init = lambda gen: None         # keep the weights it holds
    tr = Trainer(model, AdamWConfig(**steps_cfg), TrainConfig(steps=1))
    _, _, hist = tr.fit(lambda start: make_pipeline(dcfg, start),
                        resume=False)
    return hist[0]


def train_f32(seed: int, dev, smoke: bool = False) -> dict:
    """phi3-mini-3.8b cut to 2 layers at full width: one step in bf16
    and one in f32 on the same weights (drawn in bf16, widened exactly),
    batch 8 x 128.  The losses within 2e-2 relative, the two global grad
    norms within 2^-9 relative (``TRAIN_BF16_GNORM_REL``)."""
    t_sub = time.perf_counter()
    base = (get_smoke_config if smoke else get_config)(TRAIN_ARCH)
    cfg = base.with_(n_layers=2)
    reset_launch_counts()
    m16 = build_model(cfg, torch.bfloat16, device=dev)
    sd = m16.init(torch.Generator(dev).manual_seed(seed))
    m32 = build_model(cfg, torch.float32, device=dev)
    m32.load_state_dict(sd)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=128, global_batch=8,
                      seed=seed)
    opt = dict(lr=3e-4, warmup_steps=0, total_steps=1)
    h16, h32 = one_step(m16, opt, dcfg), one_step(m32, opt, dcfg)
    expect_counts("train-f32", launch_counts(), bcsr_matmul=0,
                  cyclic_encode=0, decode_matmul=0)
    loss_rel = abs(h16["loss"] - h32["loss"]) / abs(h32["loss"])
    gnorm_rel = abs(h16["grad_norm"] - h32["grad_norm"]) / h32["grad_norm"]
    row = {"arch": cfg.name, "reduced": ["n_layers 32 -> 2"],
           "loss_bf16": h16["loss"], "loss_f32": h32["loss"],
           "loss_rel_gap": loss_rel, "loss_limit": TRAIN_BF16_LOSS_REL,
           "grad_norm_bf16": h16["grad_norm"],
           "grad_norm_f32": h32["grad_norm"], "grad_norm_rel_gap": gnorm_rel,
           "grad_norm_limit": TRAIN_BF16_GNORM_REL,
           "step_ms_bf16": h16["dt"] * 1e3, "step_ms_f32": h32["dt"] * 1e3}
    emit("train", sub="train-f32", **row,
         wall_s=time.perf_counter() - t_sub)
    if not loss_rel <= TRAIN_BF16_LOSS_REL:
        raise AssertionError(f"train-f32: bf16 loss off f32's: {row}")
    if not gnorm_rel <= TRAIN_BF16_GNORM_REL:
        raise AssertionError(f"train-f32: bf16 grad norm off f32's: {row}")
    del m16, m32, sd
    return row


def train_resume(seed: int, dev) -> dict:
    """The phi3-mini smoke config on the card, f32, as
    tests/test_substrate.py runs it: 6 steps uninterrupted; 3 steps, a
    checkpoint, and a fresh ``Trainer`` resumed to 6; the final params
    within rtol=1e-5, atol=1e-6 (the embedding's backward sums with
    atomics, so bitwise is not expected); then 6 steps with int8
    compression and 6 with 2 microbatches."""
    t_sub = time.perf_counter()
    cfg = get_smoke_config(TRAIN_ARCH)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=4)

    def run(steps, ckpt_dir=None, total=None, **tkw):
        model = build_model(cfg, torch.float32, device=dev)
        tr = Trainer(model, AdamWConfig(lr=1e-3, warmup_steps=2,
                                        total_steps=total or steps),
                     TrainConfig(steps=steps, ckpt_every=3, log_every=100,
                                 ckpt_dir=ckpt_dir, **tkw))
        params, _, hist = tr.fit(lambda start: make_pipeline(dcfg, start),
                                 gen=torch.Generator(dev).manual_seed(seed))
        return {k: v.detach().clone() for k, v in params.items()}, hist

    reset_launch_counts()
    root = Path(__file__).resolve().parent / "build"
    root.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=root) as tmp:
        pa, hist_a = run(6, f"{tmp}/a")
        run(3, f"{tmp}/b", total=6)
        ckpts = sorted(p.name for p in Path(f"{tmp}/b").iterdir())
        pb, hist_b = run(6, f"{tmp}/b")
    int8 = run(6, compression=CompressionConfig(mode="int8"))[1]
    micro = run(6, microbatches=2)[1]
    expect_counts("train-resume", launch_counts(), bcsr_matmul=0,
                  cyclic_encode=0, decode_matmul=0)
    worst = max(float((pa[k] - pb[k]).abs().max()) for k in pa)
    excess = max(float(((pa[k] - pb[k]).abs() - RESUME_TOL["atol"]
                        - RESUME_TOL["rtol"] * pb[k].abs()).max())
                 for k in pa)
    row = {"arch": cfg.name, "checkpoints": ckpts,
           "resumed_at": hist_b[0]["step"] if hist_b else None,
           "losses": [h["loss"] for h in hist_a],
           "resumed_losses": [h["loss"] for h in hist_b],
           "max_abs_param_diff": worst, "tol": RESUME_TOL,
           "int8_losses": [h["loss"] for h in int8],
           "microbatch2_losses": [h["loss"] for h in micro]}
    emit("train", sub="train-resume", **row,
         wall_s=time.perf_counter() - t_sub)
    if row["resumed_at"] != 3 or excess > 0:
        raise AssertionError(f"train-resume: {row}")
    for name in ("losses", "int8_losses", "microbatch2_losses"):
        if len(row[name]) != 6 or not np.all(np.isfinite(row[name])):
            raise AssertionError(f"train-resume {name}: {row[name]}")
    return row


def phase_train(seed: int, dev, smoke: bool = False) -> tuple[dict, list]:
    """Phase 11: training on the card.  ``train-full`` (the main path,
    with the coded head retuned under it), ``train-f32`` and
    ``train-resume``.  ``smoke``: the smoke config for ``train-full`` and
    ``train-f32``, for a rehearsal on the CPU.  -> (the path's launches,
    kernel rows)."""
    free_memory("memory")
    counts, rows = train_full(seed, dev, smoke)
    free_memory("memory-after-full")
    train_f32(seed, dev, smoke)
    train_resume(seed, dev)
    emit("train", sub="total", launches=counts)
    return counts, rows


# ---------------------------------------------------------------------------
# Phase 12: the mesh on the card (repro_torch.parallel, launch.dryrun)
# ---------------------------------------------------------------------------

MESH_ARCH = "kimi-k2-1t-a32b"
# one MoE layer's experts are 33.8 GB in bf16: two layers leave no room
# on 80 GB for the coded head and its checks
MESH_LAYERS = 1
# the f32 EP check casts up the layer's first experts (and the router's
# columns for them): all 384 in f32 would be 67.6 GB beside the model
MESH_F32_EXPERTS = 48
MESH_RESTORE_ARCH = "kimi-k2-1t-a32b"
# the dry-run cells (host only, one process each, all at once): kimi's
# train cell through the EP path and whisper-tiny's decode cell; then,
# for each fault the dry run's repair fixed, the cell that traces
# fastest: a dense train_4k (the vocab-parallel embedding's gradient),
# whisper-tiny's prefill_32k (the cache written out of place; the other
# archs' prefills walk 64 x 64 attention chunks per layer), granite's
# decode_32k (the MoE's routing, default path), gemma3's long_500k (a
# residual added to the embedding), phi-3-vision's train_4k (the
# image prefix beside the embedding) and mamba2's prefill_32k (the SSD
# scan and causal conv on each rank's rows: torch 2.11 has no rule for
# their padding).  Train cells are cut to one microbatch (the
# reference's 4 would take four times the trace time).
DRYRUN_CELLS = (
    ("kimi-k2-1t-a32b", "train_4k", "moe_ep", 1),
    ("whisper-tiny", "decode_32k", "", 4),
    ("phi3-mini-3.8b", "train_4k", "", 1),
    ("whisper-tiny", "prefill_32k", "", 4),
    ("granite-moe-1b-a400m", "decode_32k", "", 4),
    ("gemma3-12b", "long_500k", "", 4),
    ("phi-3-vision-4.2b", "train_4k", "", 1),
    ("mamba2-1.3b", "prefill_32k", "", 4),
)
DRYRUN_TIMEOUT_S = 900


@contextlib.contextmanager
def card_mesh(dev):
    """A one-rank NCCL process group on ``dev`` (an in-memory store, no
    port) and its (1, 1) ('data', 'model') mesh; torn down on exit.  A
    group that fails to start raises."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if dev.index is None:
        dev = torch.device(dev.type, torch.cuda.current_device())
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1, device_id=dev)
    try:
        yield init_device_mesh("cuda", (1, 1),
                               mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()


def start_dryrun(root: Path) -> subprocess.Popen:
    """The dry-run cells, one process each and all at once, then the
    roofline over them, in one host-only process group (its stdout: the
    dry run's and the roofline's lines; a failed cell fails it)."""
    out = root / "build" / "dryrun"
    cells = []
    for arch, shape, opts, micro in DRYRUN_CELLS:
        cells.append(
            f"{sys.executable} -m repro_torch.launch.dryrun --arch {arch} "
            f"--shape {shape} --microbatches {micro} --out {out}"
            + (f" --opts {opts}" if opts else ""))
    roofline = (f"{sys.executable} -m repro_torch.analysis.roofline "
                f"--artifacts {out} --out {root / 'build' / 'roofline.json'}")
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    (root / "build").mkdir(exist_ok=True)
    script = (f"rm -rf {out}; pids=''; "
              + "".join(f"(time {cell}) & pids=\"$pids $!\"; "
                        for cell in cells)
              + "rc=0; for p in $pids; do wait $p || rc=1; done; "
              f"[ $rc = 0 ] && (time {roofline})")
    # files, not pipes: nothing reads the output until phase 12
    with open(root / "build" / "dryrun.out", "w") as so, \
            open(root / "build" / "dryrun.err", "w") as se:
        return subprocess.Popen(["bash", "-c", script], cwd=root, env=env,
                                stdout=so, stderr=se,
                                start_new_session=True)


def stop_dryrun(proc: subprocess.Popen) -> None:
    """Kill the dry run's process group (the shell and its python) if it
    still runs, and reap it."""
    if proc.poll() is None:
        os.killpg(proc.pid, 9)
        proc.wait()


def place_params(mesh, model, cfg) -> dict:
    """The model's parameters placed on ``mesh`` by ``param_shardings``:
    each a DTensor over the parameter itself (on a one-rank mesh a shard
    is the whole tensor: no copy) -> counts per placement."""
    from torch.distributed.tensor import DTensor

    from repro_torch.parallel import param_shardings
    from repro_torch.parallel.sharding import spec_of

    params = dict(model.named_parameters())
    pls = param_shardings(mesh, params, cfg)
    specs: dict = {}
    for name, p in params.items():
        d = DTensor.from_local(p.detach(), mesh, pls[name], run_check=False)
        if d.to_local().data_ptr() != p.data_ptr() or d.shape != p.shape:
            raise AssertionError(f"placing {name} copied or reshaped it")
        key = str(spec_of(mesh, d.placements, d.ndim))
        specs[key] = specs.get(key, 0) + 1
    return specs


@contextlib.contextmanager
def ep_calls():
    """Count ``moe_block_ep`` and ``moe_block`` calls while active, and
    keep the first EP call's input (the served layer's)."""
    seen = {"ep": 0, "block": 0, "x": None}
    real_ep, real_block = moe_module.moe_block_ep, moe_module.moe_block

    def ep(p, x, *args):
        seen["ep"] += 1
        if seen["x"] is None:
            seen["x"] = x.detach().clone()
        return real_ep(p, x, *args)

    def block(*args):
        seen["block"] += 1
        return real_block(*args)

    moe_module.moe_block_ep, moe_module.moe_block = ep, block
    try:
        yield seen
    finally:
        moe_module.moe_block_ep, moe_module.moe_block = real_ep, real_block


def hold_ep(mesh, model, x: torch.Tensor) -> dict:
    """``moe_block_ep`` against ``moe_block`` on the served layer's input
    at a capacity where no slot drops: bf16 on the whole layer within
    the bf16 limit (bitwise reported), and f32 on the layer's first
    ``MESH_F32_EXPERTS`` experts cast up within 1e-4 relative."""
    p = model.layers[0].moe
    moe = model.cfg.moe
    full = dataclasses.replace(moe, capacity_factor=moe.n_experts / moe.top_k)
    dp = ("data",)
    with torch.inference_mode():
        y_ep, aux_ep = moe_module.moe_block_ep(p, x, full, mesh, dp, "model")
        y, aux = moe_module.moe_block(p, x, full)
        e = min(MESH_F32_EXPERTS, moe.n_experts)
        sub = dataclasses.replace(moe, n_experts=e, capacity_factor=e / moe.top_k)
        p32 = {"router": p["router"][:, :e].float(),
               **{n: p[n][:e].float() for n in ("w_gate", "w_up", "w_down")}}
        y32_ep, aux32_ep = moe_module.moe_block_ep(p32, x.float(), sub, mesh,
                                                   dp, "model")
        y32, aux32 = moe_module.moe_block(p32, x.float(), sub)
    limit = bf16_drift_limit(MESH_LAYERS)
    row = {"tokens": x.shape[0] * x.shape[1], "capacity_factor":
           full.capacity_factor, "bf16_rel_err": rel_err(y_ep, y.double()),
           "bf16_limit": limit, "bf16_bitwise": bool(torch.equal(y_ep, y)),
           "aux_err": abs(float(aux_ep) - float(aux)),
           "f32_experts": e, "f32_rel_err": rel_err(y32_ep, y32.double()),
           "f32_limit": 1e-4, "f32_aux_err": abs(float(aux32_ep)
                                                 - float(aux32))}
    if not (row["bf16_rel_err"] <= limit and row["f32_rel_err"] <= 1e-4
            and row["aux_err"] <= 1e-6 and row["f32_aux_err"] <= 1e-6):
        raise AssertionError(f"mesh-kimi EP against moe_block: {row}")
    del p32, y32_ep, y32
    return row


def mesh_kimi(seed: int, dev, gen, mesh, smoke: bool = False
              ) -> tuple[dict, list]:
    """kimi-k2-1t-a32b at full width, cut to one layer, bf16, served
    through the launcher's steps and defaults with every MoE call through
    ``moe_block_ep`` on the one-rank card mesh -> (launches, kernel rows
    at kimi's head)."""
    t_sub = time.perf_counter()
    base = (get_smoke_config if smoke else get_config)(MESH_ARCH)
    cut = base.with_(n_layers=MESH_LAYERS)
    argv = ["--arch", MESH_ARCH, "--coded", "--seed", str(seed),
            "--device", str(dev)] + (["--smoke"] if smoke else [])
    args = launcher.parse_args(argv)
    torch.cuda.reset_peak_memory_stats()
    free = torch.cuda.mem_get_info()[0]

    # the main path: build (the launcher reads the cut config), place,
    # serve under the EP context, the launcher's coded-head check
    reset_launch_counts()
    real_config = launcher.get_smoke_config if smoke else launcher.get_config
    t0 = time.perf_counter()
    with contextlib.ExitStack() as st:
        st.callback(setattr, launcher,
                    "get_smoke_config" if smoke else "get_config",
                    real_config)
        setattr(launcher, "get_smoke_config" if smoke else "get_config",
                lambda arch: cut)
        (cfg, model, params, engine), printed = launcher_call(
            launcher.build, args)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    expect_counts("mesh-kimi build", launch_counts(), bcsr_matmul=0,
                  cyclic_encode=1, decode_matmul=0)
    mem = {"build": torch.cuda.memory_allocated() / 1e9}
    placed = place_params(mesh, model, cfg)
    plan = engine.coded
    timer = StepTimer(engine)
    rng = np.random.default_rng(args.seed)
    reqs = launcher.make_requests(args, cfg, rng)
    def ep():
        return expert_parallel(mesh, ("data",), "model")

    before = launch_counts()
    t0 = time.perf_counter()
    with ep(), ep_calls() as calls, RouteLog() as routed:
        out, lines = launcher_call(launcher.serve, engine, reqs)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    printed += lines
    expect_counts("mesh-kimi serving", launched_since(before),
                  bcsr_matmul=0, cyclic_encode=0, decode_matmul=0)
    if calls["ep"] == 0 or calls["block"] != 0:
        raise AssertionError(f"mesh-kimi: MoE calls {calls['ep']} through "
                             f"moe_block_ep, {calls['block']} around it")
    before = launch_counts()
    worst, lines = launcher_call(launcher.check_coded_head, args, cfg,
                                 params, engine, rng)
    printed += lines
    expect_counts("mesh-kimi launcher coded check", launched_since(before),
                  bcsr_matmul=5, cyclic_encode=0, decode_matmul=5)
    counts = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    mem["served"] = torch.cuda.memory_allocated() / 1e9
    if len(out) != args.requests or any(
            len(r.output) != args.max_new or not all(
                0 <= t < cfg.vocab for t in r.output) for r in out):
        raise AssertionError(f"mesh-kimi: {[r.output for r in out]}")
    decode_ms = timer.ms("decode")
    context = float(np.mean([len(r.prompt) for r in reqs])) \
        + args.max_new / 2
    share = expert_share(routed, cfg.moe.n_experts, args.batch)
    bound_ms = decode_step_bytes(model, args.batch, context, share) \
        / HBM_BYTES_PER_S * 1e3

    # the checks: EP against moe_block, the cache against a fresh
    # forward without the EP context, the coded head under 5 masks
    before = launch_counts()
    ep_row = hold_ep(mesh, model, calls["x"])
    mem["ep_check"] = torch.cuda.memory_allocated() / 1e9
    toks = left_padded([r.prompt for r in reqs[: args.batch]])
    cache_row = check_cache(model, toks, args.max_len,
                            bf16_drift_limit(MESH_LAYERS), FAMILY_STEPS,
                            cached=ep)
    with ep():
        step = step_census(model, toks, args.max_len)
    expect_counts("mesh-kimi checks", launched_since(before),
                  bcsr_matmul=0, cyclic_encode=0, decode_matmul=0)
    patterns, masks, hidden = check_head(plan, engine, cfg, params, gen,
                                         dev, "mesh-kimi")
    mem["head_check"] = torch.cuda.memory_allocated() / 1e9
    line = dict(arch=cfg.name,
         reduced=[f"n_layers {base.n_layers} -> {MESH_LAYERS}"],
         dtype=str(model.dtype).removeprefix("torch."),
         params_b=sum(p.numel() for p in model.parameters()) / 1e9,
         layers=cfg.n_layers, d_model=cfg.d_model, heads=cfg.attn.n_heads,
         kv_heads=cfg.attn.n_kv_heads, experts=cfg.moe.n_experts,
         top_k=cfg.moe.top_k, d_expert=cfg.moe.d_expert, vocab=cfg.vocab,
         mesh={"shape": list(mesh.shape), "axes": list(mesh.mesh_dim_names),
               "backend": "nccl", "ranks": 1},
         placed_specs=placed, free_gb_before=free / 1e9,
         requests=args.requests, batch=args.batch, max_new=args.max_new,
         n=plan.n, s=plan.s, k=plan.k, backend=plan.backend,
         served=len(out), serve_s=serve_s, build_s=build_s,
         moe_ep_calls=calls["ep"], moe_block_calls=calls["block"],
         decode_steps=len(decode_ms),
         decode_step_p50_ms=float(np.median(decode_ms)),
         decode_step_ms_min=min(decode_ms), decode_step_ms_max=max(decode_ms),
         bound_ms=bound_ms, bound_by="bytes", decode_expert_share=share,
         bound_note="weights (routed experts only) + K/V at the mean "
                    "context over 3.35 TB/s",
         decode_step_busy_share=step["busy_share"],
         peak_memory_gb=peak_gb, launcher_worst_rel_err=worst,
         ep=ep_row, cache=cache_row, coded_patterns=patterns,
         allocated_gb=mem, launches=counts,
         printed=printed)
    # the head's kernel rows need only the plan (and the head it holds):
    # the plain encode's f32 temporaries (~25 GB) do not fit beside the
    # layer's experts
    del model, params, engine, calls, timer, routed
    gc.collect()
    torch.cuda.empty_cache()
    rows = kernels_serve({"engine": argparse.Namespace(coded=plan),
                          "hidden": hidden, "done": masks[0]}, reps=20,
                         case="kimi head")
    emit("mesh", sub="mesh-kimi", **line,
         wall_s=time.perf_counter() - t_sub)
    return counts, rows


def mesh_restore(seed: int, dev, mesh) -> dict:
    """A smoke-config checkpoint written by the port's trainer on the
    card, restored with ``restore_resharded`` onto the card mesh by
    ``param_shardings`` / ``zero1_shardings``: every leaf bitwise the
    saved array."""
    from torch.distributed.tensor import DTensor

    from repro_torch.optim.adamw import init_state
    from repro_torch.parallel import param_shardings, zero1_shardings
    from repro_torch.train import checkpoint

    t_sub = time.perf_counter()
    cfg = get_smoke_config(MESH_RESTORE_ARCH)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=4)
    root = Path(__file__).resolve().parent / "build"
    root.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=root) as tmp:
        model = build_model(cfg, torch.float32, device=dev)
        tr = Trainer(model, AdamWConfig(lr=1e-3, warmup_steps=1,
                                        total_steps=2),
                     TrainConfig(steps=2, ckpt_every=2, log_every=100,
                                 ckpt_dir=tmp))
        tr.fit(lambda start: make_pipeline(dcfg, start),
               gen=torch.Generator(dev).manual_seed(seed))
        step = checkpoint.latest_step(tmp)
        params = {k: v.detach() for k, v in model.named_parameters()}
        template = {"params": params,
                    "opt": init_state(AdamWConfig(), params)}
        zs = zero1_shardings(mesh, params, cfg)
        got = checkpoint.restore_resharded(
            tmp, step, template,
            {"params": param_shardings(mesh, params, cfg),
             "opt": {"step": None, "m": zs, "v": zs}}, mesh=mesh, cfg=cfg)
        saved = checkpoint.load(tmp, step)
    leaves = mismatched = 0
    for part, tree in (("params", got["params"]), ("m", got["opt"]["m"]),
                       ("v", got["opt"]["v"])):
        for name, t in tree.items():
            key, _ = reference_key(name, cfg)
            prefix = "['params']" if part == "params" else f"['opt']['{part}']"
            want = saved[prefix + key]
            layer = int(name.split(".")[1]) // len(cfg.pattern) \
                if name.startswith("layers.") else None
            if layer is not None:
                want = want[layer]
            leaves += 1
            if not (isinstance(t, DTensor) and t.device.type == dev.type
                    and torch.equal(t.full_tensor().cpu(),
                                    torch.from_numpy(want))):
                mismatched += 1
    row = {"arch": cfg.name, "step": step, "leaves": leaves,
           "mismatched": mismatched, "opt_step": int(got["opt"]["step"]),
           "bitwise": mismatched == 0}
    emit("mesh", sub="mesh-restore", **row,
         wall_s=time.perf_counter() - t_sub)
    if mismatched or row["opt_step"] != step:
        raise AssertionError(f"mesh-restore: {row}")
    return row


def mesh_dryrun(proc: subprocess.Popen) -> dict:
    """Wait for the dry-run subprocess and hold its artifacts: every cell
    ``ok``, the roofline's three terms for each."""
    t_sub = time.perf_counter()
    try:
        proc.wait(timeout=DRYRUN_TIMEOUT_S)
    finally:
        stop_dryrun(proc)
    root = Path(__file__).resolve().parent / "build"
    out = (root / "dryrun.out").read_text()
    err = (root / "dryrun.err").read_text()
    if proc.returncode != 0:
        raise AssertionError(f"mesh-dryrun failed: {out[-2000:]} "
                             f"{err[-3000:]}")
    rows = {(r["arch"], r["shape"]): r for r in
            json.loads((root / "roofline.json").read_text())}
    cells = []
    for arch, shape, opts, micro in DRYRUN_CELLS:
        suffix = (f"__{opts}" if opts else "") \
            + (f"__mb{micro}" if micro != 4 else "")
        art = json.loads((root / "dryrun" / f"{arch}__{shape}__32x8"
                          f"{suffix}.json").read_text())
        if art["status"] != "ok":
            raise AssertionError(f"mesh-dryrun {arch} {shape}: "
                                 f"{art.get('error')} "
                                 f"{art.get('traceback', '')[-1500:]}")
        r = rows[(arch, shape)]
        cells.append({
            "arch": arch, "shape": shape, "opts": art["opts"],
            "microbatches": micro, "status": art["status"],
            "devices": art["devices"], "trace_s": art["compile_s"],
            "flops": art["flops"], "flops_scope": art["flops_scope"],
            "memory": art["memory"],
            "collective_bytes": art["collective_bytes"],
            "collective_counts": art["collective_counts"],
            "t_compute_s": r["t_compute_s"], "t_memory_s": r["t_memory_s"],
            "t_collective_s": r["t_collective_s"],
            "dominant": r["dominant"], "projected_mfu": r["projected_mfu"]})
    times = [line for line in err.splitlines() if line.startswith("real")]
    row = {"cells": cells, "process_s": times,
           "reduced": ["train_4k cells: --microbatches 4 -> 1"]}
    emit("mesh", sub="mesh-dryrun", **row,
         wait_s=time.perf_counter() - t_sub)
    return row


def phase_mesh(seed: int, dev, gen, dryrun: subprocess.Popen,
               smoke: bool = False) -> tuple[dict, list]:
    """Phase 12: ``mesh-kimi`` (the main path), ``mesh-restore`` and
    ``mesh-dryrun`` (the dry run started with phase 11, host only).
    ``smoke``: kimi's smoke config, for a rehearsal on the CPU."""
    free_memory("memory", phase="mesh")
    with card_mesh(dev) as mesh:
        torch.cuda.synchronize()
        counts, rows = mesh_kimi(seed, dev, gen, mesh, smoke)
        gc.collect()
        torch.cuda.empty_cache()
        mesh_restore(seed, dev, mesh)
    mesh_dryrun(dryrun)
    emit("mesh", sub="total", launches=counts)
    return counts, rows


# ---------------------------------------------------------------------------
# Phase 13: the examples
# ---------------------------------------------------------------------------

# what an example's command line adds to its defaults (a CPU rehearsal
# adds "--device", "cpu")
EXAMPLE_ARGS: list = []
EXAMPLE_TIMEOUT_S = 300      # each run's own (8-20 s on the card)
EXAMPLE_LANES = 4
# the launches of one run in this process (see phase 13 above)
EXAMPLE_LAUNCHES = {
    "quickstart": {"bcsr_matmul": 2, "cyclic_encode": 3,
                   "decode_matmul": 2},
    "edge_offload": {"bcsr_matmul": 2, "cyclic_encode": 1,
                     "decode_matmul": 2},
    "serve_coded": {"bcsr_matmul": 5, "cyclic_encode": 1,
                    "decode_matmul": 5},
}


def example_path(root: Path, name: str) -> Path:
    return root / "examples" / "torch" / f"{name}.py"


def run_example(root: Path, name: str, cwd: Path) -> dict:
    """One example as a subprocess from ``cwd``: its exit code, wall time
    and last line (a run past its time limit raises)."""
    cwd.mkdir(parents=True)
    cmd = [sys.executable, str(example_path(root, name)), *EXAMPLE_ARGS]
    if name == "train_lm":
        cmd += ["--ckpt-dir", str(cwd / "ckpt")]
    t0 = time.perf_counter()
    p = subprocess.run(cmd, cwd=cwd, capture_output=True, text=True,
                       timeout=EXAMPLE_TIMEOUT_S)
    lines = p.stdout.strip().splitlines()
    return {"rc": p.returncode, "wall_s": time.perf_counter() - t0,
            "last": lines[-1] if lines else "",
            "stderr": p.stderr[-3000:] if p.returncode else ""}


def examples_in_process(root: Path) -> dict:
    """quickstart, edge_offload and serve_coded run in this process, each
    between a reset and a read of the launch counters, which must be
    ``EXAMPLE_LAUNCHES``' -> their sum."""
    import runpy

    total = dict.fromkeys(SOURCES, 0)
    for name, want in EXAMPLE_LAUNCHES.items():
        path = example_path(root, name)
        argv, sys.argv = sys.argv, [str(path), *EXAMPLE_ARGS]
        out = io.StringIO()
        try:
            reset_launch_counts()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                runpy.run_path(str(path), run_name="__main__")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = launch_counts()
        finally:
            sys.argv = argv
        expect_counts(f"examples {name} (in process)", counts, **want)
        emit("examples", sub=f"{name}-in-process", wall_s=wall,
             launches=counts, last=out.getvalue().strip().splitlines()[-1])
        total = add_counts(total, counts)
        gc.collect()
        torch.cuda.empty_cache()
    return total


def phase_examples(root: Path) -> dict:
    """Phase 13: every example as a subprocess (``EXAMPLE_LANES`` at a
    time) while three of them run in this process -> the in-process
    launches.  An example that fails fails the phase."""
    t0 = time.perf_counter()
    names = sorted(p.stem for p in (root / "examples" / "torch").glob("*.py"))
    with tempfile.TemporaryDirectory(prefix="examples-") as tmp, \
            concurrent.futures.ThreadPoolExecutor(EXAMPLE_LANES) as pool:
        futs = {name: pool.submit(run_example, root, name, Path(tmp) / name)
                for name in names}
        counts = examples_in_process(root)
        runs = {name: f.result() for name, f in futs.items()}
    for name, r in runs.items():
        emit("examples", sub=name, **r)
        if r["rc"] != 0:
            raise AssertionError(f"examples {name}: rc {r['rc']}: "
                                 f"{r['stderr']}")
    emit("examples", sub="total", wall_s=time.perf_counter() - t0,
         launches=counts)
    return counts


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

    mla_rows = phase_mla(args.seed, dev)
    torch.cuda.empty_cache()
    mla_counts, mla_step = phase_mla_step(args.seed, dev)
    gc.collect()
    torch.cuda.empty_cache()
    held_row = phase_held(args.seed, dev)
    gc.collect()
    torch.cuda.empty_cache()
    phase_sparse_step(args.seed, dev)
    gc.collect()
    torch.cuda.empty_cache()
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
    cluster_counts, cluster_rows, edge = phase_cluster(args.seed, dev, gen,
                                                       rng, serve)
    rows += cluster_rows
    del serve
    torch.cuda.synchronize()
    edge_counts = phase_edge(args.seed, dev, edge)
    torch.cuda.synchronize()
    front_counts, front_rows = phase_front(args.seed, dev, edge)
    rows += front_rows
    del edge
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    models_counts, models_rows = phase_models(args.seed, dev, gen)
    rows += models_rows
    # the dry run is host only: it runs beside phases 11 and 12
    dryrun = start_dryrun(Path(__file__).resolve().parent)
    try:
        train_counts, train_rows = phase_train(args.seed, dev)
        rows += train_rows
        mesh_counts, mesh_rows = phase_mesh(args.seed, dev, gen, dryrun)
        rows += mesh_rows
    finally:
        stop_dryrun(dryrun)
    gc.collect()
    torch.cuda.empty_cache()
    examples_counts = phase_examples(Path(__file__).resolve().parent)

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
                         + serve_counts[name] + cluster_counts[name]
                         + edge_counts[name] + front_counts[name]
                         + models_counts[name] + train_counts[name]
                         + mesh_counts[name] + examples_counts[name]),
            "max_abs_err": main_row["max_abs_err"], "ms": main_row["ms"],
            "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"],
            "bound_by": main_row["bound_by"],
            "library_ms": main_row["library_ms"],
            "shape": main_row["shape"], "case": "mv",
        })
    # the same kernels at kimi-k2-1t-a32b's head (phase 12), with the
    # launches of that path
    for name, (source, replaces) in SOURCES.items():
        row = next(r for r in mesh_rows if r["name"] == name)
        table.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": mesh_counts[name],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "shape": row["shape"], "case": row["case"],
        })
    # latent attention's kernel at the decode cell's shape (phase 1b),
    # with the launches of its main path, the cell's decode steps (1c)
    row = mla_rows[0]
    table.append({
        "name": "mla_decode_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/mla_decode.cu",
        "replaces": None, "launches": mla_counts["mla_decode_attention"],
        "launches_from": f"{mla_step['steps']} x {mla_step['case']}",
        "max_abs_err": row["max_abs_err"], "ms": row["ms"],
        "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"], "library_ms": None,
        "shape": row["shape"], "case": row["case"],
    })
    # the held experts' kernel at the decode cell's shape (phase 1d), with
    # the launches of the cell's decode steps (1c)
    table.append({
        "name": "held_expert_ffn", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/held_experts.cu",
        "replaces": None, "launches": mla_counts["held_expert_ffn"],
        "launches_from": f"{mla_step['steps']} x {mla_step['case']}",
        "max_abs_err": held_row["max_abs_err"], "ms": held_row["ms"],
        "plain_ms": held_row["plain_ms"], "bound_ms": held_row["bound_ms"],
        "bound_by": held_row["bound_by"],
        "library_ms": held_row["library_ms"],
        "shape": held_row["shape"], "case": held_row["case"],
    })
    print(json.dumps({"kernels": table}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
