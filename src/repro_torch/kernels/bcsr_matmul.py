"""Block-sparse worker product C = A^T @ B, A packed block-sparse.

Replaces the TPU kernel ``src/repro/kernels/bcsr_matmul.py::bcsr_matmul``
(Pallas body ``_bcsr_matmul_kernel``): an edge worker multiplying its
sparsity-preserved coded shard, one (bk x bm) tile of A per slot of the
packed form (``repro_torch.runtime.pack``).

What bounds it on an H100: at a matvec (N = 1-8 rows of requests) bytes,
the nonzero A tiles of the live workers over the memory rate.  At a
Fig. 4 matmat (N = 1024 columns of a coded B shard) it does 2 * N flops
per A element, and f32 FFMA and the B rows the tiles select share the
bound.  In either, each output is one f32 sum over its block-row's real
slots and their K rows in order, as the plain version sums it: nothing
splits K, so the parallelism is the outputs.

What the design does about it (``csrc/bcsr_matmul.cu``), in two
layouts chosen by N:

  * narrow (N < 64, every matvec): one warp per (output block-row,
    column tile); a lane owns one of the block-row's 32 output columns
    and NC = N columns of B (N <= 8; tiles of 8 above), so no FMA or B
    load is spent past N.  Each warp streams its block-row's slots
    through its own ring of 3 shared-memory stages: one lane brings each
    32 x 32 A tile in with one bulk copy (TMA) and, where the slot's 32
    rows of B lie whole and 16-byte aligned in B, its B tile with
    another, both completed on the stage's mbarrier, so the lanes spend
    no instructions on copies; otherwise the lanes stage B by
    ``cp.async`` (plain loads only for a bf16 B of odd width or one not
    4-byte aligned).  Each K row's B values are read by the widest
    shared-memory loads the row's alignment allows, those loads being
    what bounds the FMA loop.  The warps are persistent, one-warp
    blocks, as many as the card holds at once (its SM count times the
    blocks an SM holds at the kernel's shared memory), cut so that each
    walks the same number of tasks give or take one: no fraction of a
    wave is left at the end of a large grid.
  * wide (N >= 64, the matmat): one thread block per (output block-row,
    128-column tile), a ring of 3 stages filled by 16-byte ``cp.async``
    copies, each thread a 4 x 4 register tile (16 FMAs per 2 shared
    loads), bf16 A tiles converted to f32 once per slot too (a bf16
    plan's matmat multiplies bf16 shards by the f32 coded B).

In both, bf16 A is widened to f32 exactly and a bf16 B tile once per
slot, and only the block-row's real slots (``counts``, from the packer's
``slot_counts``) are walked: pad slots are never read.  The live
workers are named by ``rows`` and read straight out of the full packed
operand, so the fastest-k gather the reference builds
(``select_workers``, a copy of every live shard per call) never exists;
with B given per worker (n_workers, K, N), a matmat's k products are one
launch.  The ragged N and K edges are masked in the kernel instead of
padding B.  ``bcsr_matmul.launches`` counts launches,
``narrow_launches`` and ``wide_launches`` split them by layout.

The kernel is specialised on the ``cuda`` backend's 32 x 32 tile; the
plain version takes any tile.
"""

from __future__ import annotations

import torch

from ..obs.trace import scope
from . import _build
from .ref import bcsr_matmul_packed_ref

TILE = 32
# slot indices of one block-row live in shared memory beside the ring
MAX_SLOTS = 8192
# the kernel takes its wide layout from this many columns of B on (the
# dispatch in csrc/bcsr_matmul.cu), as the per-layout counters count
WIDE_FROM = 64


def bcsr_matmul_plain(a_data: torch.Tensor, a_idx: torch.Tensor,
                      b: torch.Tensor, rows: torch.Tensor | None = None,
                      *, mb: int = 1,
                      counts: torch.Tensor | None = None) -> torch.Tensor:
    """The kernel's function in plain PyTorch (same arguments).

    Slots at or past ``counts`` are masked out, whatever they hold.
    """
    return bcsr_matmul_packed_ref(a_data, a_idx, b, rows, mb=mb,
                                  counts=counts)


def bcsr_matmul(a_data: torch.Tensor, a_idx: torch.Tensor, b: torch.Tensor,
                rows: torch.Tensor | None = None, *, mb: int = 1,
                counts: torch.Tensor | None = None,
                out: torch.Tensor | None = None) -> torch.Tensor:
    """C = A^T @ B from packed block-sparse A.

    a_data : (R, J, bk, bm) f32/bf16  packed tiles (padded slots)
    a_idx  : (R, J) int32             K-block index per slot
    b      : (K, N) f32/bf16          dense right operand shared by all
             workers, any K; or (R // mb, K, N), one per worker
    rows   : (k,) int32 or None       live workers; output block-row g
             is worker w = rows[g // mb] (g // mb without rows) and reads
             packed block-row ``w * mb + g % mb`` and, per worker, b[w]
    counts : (R,) int32 or None       real slots per packed block-row;
             the rest are skipped (None: all J)
    Returns C : (n_out * bm, N) float32, n_out = R or k * mb; written
    into ``out`` when given.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel or raises.  The host side, checks to launch, is one
    ``kernel.bcsr_matmul`` range under a recording profiler.
    """
    with scope("kernel.bcsr_matmul"):
        if (a_data.ndim != 4 or a_idx.shape != a_data.shape[:2]
                or b.ndim not in (2, 3)):
            raise ValueError(f"bad shapes a_data {tuple(a_data.shape)}, "
                             f"a_idx {tuple(a_idx.shape)}, b {tuple(b.shape)}")
        n_src, J, bk, bm = a_data.shape
        K, N = b.shape[-2:]
        if mb < 1 or n_src % mb:
            raise ValueError(f"mb={mb} does not divide {n_src} packed "
                             "block-rows")
        n_workers = n_src // mb
        if b.ndim == 3 and b.shape[0] != n_workers:
            raise ValueError(f"b holds {b.shape[0]} workers' operands, the "
                             f"packed form {n_workers}")
        if rows is None:
            n_out = n_src
        else:
            if rows.ndim != 1:
                raise ValueError(f"rows must be 1-d, got {tuple(rows.shape)}")
            n_out = rows.shape[0] * mb
        if counts is not None and counts.shape != (n_src,):
            raise ValueError(f"counts must be ({n_src},), got "
                             f"{tuple(counts.shape)}")
        if out is not None and (out.shape != (n_out * bm, N)
                                or out.dtype != torch.float32):
            raise ValueError(f"out must be float32 {(n_out * bm, N)}, got "
                             f"{out.dtype} {tuple(out.shape)}")

        dev = a_data.device
        a_code = _build.dtype_code(a_data, "a_data")
        b_code = _build.dtype_code(b, "b")
        _build.require(a_data, "a_data", dev)
        _build.require(a_idx, "a_idx", dev, torch.int32)
        _build.require(b, "b", dev)
        for name, t in (("rows", rows), ("counts", counts)):
            if t is not None:
                _build.require(t, name, dev, torch.int32)
        if out is not None:
            _build.require(out, "out", dev)
        if dev.type == "cpu":
            res = bcsr_matmul_plain(a_data, a_idx, b, rows, mb=mb,
                                    counts=counts)
            return res if out is None else out.copy_(res)
        if dev.type != "cuda":
            raise ValueError(f"bcsr_matmul: unsupported device {dev}")
        if (bk, bm) != (TILE, TILE):
            raise ValueError(f"bcsr_matmul: the kernel takes {TILE}x{TILE} "
                             f"tiles, got {bk}x{bm}")
        if J > MAX_SLOTS:
            raise ValueError(f"bcsr_matmul: {J} slots per block-row exceed "
                             f"the kernel's {MAX_SLOTS}")
        if a_data.data_ptr() % 16:
            raise ValueError("bcsr_matmul: a_data must start 16-byte aligned")
        if out is None:
            out = torch.empty((n_out * bm, N), dtype=torch.float32,
                              device=dev)
        if n_out == 0 or N == 0:
            return out.zero_()
        # the launcher makes dev current itself, only when it is not already
        err = _build.library().repro_bcsr_matmul(
            a_data.data_ptr(), a_code, a_idx.data_ptr(),
            None if counts is None else counts.data_ptr(),
            b.data_ptr(), b_code, K * N if b.ndim == 3 else 0,
            None if rows is None else rows.data_ptr(), out.data_ptr(),
            n_out, mb, n_workers, J, K, N, dev.index,
            _build.stream_ptr(dev))
        _build.check(err, "bcsr_matmul")
        _build.count_launch(bcsr_matmul, "wide_launches" if N >= WIDE_FROM
                            else "narrow_launches")
        return out


bcsr_matmul.launches = 0
bcsr_matmul.narrow_launches = 0
bcsr_matmul.wide_launches = 0
