"""Block-sparse worker product C = A^T @ B, A packed block-sparse.

Replaces the TPU kernel ``src/repro/kernels/bcsr_matmul.py::bcsr_matmul``
(Pallas body ``_bcsr_matmul_kernel``): an edge worker multiplying its
sparsity-preserved coded shard, one (bk x bm) tile of A per slot of the
packed form (``repro_torch.runtime.pack``).

What bounds it on an H100: at the matvec (N = 8 requests) bytes, the
nonzero A tiles of the live workers over the memory rate.  At a Fig. 4
matmat (N = 1024 columns of a coded B shard) it does 2 * N flops per A
element, and f32 FFMA and the B rows the tiles select share the bound.

What the design does about it (``csrc/bcsr_matmul.cu``):

  * one warp (N < 64) or one thread block (N >= 64) per (output
    block-row, N-tile); the TPU grid's sequential slot axis becomes a
    loop inside it, fed by a ring of 3-4 shared-memory stages that
    16-byte ``cp.async`` copies fill several slots ahead, and C is
    written once from f32 registers, each output summed over the slots
    in order;
  * only the block-row's real slots (``counts``, from the packer's
    ``slot_counts``) are walked: pad slots are never read;
  * the live workers are named by ``rows`` and read straight out of the
    full packed operand, so the fastest-k gather the reference builds
    (``select_workers``, a copy of every live shard per call) never
    exists; with B given per worker (n_workers, K, N), a matmat's k
    products are one launch;
  * register tiles sized to N: at N < 64 each lane keeps 8 columns of
    one output row (8 FMAs per 2-3 shared loads), at N >= 64 each
    thread a 4 x 4 tile (16 FMAs per 2); f32 products are full f32 FFMA;
  * bf16 operands are converted to f32 once per slot in shared memory
    (a bf16 plan's matmat multiplies bf16 shards by the f32 coded B);
  * the ragged N and K edges are masked in the kernel instead of padding
    B.

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
        _build.count_launch(bcsr_matmul)
        return out


bcsr_matmul.launches = 0
