"""Block-sparse worker product C = A^T @ B, A packed block-sparse.

Replaces the TPU kernel ``src/repro/kernels/bcsr_matmul.py::bcsr_matmul``
(Pallas body ``_bcsr_matmul_kernel``): an edge worker multiplying its
sparsity-preserved coded shard, one (bk x bm) tile of A per slot of the
packed form (``repro_torch.runtime.pack``).

What bounds it on an H100: bytes.  At the main path's shapes it does
2 * N flops per A element it reads (N = 8 requests for the LM head's
matvec, N = 1024 for a Fig. 4 worker's matmat), far below the ~20 flops
per byte at which f32 FFMA, not HBM, would be the limit.  So its time is
the nonzero A tiles of the live workers, plus the B tiles they select,
over the memory rate.

What the design does about it (``csrc/bcsr_matmul.cu``):

  * one thread block per (output block-row, N-tile); the TPU grid's
    sequential slot axis becomes a loop inside the block, and C is
    written once from f32 registers;
  * every A byte is read once; B tiles are re-read by each block-row that
    selects them, from L2 when they fit there (the matvec's B is 100 KB);
  * the live workers are named by ``rows`` and read straight out of the
    full packed operand, so the fastest-k gather the reference builds
    (``select_workers``, a copy of every live shard per call) never
    exists;
  * bf16 inputs are upcast on load; the ragged N and K edges are masked
    in the kernel instead of padding B.

Pad slots (zero tiles at K-block 0) are multiplied like any slot.
"""

from __future__ import annotations

import torch

from . import _build
from .ref import bcsr_matmul_packed_ref

_MAX_BN = 64
_MAX_THREADS = 256
_MAX_SMEM = 48 * 1024


def _live_rows(rows: torch.Tensor, mb: int) -> torch.Tensor:
    """Packed block-rows of the workers ``rows``, in output order."""
    base = rows.long()[:, None] * mb
    return (base + torch.arange(mb, device=rows.device)).reshape(-1)


def bcsr_matmul_plain(a_data: torch.Tensor, a_idx: torch.Tensor,
                      b: torch.Tensor, rows: torch.Tensor | None = None,
                      *, mb: int = 1) -> torch.Tensor:
    """The kernel's function in plain PyTorch (same arguments)."""
    if rows is not None:
        sel = _live_rows(rows, mb)
        a_data, a_idx = a_data[sel], a_idx[sel]
    bk = a_data.shape[2]
    pad = (-b.shape[0]) % bk
    if pad:
        b = torch.nn.functional.pad(b, (0, 0, 0, pad))
    return bcsr_matmul_packed_ref(a_data, a_idx, b)


def _launch_shape(bm: int, n: int) -> tuple[int, int]:
    """(bn, rows per thread): the N-tile and the register tile."""
    bn = 1
    while bn < min(n, _MAX_BN):
        bn *= 2
    rpt = 1
    while bm * bn // rpt > _MAX_THREADS or bm % rpt:
        rpt *= 2
        if rpt > 32 or rpt > bm:
            raise ValueError(f"no launch shape for bm={bm}, bn={bn}")
    return bn, rpt


def bcsr_matmul(a_data: torch.Tensor, a_idx: torch.Tensor, b: torch.Tensor,
                rows: torch.Tensor | None = None, *, mb: int = 1,
                out: torch.Tensor | None = None) -> torch.Tensor:
    """C = A^T @ B from packed block-sparse A.

    a_data : (R, J, bk, bm) f32/bf16  packed tiles (zero-padded slots)
    a_idx  : (R, J) int32             K-block index per slot
    b      : (K, N) f32/bf16          dense right operand, any K
    rows   : (k,) int32 or None       live workers; output block-row g
             reads packed block-row ``rows[g // mb] * mb + g % mb``
    Returns C : (n_out * bm, N) float32, n_out = R or k * mb; written
    into ``out`` when given.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel or raises.
    """
    if a_data.ndim != 4 or a_idx.shape != a_data.shape[:2] or b.ndim != 2:
        raise ValueError(f"bad shapes a_data {tuple(a_data.shape)}, "
                         f"a_idx {tuple(a_idx.shape)}, b {tuple(b.shape)}")
    n_src, J, bk, bm = a_data.shape
    K, N = b.shape
    if rows is None:
        n_out = n_src
    else:
        if rows.ndim != 1 or n_src % mb:
            raise ValueError(f"rows {tuple(rows.shape)} / mb={mb} do not "
                             f"match {n_src} packed block-rows")
        n_out = rows.shape[0] * mb
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
    if rows is not None:
        _build.require(rows, "rows", dev, torch.int32)
    if out is not None:
        _build.require(out, "out", dev)
    if dev.type == "cpu":
        res = bcsr_matmul_plain(a_data, a_idx, b, rows, mb=mb)
        return res if out is None else out.copy_(res)
    if dev.type != "cuda":
        raise ValueError(f"bcsr_matmul: unsupported device {dev}")
    if out is None:
        out = torch.empty((n_out * bm, N), dtype=torch.float32, device=dev)
    if n_out == 0 or N == 0:
        return out.zero_()
    bn, rpt = _launch_shape(bm, N)
    if (bk * bm + bk * bn) * 4 > _MAX_SMEM:
        raise ValueError(f"tiles ({bk}x{bm}, bn={bn}) exceed the kernel's "
                         f"{_MAX_SMEM} bytes of shared memory")
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.repro_bcsr_matmul(
            a_data.data_ptr(), a_code, a_idx.data_ptr(), b.data_ptr(), b_code,
            None if rows is None else rows.data_ptr(), out.data_ptr(),
            n_out, mb, n_src, J, bk, bm, K, N, bn, rpt, _build.stream_ptr(dev))
    _build.check(err, "bcsr_matmul")
    bcsr_matmul.launches += 1
    return out


bcsr_matmul.launches = 0
