"""Plain PyTorch versions of the kernels' functions.

Each is written with plain tensor ops only, works for any shape and
dtype, and computes from the *logical* operands (dense matrices,
support tables), so it is independent of the kernels' packing and
tiling.  The CPU tests hold them against ``repro.kernels.ref``; the
kernel wrappers run them for CPU tensors; ``chip_smoke.py`` holds each
CUDA kernel against them on the card.
"""

from __future__ import annotations

import numpy as np
import torch

F32 = torch.float32


# ---------------------------------------------------------------------------
# bcsr_matmul: C = A^T @ B with block-sparse A
# ---------------------------------------------------------------------------


def bcsr_matmul_ref(a_dense: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Dense A^T B in f32."""
    return a_dense.to(F32).T @ b.to(F32)


def bcsr_matmul_packed_ref(a_data: torch.Tensor, a_idx: torch.Tensor,
                           b: torch.Tensor, rows: torch.Tensor | None = None,
                           *, mb: int = 1,
                           counts: torch.Tensor | None = None) -> torch.Tensor:
    """The same product from the packed form, by gather and einsum.

    a_data : (R, J, bk, bm)    per-output-block-column padded nonzero tiles
    a_idx  : (R, J) int32      K-block index of each slot (pad -> 0 data)
    b      : (K, N) shared, or (R // mb, K, N) one per worker; any K
    rows   : live workers; output block-row g reads packed block-row
             rows[g // mb] * mb + g % mb (all R block-rows when None)
    counts : (R,) real slots per packed block-row; slots at or past it
             are masked out, whatever they hold (None: all J)
    """
    n_src, J, bk, bm = a_data.shape
    dev = a_data.device
    workers = (torch.arange(n_src // mb, device=dev) if rows is None
               else rows.long())
    src = (workers[:, None] * mb + torch.arange(mb, device=dev)).reshape(-1)
    a_data, a_idx = a_data[src], a_idx[src].long()
    if counts is not None:
        live = torch.arange(J, device=dev) < counts[src].long()[:, None]
        a_data = a_data.masked_fill(~live[:, :, None, None], 0)
        a_idx = a_idx.masked_fill(~live, 0)
    per_worker = b.ndim == 3
    bb = b if per_worker else b[None]
    pad = (-bb.shape[1]) % bk
    if pad:
        bb = torch.nn.functional.pad(bb, (0, 0, 0, pad))
    n = bb.shape[2]
    bblocks = bb.to(F32).reshape(bb.shape[0], -1, bk, n)   # (W, Kb, bk, N)
    wid = (workers.repeat_interleave(mb) if per_worker
           else torch.zeros_like(src))
    gathered = bblocks[wid[:, None], a_idx]                  # (G, J, bk, N)
    out = torch.einsum("mjkc,mjkn->mcn", a_data.to(F32), gathered)
    return out.reshape(-1, n)


# ---------------------------------------------------------------------------
# cyclic_encode: coded[i] = sum_j coef[i, j] * blocks[sup[i, j]]
# ---------------------------------------------------------------------------


def cyclic_encode_ref(blocks: torch.Tensor, sup: torch.Tensor,
                      coef: torch.Tensor) -> torch.Tensor:
    """blocks (k, T, C), sup (n, w) int, coef (n, w) -> coded (n, T, C) f32."""
    gathered = blocks[sup.long()]                            # (n, w, T, C)
    return torch.einsum("nw,nwtc->ntc", coef.to(F32), gathered.to(F32))


# ---------------------------------------------------------------------------
# decode_matmul: U = Hinv @ Y
# ---------------------------------------------------------------------------


def decode_matmul_ref(hinv: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """hinv (k, k), y (k, P) -> (k, P) in f32."""
    return hinv.to(F32) @ y.to(F32)


# ---------------------------------------------------------------------------
# Packing helper (host numpy, as in the reference)
# ---------------------------------------------------------------------------


def pack_bcsr(a_dense: np.ndarray, bk: int, bm: int,
              max_nnz: int | None = None) -> tuple[np.ndarray, np.ndarray, int]:
    """Pack a dense (K, M) matrix into per-block-column gathered form.

    Returns (a_data (Mb, J, bk, bm), a_idx (Mb, J) int32, max_nnz J).
    A block is stored iff it has any non-zero entry.  Rows are padded to
    the max nnz-block count with zero blocks pointing at K-block 0.
    """
    a = np.asarray(a_dense)
    K, M = a.shape
    if K % bk or M % bm:
        raise ValueError(f"dims must divide block size: {(K, M)} vs {(bk, bm)}")
    kb, mb = K // bk, M // bm
    blocks = a.reshape(kb, bk, mb, bm).transpose(2, 0, 1, 3)  # (mb, kb, bk, bm)
    nz = np.abs(blocks).max(axis=(2, 3)) > 0                   # (mb, kb)
    counts = nz.sum(axis=1)
    j = int(counts.max()) if max_nnz is None else max_nnz
    j = max(j, 1)
    a_data = np.zeros((mb, j, bk, bm), dtype=a.dtype)
    a_idx = np.zeros((mb, j), dtype=np.int32)
    for m in range(mb):
        ks = np.nonzero(nz[m])[0][:j]
        a_data[m, : len(ks)] = blocks[m, ks]
        a_idx[m, : len(ks)] = ks
    return a_data, a_idx, j
