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
                           b: torch.Tensor) -> torch.Tensor:
    """The same product from the packed form, by gather and einsum.

    a_data : (Mb, J, bk, bm)   per-output-block-column padded nonzero tiles
    a_idx  : (Mb, J) int32     K-block index of each slot (pad -> 0 data)
    b      : (K, N), K a multiple of bk
    """
    mb, _, bk, bm = a_data.shape
    n = b.shape[1]
    bblocks = b.to(F32).reshape(-1, bk, n)                  # (Kb, bk, N)
    gathered = bblocks[a_idx.long()]                         # (Mb, J, bk, N)
    out = torch.einsum("mjkc,mjkn->mcn", a_data.to(F32), gathered)
    return out.reshape(mb * bm, n)


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
