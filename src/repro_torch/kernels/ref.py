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
    if n == 1:
        # on the card a one-column product is a GEMV, which sums each
        # output's terms as a tree; a zero second column keeps the GEMM,
        # which sums them in order, as the kernel does at every N
        # (scripts/order_probe.py)
        bb = torch.nn.functional.pad(bb, (0, 1))
    bblocks = bb.to(F32).reshape(bb.shape[0], -1, bk, bb.shape[2])
    wid = (workers.repeat_interleave(mb) if per_worker
           else torch.zeros_like(src))
    gathered = bblocks[wid[:, None], a_idx]              # (G, J, bk, N')
    out = torch.einsum("mjkc,mjkn->mcn", a_data.to(F32), gathered)
    return out[..., :n].contiguous().view(-1, n)


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


def decode_matmul_ref(hinv: torch.Tensor, y: torch.Tensor, mode: str = "flat",
                      *, rows: torch.Tensor | None = None, c: int | None = None,
                      r: int | None = None, w: int | None = None,
                      kb: int = 1) -> torch.Tensor:
    """U = Hinv @ Y in f32, then rearranged into the caller's layout.

    flat   : y (k, P) -> U (k, P)
    mv     : y (k, c_pad, b), the products of k workers for b requests
             -> (b, r): out[q, i*c + col] = U[i, col, q], col < c
    mm     : y (k, c_pad, cb), unknown i = ia*kb + ib
             -> (r, w): out[ia*c + col_a, ib*cb + col_b] = U[i, col_a, col_b]
    gather : y (n, *lead, c), the live results rows[j] of n
             -> (*lead, r) in y's dtype: out[..., i*c + col] = U[i, ..., col]

    Columns past c (the pad of c_pad) are dropped before the product.
    """
    k = hinv.shape[0]
    if mode == "flat":
        return hinv.to(F32) @ y.to(F32)
    if mode == "gather":
        ysub = y[rows.long()]
        u = hinv.to(F32) @ ysub.reshape(k, -1).to(F32)
        u = torch.movedim(u.reshape(ysub.shape), 0, -2)
        u = u.reshape(u.shape[:-2] + (-1,))[..., :r]
        return u.to(y.dtype).contiguous()
    ysub = y[:, :c]
    u = (hinv.to(F32) @ ysub.reshape(k, -1).to(F32)).reshape(ysub.shape)
    if mode == "mv":
        return u.permute(2, 0, 1).reshape(y.shape[2], -1)[:, :r].contiguous()
    if mode == "mm":
        cb = y.shape[2]
        u = u.reshape(k // kb, kb, c, cb).permute(0, 2, 1, 3)
        return u.reshape(k // kb * c, kb * cb)[:r, :w].contiguous()
    raise ValueError(f"unknown decode mode {mode!r}")


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
