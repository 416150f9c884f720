"""Packing layer: coded block-columns -> packed block-sparse operands.

The paper's worker-cost argument (Sec. IV-C) is that a weight-omega
coded submatrix inherits the union of its omega source block-columns'
sparsity, so per-worker work is ~ omega/k_A of the dense cost.  The
worker kernel (``repro_torch.kernels.bcsr_matmul``) consumes that
structure as a *packed* form: per output block-column, only the nonzero
(bk x bm) K-tiles are stored, together with their K-block indices.

This module converts a stack of coded shards ``coded (n, t, c)`` into
one packed operand shared by every backend of the executor:

  * all workers are packed to a **common slot count J** (the max
    nonzero-tile count over block-columns) and concatenated along the
    output-block axis, so one kernel launch computes every live
    worker's product ``coded_i^T @ B`` when B is shared (matvec);
  * ``counts`` holds each block-row's real slot count on the device, so
    the ``cuda`` kernel walks only real tiles; with B given per worker,
    the matmat's k products are one launch as well;
  * ``tile_counts`` records the true nonzero-tile count per worker --
    the quantity that scales with omega.

Packing runs once per operand, with tensor ops on the shards' own
device (the card, for the ``cuda`` backend); the result is bitwise the
reference's host-numpy packing (``repro.runtime.pack``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


def _round_up(x: int, m: int) -> int:
    return x + (-x) % m


@dataclass(frozen=True)
class PackedShards:
    """Packed block-sparse form of n coded shards (see module docstring).

    a_data : (n * Mb, J, bk, bm)  nonzero tiles, zero-padded slots
    a_idx  : (n * Mb, J) int32    K-block index per slot (pad slots -> 0)
    counts : (n * Mb,) int32      real slots per packed block-row, on the
                                  shards' device (``slot_counts`` flat),
                                  so the kernel skips the pad slots
    """

    a_data: torch.Tensor
    a_idx: torch.Tensor
    counts: torch.Tensor
    n: int                 # workers
    mb: int                # output block-columns per worker (c_pad / bm)
    bk: int
    bm: int
    t: int                 # logical K dim (rows of each shard)
    c: int                 # logical M dim (cols of each shard)
    t_pad: int
    c_pad: int
    tile_counts: tuple[int, ...]   # nonzero (bk x bm) tiles per worker
    # real (un-padded) slots per (worker, output block-column); the BSR
    # export needs these to drop the zero pad tiles
    slot_counts: tuple[tuple[int, ...], ...]

    @property
    def slots(self) -> int:
        return int(self.a_idx.shape[1])

    def worker_view(self, i: int) -> tuple[torch.Tensor, torch.Tensor]:
        """(a_data, a_idx) views of worker i's block-rows (matmat path)."""
        lo, hi = i * self.mb, (i + 1) * self.mb
        return self.a_data[lo:hi], self.a_idx[lo:hi]

    def select_workers(self, rows) -> tuple[torch.Tensor, torch.Tensor]:
        """Packed operand restricted to the given workers, still fused
        along the output-block axis.  A copy: the ``cuda`` backend does
        not call it, its kernel reads the live rows in place."""
        rows = torch.as_tensor(np.asarray(rows), dtype=torch.long,
                               device=self.a_data.device)
        d = self.a_data.reshape(self.n, self.mb, -1, self.bk, self.bm)
        ix = self.a_idx.reshape(self.n, self.mb, -1)
        sel_d = d[rows].reshape(len(rows) * self.mb, -1, self.bk, self.bm)
        sel_i = ix[rows].reshape(len(rows) * self.mb, -1)
        return sel_d, sel_i


def pack_coded_blocks(coded, bk: int = 8, bm: int = 8) -> PackedShards:
    """Pack coded shards (n, t, c) into the kernel's block-sparse form.

    Pads t and c up to multiples of (bk, bm); a tile is stored iff it
    has any nonzero entry, at slots in ascending K-block order.  All
    workers share the max slot count J so they stack into one operand
    (padding slots are zero tiles pointing at K-block 0 -- they
    contribute nothing).
    """
    a = coded if isinstance(coded, torch.Tensor) else torch.as_tensor(
        np.asarray(coded))
    if a.ndim != 3:
        raise ValueError(f"coded must be (n, t, c), got {tuple(a.shape)}")
    n, t, c = a.shape
    t_pad, c_pad = _round_up(t, bk), _round_up(c, bm)
    if (t_pad, c_pad) != (t, c):
        a = torch.nn.functional.pad(a, (0, c_pad - c, 0, t_pad - t))
    kb, mb = t_pad // bk, c_pad // bm

    # (n, kb, bk, mb, bm) -> (n, mb, kb, bk, bm), a view
    blocks = a.reshape(n, kb, bk, mb, bm).permute(0, 3, 1, 2, 4)
    nz = blocks.abs().amax(dim=(3, 4)) > 0              # (n, mb, kb)
    counts = nz.sum(dim=2)                              # (n, mb)
    counts_host = counts.cpu()
    j = max(int(counts_host.max()), 1)
    # nonzero K-blocks first, each group in ascending order
    order = torch.sort((~nz).to(torch.int32), dim=2, stable=True).indices
    order = order[:, :, :j]
    valid = torch.arange(j, device=a.device) < counts[:, :, None]
    ni = torch.arange(n, device=a.device)[:, None, None]
    mi = torch.arange(mb, device=a.device)[None, :, None]
    a_data = blocks[ni, mi, order].masked_fill(~valid[..., None, None], 0)
    a_idx = torch.where(valid, order, 0).to(torch.int32)
    return PackedShards(
        a_data=a_data.reshape(n * mb, j, bk, bm).contiguous(),
        a_idx=a_idx.reshape(n * mb, j).contiguous(),
        counts=counts.reshape(n * mb).to(torch.int32).contiguous(),
        n=n, mb=mb, bk=bk, bm=bm, t=t, c=c, t_pad=t_pad, c_pad=c_pad,
        tile_counts=tuple(int(x) for x in counts_host.sum(dim=1)),
        slot_counts=tuple(tuple(int(x) for x in row)
                          for row in counts_host.tolist()),
    )


def bsr_shards(packed: PackedShards):
    """Export each worker's *transposed* shard A_i^T as a scipy BSR
    matrix (c_pad x t_pad), blocksize (bm, bk).

    The host path of the ``packed`` backend: scipy's block-CSR matmul
    walks exactly the nonzero tiles the packer kept.  Pad slots are
    dropped via ``slot_counts``.
    """
    from scipy import sparse  # noqa: PLC0415 - optional heavy dep

    n, mb, bk, bm = packed.n, packed.mb, packed.bk, packed.bm
    a_data = packed.a_data.detach().to("cpu", torch.float32).numpy()
    a_data = a_data.reshape(n, mb, -1, bk, bm)
    a_idx = packed.a_idx.cpu().numpy().reshape(n, mb, -1)
    shards = []
    for i in range(n):
        counts = packed.slot_counts[i]
        indptr = np.zeros(mb + 1, dtype=np.int64)
        np.cumsum(counts, out=indptr[1:])
        data = np.concatenate(
            [a_data[i, m, : counts[m]] for m in range(mb)], axis=0)
        # BSR blocks of A^T are the transposed tiles
        data = np.ascontiguousarray(data.transpose(0, 2, 1))
        indices = np.concatenate(
            [a_idx[i, m, : counts[m]] for m in range(mb)])
        shards.append(sparse.bsr_matrix(
            (data, indices, indptr),
            shape=(packed.c_pad, packed.t_pad), blocksize=(bm, bk)))
    return shards


def unpack_coded_blocks(packed: PackedShards) -> torch.Tensor:
    """Inverse of ``pack_coded_blocks``: the dense (n, t, c) shards.

    Round-trip identity holds because pad slots carry zero tiles, which
    add nothing where a real tile also lives at K-block 0.
    """
    n, mb, bk, bm = packed.n, packed.mb, packed.bk, packed.bm
    kb = packed.t_pad // bk
    data = packed.a_data.reshape(-1, bk, bm)
    rows = torch.arange(n * mb, device=data.device)[:, None] * kb
    target = (rows + packed.a_idx.long()).reshape(-1)
    dense = torch.zeros((n * mb * kb, bk, bm), dtype=data.dtype,
                        device=data.device)
    dense.index_add_(0, target, data)
    out = dense.reshape(n, mb, kb, bk, bm).permute(0, 2, 3, 1, 4)
    out = out.reshape(n, packed.t_pad, packed.c_pad)
    return out[:, : packed.t, : packed.c]
