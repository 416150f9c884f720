"""The benchmark's yardstick: the card's peaks and what a call needs.

Everything here is counted from the inputs the benchmark made, never
from the program's own state, so a count holds whatever implements the
call.  The peaks are NVIDIA's data sheet for one H100 SXM (dense rates,
no sparsity), at its full 700 W power limit; the run prints the card's
actual limit beside every share.  The per-kernel byte and operation
arithmetic follows ``bcsr_bytes`` / ``bcsr_flops`` / ``bound`` of
``chip_smoke.py`` (copied, so a later change to the program cannot move
the yardstick).
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12          # FFMA, outside the tensor cores
BF16_FLOPS_PER_S = 989e12        # dense bf16 tensor cores: the card's peak
PEAK_FLOPS_PER_S = BF16_FLOPS_PER_S


def peak_flops_per_s(dtype) -> float:
    """The card's dense rate for products of ``dtype`` operands: the
    tensor cores' for bf16 and f16, FFMA's for anything wider."""
    import torch
    return BF16_FLOPS_PER_S if dtype in (torch.bfloat16, torch.float16) \
        else F32_FLOPS_PER_S


def bound_s(nbytes: float, flops: float, flops_per_s: float
            ) -> tuple[float, str]:
    """The least time the work needs on one card, and which term sets it."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / flops_per_s
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def decode_bytes(k: int, rows: int, cols: int, itemsize: int = 4) -> float:
    """``decode_matmul``'s least bytes: the k live products read once and
    the k unknowns written once."""
    return float(2 * k * rows * cols * itemsize)


def bcsr_bytes(packed, workers, b_shape, b_itemsize: int, per_worker: bool,
               n_out_rows: int) -> float:
    """``bcsr_matmul``'s least bytes (chip_smoke ``bcsr_bytes``): the live
    workers' nonzero tiles, their slot indices and counts, the B rows
    those tiles select (per worker when B is per worker, else their
    union), C written once.  Reads the packed shards' layout, so it is a
    per-kernel diagnostic and not an end-to-end yardstick."""
    tiles = sum(packed.tile_counts[int(i)] for i in workers)
    esz = packed.a_data.element_size()
    idx = packed.a_idx.view(packed.n, packed.mb, -1).cpu().numpy()
    kblocks = [set() for _ in workers] if per_worker else [set()]
    for j, i in enumerate(workers):
        seen = kblocks[j if per_worker else 0]
        for m, cnt in enumerate(packed.slot_counts[int(i)]):
            seen.update(idx[int(i), m, :cnt].tolist())
    k_dim, n_dim = b_shape[-2:]
    b_rows = sum(min(len(s) * packed.bk, k_dim) for s in kblocks)
    return float(tiles * packed.bk * packed.bm * esz
                 + tiles * 4 + len(workers) * packed.mb * 4
                 + b_rows * n_dim * b_itemsize
                 + n_out_rows * n_dim * 4)


def bcsr_flops(packed, workers, n_cols: int) -> float:
    tiles = sum(packed.tile_counts[int(i)] for i in workers)
    return 2.0 * tiles * packed.bk * packed.bm * n_cols
