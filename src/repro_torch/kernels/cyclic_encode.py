"""Weight-omega encode: coded[i] = sum_{j<w} coef[i, j] * blocks[sup[i, j]].

Replaces the TPU kernel ``src/repro/kernels/cyclic_encode.py::
cyclic_encode`` (Pallas body ``_cyclic_encode_kernel``): the edge
server's encoding step (Alg. 1 line 10, Alg. 2 lines 13-14), which reads
only the omega source block-columns that feed each coded shard.

What bounds it on an H100: bytes.  It does w multiply-adds per output
element and moves at least 4 bytes for each, so HBM, never the FFMA
rate, is the limit: the sources read once plus the f32 shards written
once, over the memory rate.  (A source that feeds several shards is
re-read for each of them, from L2 when it is still there.)

What the design does about it (``csrc/cyclic_encode.cu``): one thread
owns a few elements of one shard, spaced so that a warp's loads and
stores are coalesced; it sums the w slots in f32 registers and stores
once.  The Pallas grid instead re-writes its output tile on every slot,
which on this card would cost w extra read-modify-writes of the whole
output.  bf16 sources are upcast on load; the output is f32, as in the
reference, and the cast back to the operand's dtype stays outside.
"""

from __future__ import annotations

import torch

from . import _build
from .ref import cyclic_encode_ref


def cyclic_encode_plain(blocks: torch.Tensor, sup: torch.Tensor,
                        coef: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch (same arguments)."""
    return cyclic_encode_ref(blocks, sup, coef)


def cyclic_encode(blocks: torch.Tensor, sup: torch.Tensor,
                  coef: torch.Tensor) -> torch.Tensor:
    """Encode stacked block-columns.

    blocks : (k, T, C) f32/bf16  source block-columns
    sup    : (n, w) int32        support table (Alg. 1 / Alg. 2)
    coef   : (n, w) f32          coefficients on the support
    Returns coded : (n, T, C) float32.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel or raises.
    """
    if blocks.ndim != 3 or sup.ndim != 2 or coef.shape != sup.shape:
        raise ValueError(f"bad shapes blocks {tuple(blocks.shape)}, "
                         f"sup {tuple(sup.shape)}, coef {tuple(coef.shape)}")
    dev = blocks.device
    code = _build.dtype_code(blocks, "blocks")
    _build.require(blocks, "blocks", dev)
    _build.require(sup, "sup", dev, torch.int32)
    _build.require(coef, "coef", dev, torch.float32)
    if dev.type == "cpu":
        return cyclic_encode_plain(blocks, sup, coef)
    if dev.type != "cuda":
        raise ValueError(f"cyclic_encode: unsupported device {dev}")
    k, t, c = blocks.shape
    n, w = sup.shape
    if n > 65535:
        raise ValueError(f"cyclic_encode: n={n} shards exceed the grid")
    out = torch.empty((n, t, c), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.repro_cyclic_encode(
            blocks.data_ptr(), code, sup.data_ptr(), coef.data_ptr(),
            out.data_ptr(), k, t * c, n, w, _build.stream_ptr(dev))
    _build.check(err, "cyclic_encode")
    cyclic_encode.launches += 1
    return out


cyclic_encode.launches = 0
