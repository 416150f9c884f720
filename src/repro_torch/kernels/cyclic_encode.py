"""Weight-omega encode: coded[i] = sum_{j<w} coef[i, j] * blocks[sup[i, j]].

Replaces the TPU kernel ``src/repro/kernels/cyclic_encode.py::
cyclic_encode`` (Pallas body ``_cyclic_encode_kernel``): the edge
server's encoding step (Alg. 1 line 10, Alg. 2 lines 13-14), which reads
only the omega source block-columns that feed each coded shard.

What bounds it on an H100: bytes.  It does w multiply-adds per output
element and moves at least 4 bytes for each, so HBM, never the FFMA
rate, is the limit: the sources read once plus the f32 shards written
once, over the memory rate.

What the design does about it (``csrc/cyclic_encode.cu``): one block
owns a chunk of the (T, C) plane for all n shards.  It copies that chunk
of all k sources into shared memory once, then writes every shard's
chunk from there, summing the w slots in f32 registers and storing once.
So a source that feeds several shards is read from device memory once,
not once per shard.  The sources are read in place through their
strides, so ``split_block_columns``' view of A or B is never copied;
16-byte loads where the view's rows are 16-byte aligned, single
elements otherwise.  bf16 sources are upcast on load; the output is
f32, as in the reference, and the cast back to the operand's dtype stays
outside.
"""

from __future__ import annotations

import torch

from . import _build
from .ref import cyclic_encode_ref

_THREADS = 256
# the sources' chunk is sized to leave room for a second block on the SM;
# past that, one block may take all of an SM's shared memory
_SOFT_SMEM = 96 * 1024
_MAX_SMEM = 232448


def cyclic_encode_plain(blocks: torch.Tensor, sup: torch.Tensor,
                        coef: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch (same arguments)."""
    return cyclic_encode_ref(blocks, sup, coef)


def _smem(k: int, n: int, w: int, esize: int, elems: int) -> int:
    sources = k * _THREADS * elems * esize
    return sources + (-sources) % 16 + n * w * 8


def _chunk_elems(k: int, n: int, w: int, esize: int) -> int:
    """Elements per thread: the largest chunk of the plane whose k
    sources fit in shared memory."""
    for elems in (4, 2, 1):
        if _smem(k, n, w, esize, elems) <= _SOFT_SMEM:
            return elems
    if _smem(k, n, w, esize, 1) <= _MAX_SMEM:
        return 1
    limit = (_MAX_SMEM - n * w * 8) // (_THREADS * esize)
    raise ValueError(
        f"cyclic_encode: k={k} sources of {_THREADS} elements and an "
        f"({n}, {w}) support table exceed the kernel's {_MAX_SMEM} bytes "
        f"of shared memory (at most k={limit} here)")


def cyclic_encode(blocks: torch.Tensor, sup: torch.Tensor,
                  coef: torch.Tensor) -> torch.Tensor:
    """Encode stacked block-columns.

    blocks : (k, T, C) f32/bf16  source block-columns; any strides with a
             unit-stride last dimension (``split_block_columns``' view)
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
    if blocks.shape[2] > 1 and blocks.stride(2) != 1:
        raise ValueError("blocks' last dimension must be unit-stride")
    _build.require(sup, "sup", dev, torch.int32)
    _build.require(coef, "coef", dev, torch.float32)
    if dev.type == "cpu":
        return cyclic_encode_plain(blocks, sup, coef)
    if dev.type != "cuda":
        raise ValueError(f"cyclic_encode: unsupported device {dev}")
    k, t, c = blocks.shape
    n, w = sup.shape
    if t * c >= 2**31:
        raise ValueError(f"cyclic_encode: a ({t}, {c}) plane exceeds the "
                         f"kernel's 2^31 elements")
    out = torch.empty((n, t, c), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    if w == 0:
        return out.zero_()
    elems = _chunk_elems(k, n, w, blocks.element_size())
    err = _build.library().repro_cyclic_encode(
        blocks.data_ptr(), code, blocks.stride(0), blocks.stride(1),
        sup.data_ptr(), coef.data_ptr(), out.data_ptr(), k, t, c, n, w,
        elems, dev.index, _build.stream_ptr(dev))
    _build.check(err, "cyclic_encode")
    cyclic_encode.launches += 1
    return out


cyclic_encode.launches = 0
