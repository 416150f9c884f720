"""Fastest-k decode: U = Hinv @ Y.

Replaces the TPU kernel ``src/repro/kernels/decode_matmul.py::
decode_matmul`` (Pallas body ``_decode_kernel``): the server-side decode,
a small (k x k) inverse, precomputed on the host per straggler pattern,
applied to the wide result matrix Y (k x P).

What bounds it on an H100: bytes, and at the main path's sizes the
launch itself.  It does 2k flops per Y element it reads (k = 14 for the
LM head, 16 for Fig. 4), under the ~20 flops per byte where FFMA would
be the limit; Y and U are a few MB for the LM head's matvec, which HBM
moves in about a microsecond, less than a launch costs.

What the design does about it (``csrc/decode_matmul.cu``): Hinv sits in
shared memory once per block; each thread loads one column of Y into
registers and writes that column of U, so Y is read once and U written
once, coalesced, in f32 IEEE FFMA.  k up to 64.
"""

from __future__ import annotations

import torch

from . import _build
from .ref import decode_matmul_ref

MAX_K = 64


def decode_matmul_plain(hinv: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch (same arguments)."""
    return decode_matmul_ref(hinv, y)


def decode_matmul(hinv: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """hinv (k, k) f32, y (k, P) f32/bf16 -> U (k, P) f32.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel or raises.
    """
    if y.ndim != 2 or hinv.shape != (y.shape[0], y.shape[0]):
        raise ValueError(f"hinv {tuple(hinv.shape)} incompatible with "
                         f"y {tuple(y.shape)}")
    dev = y.device
    code = _build.dtype_code(y, "y")
    _build.require(hinv, "hinv", dev, torch.float32)
    _build.require(y, "y", dev)
    if dev.type == "cpu":
        return decode_matmul_plain(hinv, y)
    if dev.type != "cuda":
        raise ValueError(f"decode_matmul: unsupported device {dev}")
    k, p = y.shape
    if k > MAX_K:
        raise ValueError(f"decode_matmul: k={k} above the kernel's {MAX_K}")
    out = torch.empty((k, p), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.repro_decode_matmul(hinv.data_ptr(), y.data_ptr(), code,
                                      out.data_ptr(), k, p,
                                      _build.stream_ptr(dev))
    _build.check(err, "decode_matmul")
    decode_matmul.launches += 1
    return out


decode_matmul.launches = 0
