"""Fastest-k decode: U = Hinv @ Y, stored in the caller's layout.

Replaces the TPU kernel ``src/repro/kernels/decode_matmul.py::
decode_matmul`` (Pallas body ``_decode_kernel``): the server-side decode,
a small (k x k) inverse, precomputed on the host per straggler pattern,
applied to the wide result matrix Y (k x P).

What bounds it on an H100: bytes, and at the main path's sizes the
launch itself.  It does 2k flops per Y element it reads (k = 14 for the
LM head, 16 for Fig. 4), under the ~20 flops per byte where FFMA would
be the limit; Y and U are a few MB for the LM head's matvec, which HBM
moves in about a microsecond, less than a launch costs.

What the design does about it (``csrc/decode_matmul.cu``):

  * the kernel stores each unknown straight into the layout its caller
    returns (``mode``), so no rearranging copy follows it, and it never
    decodes Y's pad columns;
  * ``mode="gather"`` reads the live workers' results in place through
    ``rows``, as ``bcsr_matmul`` does, and stores in y's dtype;
  * Hinv sits in shared memory; where Y and the output share their
    unit-stride axis (flat, mm, gather) each thread loads and stores
    vectors of neighbouring columns; in mv, where Y's unit-stride axis is
    the request and the output's the column, a block stages a tile of Y
    in shared memory with 16-byte loads and stores along the columns;
  * f32 IEEE FFMA in j order, k up to 64, no FMA on padding;
  * the launch is thin: the C launcher makes the device current itself,
    and the checks are shape arithmetic on the host.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import _build
from .ref import decode_matmul_ref

MAX_K = 64
MODES = ("flat", "mv", "mm", "gather")


def decode_matmul_plain(hinv: torch.Tensor, y: torch.Tensor,
                        mode: str = "flat", *,
                        rows: torch.Tensor | None = None,
                        c: int | None = None, r: int | None = None,
                        w: int | None = None, kb: int = 1) -> torch.Tensor:
    """The kernel's function in plain PyTorch (same arguments)."""
    return decode_matmul_ref(hinv, y, mode, rows=rows, c=c, r=r, w=w, kb=kb)


def _bad(mode, hinv, y, why: str) -> ValueError:
    return ValueError(f"decode_matmul({mode}): {why} (hinv "
                      f"{tuple(hinv.shape)}, y {tuple(y.shape)})")


def _within(name: str, v, hi: int, mode, hinv, y) -> None:
    if v is None or not 0 <= v <= hi:
        raise _bad(mode, hinv, y, f"{name}={v!r} outside [0, {hi}]")


def _layout(hinv, y, mode, rows, c, r, w, kb):
    """Check a call's shapes and map it onto the kernel's scalars:
    (out_shape, kb, Q, C, s_w, s_q, s_p, ldo, row_lim, col_lim)."""
    k = hinv.shape[0]
    if hinv.ndim != 2 or hinv.shape[1] != k:
        raise _bad(mode, hinv, y, "hinv must be square")
    if mode == "flat":
        if y.ndim != 2 or y.shape[0] != k:
            raise _bad(mode, hinv, y, "y must be (k, P)")
        p = y.shape[1]
        return (k, p), k, 1, p, p, 0, 1, k * p, 1, k * p
    if mode == "gather":
        if y.ndim < 2 or rows is None or rows.shape != (k,):
            raise _bad(mode, hinv, y, "y must be (n, ..., c) and rows (k,)")
        cw = y.shape[-1]
        _within("r", r, k * cw, mode, hinv, y)
        try:
            y3 = y.view(y.shape[0], -1, cw)
        except RuntimeError as err:
            raise _bad(mode, hinv, y, "y's middle axes must merge into "
                       "one stride") from err
        if cw > 1 and y3.stride(2) != 1:
            raise _bad(mode, hinv, y, "y's last axis must have stride 1")
        lead = y3.shape[1]
        return ((*y.shape[1:-1], r), k, lead, cw, y3.stride(0),
                y3.stride(1), 1, r, lead, r)
    if mode not in MODES:
        raise ValueError(f"unknown decode mode {mode!r}; choose from {MODES}")
    if y.ndim != 3 or y.shape[0] != k:
        raise _bad(mode, hinv, y, "y must be (k, c_pad, b | cb)")
    c_pad, inner = y.shape[1], y.shape[2]
    _within("c", c, c_pad, mode, hinv, y)
    if mode == "mv":
        _within("r", r, k * c, mode, hinv, y)
        return (inner, r), k, inner, c, c_pad * inner, 1, inner, r, inner, r
    if not isinstance(kb, int) or kb < 1 or k % kb:
        raise _bad(mode, hinv, y, f"kb={kb!r} does not divide k={k}")
    _within("r", r, k // kb * c, mode, hinv, y)
    _within("w", w, kb * inner, mode, hinv, y)
    return (r, w), kb, c, inner, c_pad * inner, inner, 1, w, r, w


class DecodeLayout(NamedTuple):
    """What a decode call's shapes, strides, dtypes and scalars decide,
    checked: the result as an expanded one-element tensor of its shape,
    dtype and device (``torch.empty_like`` of it allocates the result in
    less host time than ``torch.empty``), whether it is empty, and the C
    launcher's geometry (13 int64, kept alive here) with its address."""

    like: torch.Tensor
    empty: bool
    geometry: ctypes.Array
    address: int
    device: int


_Geometry = ctypes.c_longlong * 13


def prepare_decode(hinv: torch.Tensor, y: torch.Tensor, mode: str = "flat",
                   *, rows: torch.Tensor | None = None, c: int | None = None,
                   r: int | None = None, w: int | None = None,
                   kb: int = 1) -> DecodeLayout:
    """Check a decode call (the arguments of ``decode_matmul``) once.

    ``launch_decode(layout, ...)`` then runs calls of the same layout
    without checking them again: the executor keeps the layouts its
    calls repeat (one per output mode and shape), as its decode plans
    always hold an f32 inverse and int32 rows on its device.
    """
    shape, *geom = _layout(hinv, y, mode, rows, c, r, w, kb)
    code = _build.dtype_code(y, "y")
    dev = y.device
    _build.require(hinv, "hinv", dev, torch.float32)
    if mode == "gather":
        _build.require(rows, "rows", dev, torch.int32)
    elif not y.is_contiguous():
        raise ValueError("y must be contiguous")
    k = hinv.shape[0]
    if dev.type == "cuda" and k > MAX_K:
        raise ValueError(f"decode_matmul: k={k} above the kernel's {MAX_K}")
    out_dtype = y.dtype if mode == "gather" else torch.float32
    arr = _Geometry(code, _build.dtype_code(out_dtype, "out"), k, *geom,
                    dev.index or 0)
    like = torch.empty((), dtype=out_dtype, device=dev).expand(shape)
    return DecodeLayout(like, like.numel() == 0, arr, ctypes.addressof(arr),
                        dev.index or 0)


def launch_decode(layout: DecodeLayout, hinv: torch.Tensor, y: torch.Tensor,
                  rows: torch.Tensor | None = None) -> torch.Tensor:
    """Launch the kernel on CUDA tensors of a layout ``prepare_decode``
    checked: hinv, y and rows (gather) must be that call's tensors or have
    the same shapes, strides, dtypes and device."""
    out = torch.empty_like(layout.like)
    if layout.empty:
        return out
    # the launcher makes the device current itself, only when it is not
    err = _build.library().repro_decode_matmul(
        hinv.data_ptr(), y.data_ptr(),
        None if rows is None else rows.data_ptr(), out.data_ptr(),
        layout.address, _build.raw_stream(layout.device))
    if err:
        _build.check(err, "decode_matmul")
    _build.count_launch(decode_matmul)
    return out


def decode_matmul(hinv: torch.Tensor, y: torch.Tensor, mode: str = "flat",
                  *, rows: torch.Tensor | None = None, c: int | None = None,
                  r: int | None = None, w: int | None = None,
                  kb: int = 1) -> torch.Tensor:
    """U = Hinv @ Y with hinv (k, k) f32, stored as ``mode`` says:

    flat   : y (k, P) f32/bf16 -> U (k, P) f32
    mv     : y (k, c_pad, b), ``bcsr_matmul``'s output for b requests;
             c <= c_pad real columns per worker, r <= k*c outputs
             -> (b, r) f32, out[q, i*c + col] = U[i, col, q]
    mm     : y (k, c_pad, cb), unknown i = ia*kb + ib; c real rows per
             unknown, r <= (k/kb)*c, w <= kb*cb
             -> (r, w) f32,
             out[ia*c + col_a, ib*cb + col_b] = U[i, col_a, col_b]
    gather : y (n, *lead, c) with unit stride along c and the lead axes
             merging into one stride; rows (k,) int32, the live workers'
             indices (< n, not checked on the card); r <= k*c
             -> (*lead, r) in y's dtype, out[..., i*c + col] = U[i, ..., col]

    Every result is a new contiguous tensor.  A CPU tensor takes the
    plain version; a CUDA tensor launches the kernel or raises.  Calls
    that repeat one layout can check it once instead: ``prepare_decode``
    and ``launch_decode``.
    """
    layout = prepare_decode(hinv, y, mode, rows=rows, c=c, r=r, w=w, kb=kb)
    dev = y.device
    if dev.type == "cpu":
        return decode_matmul_plain(hinv, y, mode, rows=rows, c=c, r=r, w=w,
                                   kb=kb)
    if dev.type != "cuda":
        raise ValueError(f"decode_matmul: unsupported device {dev}")
    return launch_decode(layout, hinv, y, rows if mode == "gather" else None)


decode_matmul.launches = 0
