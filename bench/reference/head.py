"""Logits ``x @ head``, what the coded LM head must return, in float64.

``Logits`` holds the head as served (its bf16 values, widened exactly)
and gives each call's float64 logits of f32 hidden rows.  ``control``
is the product in fp8 (e4m3, one scale per tensor), one precision step
below the bf16 the configuration states: the step a later change might
take to serve the head on fp8 tensor cores.
"""

from __future__ import annotations

import torch

FP8 = torch.float8_e4m3fn
FP8_MAX = 448.0


class Logits:
    """The reference over one head; the float64 copy is made once."""

    def __init__(self, head: torch.Tensor):
        self.head64 = head.double()

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """(rows, vocab) float64 logits of hidden rows ``x``."""
        return x.to(self.head64.device, torch.float64) @ self.head64


def to_fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded through e4m3 with one per-tensor scale, back in f32."""
    scale = t.float().abs().max().clamp_min(1e-30) / FP8_MAX
    return (t.float() / scale).to(FP8).float() * scale


class Control:
    """The logits with both operands in fp8, summed in float32 (TF32
    off); the head is rounded once."""

    def __init__(self, head: torch.Tensor):
        self.head8 = to_fp8(head)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        old = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            return to_fp8(x.to(self.head8.device)) @ self.head8
        finally:
            torch.backends.cuda.matmul.allow_tf32 = old


def rel_err(out: torch.Tensor, ref: torch.Tensor) -> float:
    """max |out - ref| / max |ref| over the whole call."""
    diff = (out.to(ref.device, torch.float64) - ref).abs().max()
    return float(diff / ref.abs().max())
