"""Gradient compression for bandwidth-bound data parallelism.

The port of ``repro.optim.compress``, over dicts of name -> tensor:

  * int8 quantized gradient exchange with per-tensor scale -- 4x
    all-reduce bytes reduction; combined with error feedback (EF-SGD,
    Karimireddy et al. 2019) the quantization error is re-injected next
    step so convergence is preserved.
  * top-k sparsification with error feedback -- for extreme ratios; the
    sparse residual connects directly to the paper's theme (transmit
    fewer non-zeros).

``torch.round`` rounds half to even, as ``jnp.round`` does, and the
top-k threshold is the k-th largest magnitude, kept with ``>=``, so a
compressed gradient is the reference's bit for bit on the same input.
On one device the round trip runs without an all-reduce.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class CompressionConfig:
    mode: str = "none"               # none | int8 | topk
    topk_ratio: float = 0.01
    error_feedback: bool = True


def quantize_int8(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    scale = torch.max(torch.abs(g)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def topk_mask(g: torch.Tensor, ratio: float) -> torch.Tensor:
    flat = torch.abs(g.reshape(-1))
    k = max(1, int(flat.shape[0] * ratio))
    thresh = torch.topk(flat, k).values[-1]
    return (torch.abs(g) >= thresh).to(g.dtype)


def compress_tree(cfg: CompressionConfig, grads: dict, residual):
    """Apply compression with error feedback.

    Returns (compressed_grads_for_allreduce, new_residual).  The
    compressed grads are already dequantized (value-compressed) so the
    caller's all-reduce stays dtype-uniform.
    """
    if cfg.mode == "none":
        return grads, residual

    def one(g, r):
        gf = g.to(torch.float32) + (r if r is not None else 0.0)
        if cfg.mode == "int8":
            q, s = quantize_int8(gf)
            out = dequantize_int8(q, s)
        elif cfg.mode == "topk":
            out = gf * topk_mask(gf, cfg.topk_ratio)
        else:
            raise ValueError(cfg.mode)
        new_r = (gf - out) if cfg.error_feedback else torch.zeros_like(gf)
        return out.to(g.dtype), new_r

    outs = {name: one(g, residual[name] if residual is not None else None)
            for name, g in grads.items()}
    return ({name: o[0] for name, o in outs.items()},
            {name: o[1] for name, o in outs.items()})


def init_residual(cfg: CompressionConfig, params: dict):
    if cfg.mode == "none" or not cfg.error_feedback:
        return None
    return {name: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for name, p in params.items()}
