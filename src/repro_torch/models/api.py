"""Public model API: ``build_model`` + per-(arch, shape) input specs.

``*_specs`` describe every step-function input as tensors on the
``meta`` device: shapes and dtypes, nothing allocated (the reference's
``jax.ShapeDtypeStruct``).
"""

from __future__ import annotations

import torch

from ..configs.base import ModelConfig, ShapeConfig
from .transformer import TransformerLM
from .whisper import WhisperLM


def build_model(cfg: ModelConfig, dtype=torch.bfloat16, device=None
                ) -> TransformerLM | WhisperLM:
    """The model of ``cfg`` with its weights allocated (not drawn: call
    ``init``) on ``device``, by default the card: ``WhisperLM`` for the
    audio family, ``TransformerLM`` for every other."""
    if cfg.family == "audio":
        return WhisperLM(cfg, dtype=dtype, device=device)
    return TransformerLM(cfg, dtype=dtype, device=device)


def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def train_batch_specs(cfg: ModelConfig, shape: ShapeConfig,
                      dtype=torch.bfloat16) -> dict:
    b, s = shape.global_batch, shape.seq_len
    if cfg.family == "audio":
        return {
            "frames": _sds((b, cfg.encoder.n_frames, cfg.d_model), dtype),
            "tokens": _sds((b, s), torch.int32),
            "labels": _sds((b, s), torch.int32),
        }
    if cfg.family == "vlm":
        v = cfg.vision_tokens
        return {
            "image_embeds": _sds((b, v, cfg.d_model), dtype),
            "tokens": _sds((b, s - v), torch.int32),
            "labels": _sds((b, s - v), torch.int32),
        }
    return {
        "tokens": _sds((b, s), torch.int32),
        "labels": _sds((b, s), torch.int32),
    }


def prefill_specs(cfg: ModelConfig, shape: ShapeConfig,
                  dtype=torch.bfloat16) -> dict:
    b, s = shape.global_batch, shape.seq_len
    out = {"tokens": _sds((b, s if cfg.family != "vlm"
                           else s - cfg.vision_tokens), torch.int32)}
    if cfg.family == "audio":
        out["frames"] = _sds((b, cfg.encoder.n_frames, cfg.d_model), dtype)
    if cfg.family == "vlm":
        out["image_embeds"] = _sds((b, cfg.vision_tokens, cfg.d_model), dtype)
    return out


def decode_specs(cfg: ModelConfig, shape: ShapeConfig,
                 dtype=torch.bfloat16) -> dict:
    """Specs for decode_step: a cache filled to seq_len plus one token."""
    b, s = shape.global_batch, shape.seq_len
    model = build_model(cfg, dtype, device="meta")
    return {"cache": model.init_cache(b, s),
            "tokens": _sds((b, 1), torch.int32)}


def supports_shape(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Whether the (arch, shape) cell is runnable; reason if not.

    long_500k requires sub-quadratic attention (SSM / hybrid / mostly-
    local); pure full-attention archs skip it per the assignment.
    """
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "pure full-attention arch: long_500k skipped (quadratic)"
    return True, ""
