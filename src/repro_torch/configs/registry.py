"""--arch registry: assigned architectures (+ the paper's own edge config).

The first ten are the JAX package's table entries; ``kimi-k2-instruct``
and ``deepseek-v3.2`` are the port's own (the published Kimi-K2-Instruct
and DeepSeek-V3.2: latent attention, the latter made sparse)."""

from __future__ import annotations

import importlib

from .base import SHAPES, ModelConfig, ShapeConfig  # noqa: F401

_MODULES = {
    "qwen3-14b": "qwen3_14b",
    "phi3-medium-14b": "phi3_medium_14b",
    "gemma3-12b": "gemma3_12b",
    "phi3-mini-3.8b": "phi3_mini_3_8b",
    "zamba2-2.7b": "zamba2_2_7b",
    "mamba2-1.3b": "mamba2_1_3b",
    "whisper-tiny": "whisper_tiny",
    "phi-3-vision-4.2b": "phi3_vision_4_2b",
    "granite-moe-1b-a400m": "granite_moe_1b",
    "kimi-k2-1t-a32b": "kimi_k2_1t",
    "kimi-k2-instruct": "kimi_k2_instruct",
    "deepseek-v3.2": "deepseek_v3_2",
}

ARCH_IDS = tuple(_MODULES)


def _module(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(f"{__package__}.{_MODULES[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).smoke()


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]
