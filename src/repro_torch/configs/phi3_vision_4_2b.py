"""phi-3-vision-4.2b [vlm]: phi3-mini backbone (32L d_model=3072 32H
d_ff=8192 vocab=32064) + CLIP frontend STUB: input_specs provides 256
precomputed patch embeddings prepended to the text sequence.
[hf:microsoft/Phi-3-vision-128k-instruct; hf]"""

from .base import AttnConfig, ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b",
    family="vlm",
    n_layers=32,
    d_model=3072,
    d_ff=8192,
    vocab=32064,
    attn=AttnConfig(n_heads=32, n_kv_heads=32, head_dim=96, rope_theta=1e4),
    vision_tokens=256,
    act="swiglu",
    tie_embeddings=False,
    max_seq=131072,
    sub_quadratic=False,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="phi-3-vision-4.2b-smoke", family="vlm", n_layers=2, d_model=64,
        d_ff=128, vocab=256,
        attn=AttnConfig(n_heads=4, n_kv_heads=4, head_dim=16, rope_theta=1e4),
        vision_tokens=8, act="swiglu", tie_embeddings=False, max_seq=128)
