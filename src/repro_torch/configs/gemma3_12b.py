"""gemma3-12b [dense]: 48L d_model=3840 16H (GQA kv=8) d_ff=15360
vocab=262144 -- 5:1 local:global sliding-window pattern, 128k context.
[hf:google/gemma-3 family; unverified]

The 5:1 pattern makes the arch *mostly* sub-quadratic (window=1024 on
5/6 of layers); the long_500k decode cell is runnable: global layers
cost O(S) per decoded token, local layers O(W).
"""

from .base import AttnConfig, ModelConfig

CONFIG = ModelConfig(
    name="gemma3-12b",
    family="dense",
    n_layers=48,
    d_model=3840,
    d_ff=15360,
    vocab=262144,
    attn=AttnConfig(n_heads=16, n_kv_heads=8, head_dim=256, qk_norm=True,
                    rope_theta=1e6, window=1024),
    layer_pattern=("L", "L", "L", "L", "L", "G"),
    act="swiglu",
    tie_embeddings=True,
    max_seq=131072,
    sub_quadratic=True,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="gemma3-12b-smoke", family="dense", n_layers=6, d_model=64,
        d_ff=128, vocab=256,
        attn=AttnConfig(n_heads=4, n_kv_heads=2, head_dim=16, qk_norm=True,
                        window=8),
        layer_pattern=("L", "L", "G"), act="swiglu", tie_embeddings=True,
        max_seq=128, sub_quadratic=True)
