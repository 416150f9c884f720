"""granite-moe-1b-a400m [moe]: 24L d_model=1024 16H (GQA kv=8)
d_expert=512, MoE 32 experts top-8, vocab=49155.
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]"""

from .base import AttnConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    d_ff=512,
    vocab=49155,
    attn=AttnConfig(n_heads=16, n_kv_heads=8, head_dim=64, rope_theta=1e4),
    moe=MoEConfig(n_experts=32, top_k=8, d_expert=512),
    act="swiglu",
    tie_embeddings=True,
    max_seq=131072,
    sub_quadratic=False,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-1b-a400m-smoke", family="moe", n_layers=2,
        d_model=64, d_ff=32, vocab=256,
        attn=AttnConfig(n_heads=4, n_kv_heads=2, head_dim=16, rope_theta=1e4),
        moe=MoEConfig(n_experts=8, top_k=2, d_expert=32, capacity_factor=8.0),
        act="swiglu", tie_embeddings=True, max_seq=128)
