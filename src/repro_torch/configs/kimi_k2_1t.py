"""kimi-k2-1t-a32b [moe]: 61L d_model=7168 64H (GQA kv=8), MoE 384
experts top-8 with d_expert=2048, vocab=163840 -- trillion-parameter
MoE (paper-table entry).  [arXiv:2501.kimi2; unverified]

Scale notes: ~1.04e12 total params, ~32B active.  Requires expert
parallelism + fully-sharded optimizer state (see parallel/sharding.py);
the dry-run proves the sharded train step compiles on 256/512 chips.
"""

from .base import AttnConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    d_ff=2048,
    vocab=163840,
    attn=AttnConfig(n_heads=64, n_kv_heads=8, head_dim=128, rope_theta=1e6),
    moe=MoEConfig(n_experts=384, top_k=8, d_expert=2048),
    act="swiglu",
    tie_embeddings=False,
    max_seq=131072,
    sub_quadratic=False,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="kimi-k2-1t-a32b-smoke", family="moe", n_layers=2, d_model=64,
        d_ff=32, vocab=256,
        attn=AttnConfig(n_heads=4, n_kv_heads=2, head_dim=16, rope_theta=1e6),
        moe=MoEConfig(n_experts=8, top_k=2, d_expert=32, capacity_factor=8.0),
        act="swiglu", tie_embeddings=False, max_seq=128)
