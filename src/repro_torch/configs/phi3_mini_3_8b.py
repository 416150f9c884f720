"""phi3-mini-3.8b [dense]: 32L d_model=3072 32H (GQA kv=32, i.e. MHA)
d_ff=8192 vocab=32064 -- RoPE SwiGLU.  [arXiv:2404.14219; unverified]"""

from .base import AttnConfig, ModelConfig

CONFIG = ModelConfig(
    name="phi3-mini-3.8b",
    family="dense",
    n_layers=32,
    d_model=3072,
    d_ff=8192,
    vocab=32064,
    attn=AttnConfig(n_heads=32, n_kv_heads=32, head_dim=96, rope_theta=1e4),
    act="swiglu",
    tie_embeddings=False,
    max_seq=131072,
    sub_quadratic=False,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="phi3-mini-3.8b-smoke", family="dense", n_layers=2, d_model=64,
        d_ff=128, vocab=256,
        attn=AttnConfig(n_heads=4, n_kv_heads=4, head_dim=16, rope_theta=1e4),
        act="swiglu", tie_embeddings=False, max_seq=128)
