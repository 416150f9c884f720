"""phi3-medium-14b [dense]: 40L d_model=5120 40H (GQA kv=10) d_ff=17920
vocab=100352 -- RoPE SwiGLU GQA.  [arXiv:2404.14219; unverified]"""

from .base import AttnConfig, ModelConfig

CONFIG = ModelConfig(
    name="phi3-medium-14b",
    family="dense",
    n_layers=40,
    d_model=5120,
    d_ff=17920,
    vocab=100352,
    attn=AttnConfig(n_heads=40, n_kv_heads=10, head_dim=128, rope_theta=1e4),
    act="swiglu",
    tie_embeddings=False,
    max_seq=131072,
    sub_quadratic=False,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="phi3-medium-14b-smoke", family="dense", n_layers=2, d_model=64,
        d_ff=160, vocab=256,
        attn=AttnConfig(n_heads=4, n_kv_heads=2, head_dim=16, rope_theta=1e4),
        act="swiglu", tie_embeddings=False, max_seq=128)
