"""qwen3-14b [dense]: 40L d_model=5120 40H (GQA kv=8) d_ff=17408
vocab=151936 -- qk_norm, GQA.  [hf:Qwen/Qwen3-8B family; hf]"""

from .base import AttnConfig, ModelConfig

CONFIG = ModelConfig(
    name="qwen3-14b",
    family="dense",
    n_layers=40,
    d_model=5120,
    d_ff=17408,
    vocab=151936,
    attn=AttnConfig(n_heads=40, n_kv_heads=8, head_dim=128, qk_norm=True,
                    rope_theta=1e6),
    act="swiglu",
    tie_embeddings=False,
    max_seq=131072,
    sub_quadratic=False,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen3-14b-smoke", family="dense", n_layers=2, d_model=64,
        d_ff=128, vocab=256,
        attn=AttnConfig(n_heads=4, n_kv_heads=2, head_dim=16, qk_norm=True),
        act="swiglu", tie_embeddings=False, max_seq=128)
