"""zamba2-2.7b [hybrid]: 54L d_model=2560, Mamba2 blocks + a SHARED
attention block (32H kv=32, d_ff=10240) applied every 6th layer with
identical weights, ssm_state=64.  [arXiv:2411.15242; hf]"""

from .base import AttnConfig, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    d_ff=10240,
    vocab=32000,
    attn=AttnConfig(n_heads=32, n_kv_heads=32, head_dim=80, rope_theta=1e4),
    ssm=SSMConfig(d_state=64, head_dim=64, expand=2),
    layer_pattern=("M", "M", "M", "M", "M", "S"),
    act="swiglu",
    tie_embeddings=True,
    max_seq=1048576,
    sub_quadratic=True,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="zamba2-2.7b-smoke", family="hybrid", n_layers=6, d_model=64,
        d_ff=128, vocab=256,
        attn=AttnConfig(n_heads=4, n_kv_heads=4, head_dim=16, rope_theta=1e4),
        ssm=SSMConfig(d_state=16, head_dim=16, expand=2, chunk=16),
        layer_pattern=("M", "M", "S"), act="swiglu", tie_embeddings=True,
        max_seq=128, sub_quadratic=True)
