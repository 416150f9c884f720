"""mamba2-1.3b [ssm]: 48L d_model=2048 attention-free, ssm_state=128 --
SSD (state-space duality).  [arXiv:2405.21060; unverified]"""

from .base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    d_ff=0,
    vocab=50280,
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2),
    layer_pattern=("M",),
    act="swiglu",
    tie_embeddings=True,
    max_seq=1048576,
    sub_quadratic=True,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="mamba2-1.3b-smoke", family="ssm", n_layers=2, d_model=64,
        d_ff=0, vocab=256,
        ssm=SSMConfig(d_state=16, head_dim=16, expand=2, chunk=16),
        layer_pattern=("M",), tie_embeddings=True, max_seq=128,
        sub_quadratic=True)
