"""whisper-tiny [audio]: 4L enc + 4L dec, d_model=384 6H d_ff=1536
vocab=51865 -- encoder-decoder; conv frontend is a STUB (input_specs
provides precomputed frame embeddings).  [arXiv:2212.04356; unverified]"""

from .base import AttnConfig, EncoderConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="audio",
    n_layers=4,
    d_model=384,
    d_ff=1536,
    vocab=51865,
    attn=AttnConfig(n_heads=6, n_kv_heads=6, head_dim=64, rope_theta=1e4),
    encoder=EncoderConfig(n_layers=4, n_frames=1500),
    act="gelu",
    tie_embeddings=True,
    max_seq=65536,
    sub_quadratic=False,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="whisper-tiny-smoke", family="audio", n_layers=2, d_model=64,
        d_ff=128, vocab=256,
        attn=AttnConfig(n_heads=4, n_kv_heads=4, head_dim=16, rope_theta=1e4),
        encoder=EncoderConfig(n_layers=2, n_frames=12), act="gelu",
        tie_embeddings=True, max_seq=128)
