"""kimi-k2-instruct [moe]: Kimi-K2-Instruct as published
(https://huggingface.co/moonshotai/Kimi-K2-Instruct/blob/main/config.json):
61 layers, d_model 7168, vocab 163840, untied head.

- Attention is multi-head latent attention (64 heads; q_lora_rank 1536,
  kv_lora_rank 512, qk_nope 128, qk_rope 64, v 128) with YaRN RoPE
  (theta 50000, factor 32 over 4096 positions, beta 1/1, mscale 1/1).
- Layer 0 has a dense SwiGLU of width 18432 (``first_k_dense_replace``
  1); layers 1-60 an MoE of 384 routed experts of width 2048, top 8 by
  DeepSeek-V3's noaux_tc (sigmoid scores, correction bias, normalised,
  x 2.827), plus one shared expert.
- RMSNorm eps 1e-6 everywhere; no attention bias.

The published config gives no correction-bias values: ``init`` draws
them N(0, 0.01) (``bias_init_std``), so that the bias changes choices.
Every other weight is N(0, ``initializer_range`` 0.02), norms 1.  This
config holds all 384 experts; a chip of an expert-parallel deployment
holds ``n_held`` of them from ``held_from`` (``SigmoidMoEConfig``).  The port only: the
JAX package has no such model.
"""

from .base import LatentModelConfig, MLAConfig, SigmoidMoEConfig

MLA = MLAConfig(n_heads=64, q_lora_rank=1536, kv_lora_rank=512,
                qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
                rope_theta=50000.0, rope_factor=32.0,
                rope_original_max=4096, beta_fast=1.0, beta_slow=1.0,
                mscale=1.0, mscale_all_dim=1.0)

CONFIG = LatentModelConfig(
    name="kimi-k2-instruct",
    family="moe",
    n_layers=61,
    d_model=7168,
    d_ff=18432,
    vocab=163840,
    mla=MLA,
    moe=SigmoidMoEConfig(n_experts=384, top_k=8, d_expert=2048,
                         n_shared_experts=1, routed_scale=2.827,
                         bias_init_std=0.01),
    first_dense=1,
    act="swiglu",
    tie_embeddings=False,
    norm_eps=1e-6,
    max_seq=131072,
    sub_quadratic=False,
    init_std=0.02,
)


def smoke() -> LatentModelConfig:
    """One dense and two MoE layers; 16 experts of which 8 are held, top
    4, one shared; small latent ranks; YaRN as published (its ramp
    falls at other pair indices at this rope width)."""
    return LatentModelConfig(
        name="kimi-k2-instruct-smoke", family="moe", n_layers=3, d_model=64,
        d_ff=96, vocab=256,
        mla=MLAConfig(n_heads=4, q_lora_rank=32, kv_lora_rank=16,
                      qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
                      rope_theta=50000.0, rope_factor=32.0,
                      rope_original_max=4096, beta_fast=1.0, beta_slow=1.0,
                      mscale=1.0, mscale_all_dim=1.0),
        moe=SigmoidMoEConfig(n_experts=16, top_k=4, d_expert=32,
                             n_shared_experts=1, routed_scale=2.827,
                             bias_init_std=0.01, n_held=8, held_from=0),
        first_dense=1, act="swiglu", tie_embeddings=False, max_seq=128,
        init_std=0.02)
