"""deepseek-v3.2 [moe]: DeepSeek-V3.2 as published
(https://huggingface.co/deepseek-ai/DeepSeek-V3.2/blob/main/config.json):
61 layers, d_model 7168, vocab 129280, untied head.

- Attention is multi-head latent attention (128 heads; q_lora_rank 1536,
  kv_lora_rank 512, qk_nope 128, qk_rope 64, v 128) with YaRN RoPE
  (theta 10000, factor 40 over 4096 positions, beta 32/1, mscale 1/1),
  made sparse by DeepSeek Sparse Attention: a lightning indexer of 64
  heads x 128 scores every cached position for each query, and the
  query attends only the top ``index_topk`` 2048 (``models/dsa.py``).
- Layers 0-2 have a dense SwiGLU of width 18432 (``first_k_dense_replace``
  3); layers 3-60 an MoE of 256 routed experts of width 2048 in 8 groups,
  top 8 from the best 4 groups by noaux_tc (sigmoid scores, correction
  bias, normalised, x 2.5), plus one shared expert.
- RMSNorm eps 1e-6 everywhere; no attention bias.  The multi-token
  prediction layer (``num_nextn_predict_layers`` 1) drafts tokens for
  speculation and is not built: a step decodes one token.

The published config gives no correction-bias values: ``init`` draws
them N(0, 0.01) (``bias_init_std``).  Every other weight is N(0,
``initializer_range`` 0.02), norms 1, the indexer's LayerNorm bias 0.
This config holds all 256 experts; a chip of an expert-parallel
deployment holds ``n_held`` of them from ``held_from``.  The port only:
the JAX package has no such model.
"""

from .base import IndexerConfig, LatentModelConfig, MLAConfig, SigmoidMoEConfig

MLA = MLAConfig(n_heads=128, q_lora_rank=1536, kv_lora_rank=512,
                qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
                rope_theta=10000.0, rope_factor=40.0,
                rope_original_max=4096, beta_fast=32.0, beta_slow=1.0,
                mscale=1.0, mscale_all_dim=1.0)

CONFIG = LatentModelConfig(
    name="deepseek-v3.2",
    family="moe",
    n_layers=61,
    d_model=7168,
    d_ff=18432,
    vocab=129280,
    mla=MLA,
    indexer=IndexerConfig(n_heads=64, head_dim=128, topk=2048),
    moe=SigmoidMoEConfig(n_experts=256, top_k=8, d_expert=2048,
                         n_shared_experts=1, routed_scale=2.5,
                         bias_init_std=0.01, n_group=8, topk_group=4),
    first_dense=3,
    act="swiglu",
    tie_embeddings=False,
    norm_eps=1e-6,
    max_seq=163840,
    sub_quadratic=False,
    init_std=0.02,
)


def smoke() -> LatentModelConfig:
    """One dense and two MoE layers; 16 experts in 4 groups, of which 2
    are chosen from and 8 experts (groups 0 and 1) held, top 4, one
    shared; small latent ranks; an indexer of 16 heads x 16 that selects
    8 positions, so that selection bites from the ninth token; YaRN as
    published (its ramp falls at other pair indices at this rope
    width)."""
    return LatentModelConfig(
        name="deepseek-v3.2-smoke", family="moe", n_layers=3, d_model=64,
        d_ff=96, vocab=256,
        mla=MLAConfig(n_heads=4, q_lora_rank=32, kv_lora_rank=16,
                      qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
                      rope_theta=10000.0, rope_factor=40.0,
                      rope_original_max=4096, beta_fast=32.0, beta_slow=1.0,
                      mscale=1.0, mscale_all_dim=1.0),
        indexer=IndexerConfig(n_heads=16, head_dim=16, topk=8),
        moe=SigmoidMoEConfig(n_experts=16, top_k=4, d_expert=32,
                             n_shared_experts=1, routed_scale=2.5,
                             bias_init_std=0.01, n_held=8, held_from=0,
                             n_group=4, topk_group=2),
        first_dense=1, act="swiglu", tie_embeddings=False, max_seq=128,
        init_std=0.02)
