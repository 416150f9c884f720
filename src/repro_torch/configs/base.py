"""Configuration dataclasses for the model zoo and the coded-compute engine.

Every assigned architecture gets a ``ModelConfig`` in its own module
under ``repro_torch.configs``; the registry maps ``--arch`` ids to them.
Each config also exposes a ``smoke()`` reduction (same family / wiring,
tiny dims) used by the CPU test suite.  The configs are the JAX
package's, copied as data, so a config means the same model in both.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field


@dataclass(frozen=True)
class AttnConfig:
    n_heads: int
    n_kv_heads: int
    head_dim: int
    qk_norm: bool = False
    rope_theta: float = 1e6
    window: int | None = None        # sliding-window size for local layers
    causal: bool = True


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head latent attention (DeepSeek-V3, Kimi-K2): queries through
    a ``q_lora_rank`` bottleneck, keys and values from one cached latent
    of ``kv_lora_rank`` plus one rotated key of ``qk_rope_head_dim``
    shared by every head, and YaRN-scaled RoPE frequencies."""

    n_heads: int
    q_lora_rank: int
    kv_lora_rank: int
    qk_nope_head_dim: int
    qk_rope_head_dim: int
    v_head_dim: int
    rope_theta: float
    # YaRN (``rope_scaling``); factor 1 is plain RoPE
    rope_factor: float
    rope_original_max: int
    beta_fast: float
    beta_slow: float
    mscale: float
    mscale_all_dim: float

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int                   # the router's width
    top_k: int
    d_expert: int                    # per-expert FFN hidden dim
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    # the fields of ``SigmoidMoEConfig``, at the values every softmax
    # router has: class attributes and not fields, so that this config's
    # data stays the JAX package's
    scoring = "softmax"
    n_held = None
    held_from = 0

    @property
    def held(self) -> int:
        """How many experts this chip holds (all but where ``n_held``
        says)."""
        return self.n_experts if self.n_held is None else self.n_held


@dataclass(frozen=True)
class SigmoidMoEConfig(MoEConfig):
    """DeepSeek-V3's noaux_tc routing (the port's own): the top ``top_k``
    of sigmoid scores plus a correction bias, weights from the unbiased
    scores normalised and scaled by ``routed_scale``; dropless.  The chip
    holds ``n_held`` experts from ``held_from`` (None: all of them); the
    router still routes over all ``n_experts``."""

    scoring = "sigmoid"              # the type says it: not a field
    routed_scale: float = 1.0
    bias_init_std: float = 0.0       # the correction bias's init draw
    n_held: int | None = None
    held_from: int = 0


@dataclass(frozen=True)
class SSMConfig:
    d_state: int
    head_dim: int = 64
    expand: int = 2
    d_conv: int = 4
    chunk: int = 256                 # SSD chunk length


@dataclass(frozen=True)
class EncoderConfig:
    """Audio/vision frontend backbone (whisper encoder).  The modality
    frontend itself (conv / patchify) is a STUB: ``input_specs`` provides
    precomputed frame embeddings."""

    n_layers: int
    n_frames: int                    # encoder sequence length


@dataclass(frozen=True)
class CodedConfig:
    """Paper integration: run selected matmuls through the sparsity-
    preserving coded engine (Alg. 1/2) on an ``n_workers`` axis."""

    enabled: bool = False
    n_workers: int = 16
    stragglers: int = 2
    layers: tuple[str, ...] = ("lm_head",)   # which matmuls are coded
    seed: int = 0
    # registered mv scheme name (repro_torch.api.list_schemes("mv")) used for
    # the coded matmuls; "proposed" is the paper's Alg. 1.
    scheme: str = "proposed"
    # execution backend for the coded engine (repro_torch.runtime):
    # None/"auto" = density+platform pick at plan compile time
    # (repro_torch.api.backends); the REPRO_CODED_BACKEND env var overrides
    # everything, including auto.
    backend: str | None = None
    # serve the coded matmuls from real workers (repro_torch.cluster):
    # the plan is sharded once at engine build and every step dispatches
    # tasks + decodes from the fastest-k results; a card plan's workers
    # compute on the card.  cluster_workers < n_workers hosts several
    # virtual workers per physical one (partial-straggler setting);
    # None = one host per virtual worker.
    cluster: bool = False
    cluster_workers: int | None = None
    # cluster transport (repro_torch.cluster.transport): "memory"
    # (in-process threads), "pipe" (spawned subprocesses), "tcp"
    # (sockets), "shm" (shared-memory payloads).  None = the
    # REPRO_CLUSTER_TRANSPORT env var, falling back to "memory".
    transport: str | None = None
    # shared fleet session (repro_torch.api.fleet.CodedFleet): when set, the
    # engine ATTACHES its coded-head plan to this externally-owned
    # fleet instead of spinning up a private cluster -- the LM head,
    # CodedMoE experts and gradient aggregator then serve off the same
    # persistent worker set.  engine.close() detaches the plan but
    # leaves the fleet (and its workers) running for the other
    # consumers; whoever built the fleet closes it.  Overrides
    # cluster=/cluster_workers when set.
    fleet: object | None = None
    # serve front door (repro_torch.serve.Router): when set, the engine
    # routes its coded head through router.submit(endpoint, ...,
    # tenant=tenant) -- per-tenant weighted-fair queueing, adaptive
    # microbatching, replica balancing.  If the endpoint is not yet
    # registered the engine registers it on one owned replica fleet
    # (cluster_workers workers on `transport`) and unregisters it on
    # close(); a pre-registered endpoint is shared and left running.
    # Overrides fleet=/cluster= when set.
    router: object | None = None
    endpoint: str = "lm-head"
    tenant: str = "default"


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | hybrid | ssm | audio | vlm | moe
    n_layers: int
    d_model: int
    d_ff: int
    vocab: int
    attn: AttnConfig | None = None
    moe: MoEConfig | None = None
    ssm: SSMConfig | None = None
    encoder: EncoderConfig | None = None
    vision_tokens: int = 0           # stub CLIP tokens prepended (vlm)
    layer_pattern: tuple[str, ...] | None = None
    # repeating unit, e.g. ("L","L","L","L","L","G") for gemma3,
    # ("M","M","M","M","M","S") for zamba2 (S = shared attention block).
    act: str = "swiglu"              # swiglu | gelu
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    max_seq: int = 131072
    sub_quadratic: bool = False      # eligible for the long_500k cell
    coded: CodedConfig = field(default_factory=CodedConfig)
    # attention implementation: "auto" picks chunked for long sequences
    attn_impl: str = "auto"
    attn_chunk: int = 512
    # activation checkpointing for the training path:
    #   "none" | "full" (recompute everything) | "dots" (save matmul outs)
    remat: str = "full"
    # the fields of ``LatentModelConfig``, at the values every other
    # config has: class attributes and not fields, so that the ten
    # configs copied from the JAX package stay its data
    mla = None
    first_dense = 0
    init_std = None

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # ---------------- derived quantities ----------------

    @property
    def pattern(self) -> tuple[str, ...]:
        if self.layer_pattern is not None:
            return self.layer_pattern
        return ("A",) * 1            # homogeneous unit of one layer

    @property
    def n_groups(self) -> int:
        p = len(self.pattern)
        if self.n_layers % p:
            raise ValueError(f"{self.name}: n_layers={self.n_layers} "
                             f"not a multiple of pattern {p}")
        return self.n_layers // p

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks)."""
        if self.mla is not None:
            return self._mla_param_count()
        d = self.d_model
        total = self.vocab * d * (1 if self.tie_embeddings else 2)
        per_pattern = 0
        for kind in self.pattern:
            if kind in ("A", "L", "G"):
                a = self.attn
                qkv = d * (a.n_heads + 2 * a.n_kv_heads) * a.head_dim
                o = a.n_heads * a.head_dim * d
                if self.moe is not None:
                    ffn = self.moe.n_experts * 3 * d * self.moe.d_expert + d * self.moe.n_experts
                    ffn += self.moe.n_shared_experts * 3 * d * self.moe.d_expert
                else:
                    mult = 3 if self.act == "swiglu" else 2
                    ffn = mult * d * self.d_ff
                per_pattern += qkv + o + ffn + 2 * d
            elif kind == "M":
                s = self.ssm
                d_in = s.expand * d
                n_h = d_in // s.head_dim
                in_proj = d * (2 * d_in + 2 * s.d_state + n_h)
                per_pattern += in_proj + d_in * d + d_in * s.d_conv + 2 * d + 2 * n_h
            elif kind == "S":
                a = self.attn
                qkv = d * (a.n_heads + 2 * a.n_kv_heads) * a.head_dim
                o = a.n_heads * a.head_dim * d
                mult = 3 if self.act == "swiglu" else 2
                per_pattern += qkv + o + mult * d * self.d_ff + 2 * d
        if "S" in self.pattern:
            # shared block counted once, not per group
            a = self.attn
            shared = (d * (a.n_heads + 2 * a.n_kv_heads) * a.head_dim
                      + a.n_heads * a.head_dim * d
                      + (3 if self.act == "swiglu" else 2) * d * self.d_ff + 2 * d)
            per_pattern -= shared
            total += shared
        total += per_pattern * self.n_groups
        if self.encoder is not None:
            a = self.attn
            enc_layer = (d * (a.n_heads + 2 * a.n_kv_heads) * a.head_dim
                         + a.n_heads * a.head_dim * d
                         + 2 * d * self.d_ff + 2 * d)
            total += enc_layer * self.encoder.n_layers
        return int(total)

    def _mla_param_count(self) -> int:
        """Exact count of a latent-attention model's weights: embedding
        and untied head, per layer MLA and two norms, the leading dense
        FFNs, and per MoE layer the router (and correction bias), the
        held experts and the shared expert."""
        d, m = self.d_model, self.mla
        total = self.vocab * d * (1 if self.tie_embeddings else 2) + d
        attn = (d * m.q_lora_rank + m.q_lora_rank
                + m.q_lora_rank * m.n_heads * m.qk_head_dim
                + d * (m.kv_lora_rank + m.qk_rope_head_dim) + m.kv_lora_rank
                + m.kv_lora_rank * m.n_heads
                * (m.qk_nope_head_dim + m.v_head_dim)
                + m.n_heads * m.v_head_dim * d + 2 * d)
        n_dense = self.n_layers if self.moe is None else self.first_dense
        ffn = 3 * d * self.d_ff * n_dense
        if self.moe is not None:
            e = self.moe
            per = (d * e.n_experts + e.held * 3 * d * e.d_expert
                   + e.n_shared_experts * 3 * d * e.d_expert)
            if e.scoring == "sigmoid":
                per += e.n_experts
            ffn += per * (self.n_layers - self.first_dense)
        return int(total + attn * self.n_layers + ffn)

    def active_param_count(self) -> int:
        """Active params per token (MoE: only top_k experts count)."""
        if self.moe is None:
            return self.param_count()
        full = self.param_count()
        d = self.d_model
        if self.mla is not None:
            inactive = max(self.moe.held - self.moe.top_k, 0) * 3 * d \
                * self.moe.d_expert
            return int(full - inactive * (self.n_layers - self.first_dense))
        inactive = (self.moe.n_experts - self.moe.top_k) * 3 * d * self.moe.d_expert
        return int(full - inactive * self.n_layers)


@dataclass(frozen=True)
class LatentModelConfig(ModelConfig):
    """A model with latent attention (the port's own: Kimi-K2-Instruct):
    ``mla`` in place of ``attn`` in every layer; the ``first_dense``
    leading layers of an MoE model keep a dense FFN of width ``d_ff``;
    every weight matrix and the embedding draw N(0, ``init_std``) (HF's
    ``initializer_range``)."""

    mla: MLAConfig | None = None
    first_dense: int = 0
    init_std: float = 0.02


@dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell from the assignment."""

    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode

    @property
    def is_serve(self) -> bool:
        return self.kind in ("prefill", "decode")


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}
