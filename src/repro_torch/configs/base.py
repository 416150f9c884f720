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
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int                    # per-expert FFN hidden dim
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    router_jitter: float = 0.0


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
    # The port's ServeEngine serves the cluster and fleet modes below;
    # the router mode raises NotImplementedError until serve/router.py
    # is ported (ROADMAP.md §1 item 11).
    # serve the coded matmuls from real workers (repro_torch.cluster):
    # the plan is sharded once at engine build and every step dispatches
    # tasks + decodes from the fastest-k results; a card plan's workers
    # compute on the card.  cluster_workers < n_workers hosts several
    # virtual workers per physical one (partial-straggler setting);
    # None = one host per virtual worker.
    cluster: bool = False
    cluster_workers: int | None = None
    # cluster transport (repro_torch.cluster.transport): "memory"
    # (in-process threads), "pipe" (spawned subprocesses); the JAX
    # package's "tcp" and "shm" are not ported yet.  None = the
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
    # serve front door (repro.serve.Router): when set, the engine
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

    def active_param_count(self) -> int:
        """Active params per token (MoE: only top_k experts count)."""
        if self.moe is None:
            return self.param_count()
        full = self.param_count()
        d = self.d_model
        inactive = (self.moe.n_experts - self.moe.top_k) * 3 * d * self.moe.d_expert
        return int(full - inactive * self.n_layers)


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
