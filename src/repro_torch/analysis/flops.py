"""Analytic FLOP / HBM-traffic model for every (arch x shape) cell.

The port's copy of ``repro.analysis.flops``: pure arithmetic over the
port's ``ModelConfig`` / ``ShapeConfig`` (the same configs), so every
count is the JAX package's number exactly.  The notes below are the
reference's; the XLA validation lives in the JAX package's tests.

WHY ANALYTIC: XLA's ``compiled.cost_analysis()`` counts a ``while``
body once, so any scan-over-layers model (all of ours) under-reports
FLOPs/bytes by ~n_layers.  The roofline therefore uses closed-form
counts derived from the *exact einsums in this codebase* (not generic
6ND): full-S^2 masked attention, SSD chunk terms, MoE capacity slots,
remat recompute -- all waste terms included.  ``tests/test_analysis.py``
validates the formulas against XLA cost_analysis on unroll=True small
configs (agreement within a few % -- XLA also counts elementwise ops).

MODEL_FLOPS (the "useful" count) is the standard 6*N_active*D for
training and 2*N_active per generated token for decode; the ratio
MODEL_FLOPS / analytic_total surfaces masked-attention waste, MoE
capacity padding, and remat recompute exactly as the assignment's
HLO-ratio was meant to.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..configs.base import ModelConfig, ShapeConfig


def _round4(x: int) -> int:
    return max(4, -(-x // 4) * 4)


@dataclass(frozen=True)
class FlopReport:
    total: float                 # analytic FLOPs for the whole step (all devices)
    model_flops: float           # 6*N_active*D (train) / 2*N_active*B (decode)
    breakdown: dict

    @property
    def useful_ratio(self) -> float:
        return self.model_flops / self.total if self.total else 0.0


# ---------------------------------------------------------------------------
# Per-layer forward FLOPs for a span of s_q tokens against s_kv context
# ---------------------------------------------------------------------------


def _attn_layer_fwd(cfg: ModelConfig, s_q: int, s_kv: int) -> float:
    a = cfg.attn
    d, h, kv, hd = cfg.d_model, a.n_heads, a.n_kv_heads, a.head_dim
    qkv = 2 * s_q * d * (h + 2 * kv) * hd
    scores = 2 * s_q * s_kv * h * hd          # full (masked) S x S_kv
    pv = 2 * s_q * s_kv * h * hd
    out = 2 * s_q * h * hd * d
    return float(qkv + scores + pv + out)


def _mlp_fwd(cfg: ModelConfig, s_q: int) -> float:
    mult = 6 if cfg.act == "swiglu" else 4
    return float(mult * s_q * cfg.d_model * cfg.d_ff)


def _moe_fwd(cfg: ModelConfig, tokens: int) -> float:
    m = cfg.moe
    cap = _round4(int(tokens * m.top_k * m.capacity_factor / m.n_experts) + 1)
    slots = m.n_experts * cap
    router = 2 * tokens * cfg.d_model * m.n_experts
    experts = 3 * 2 * slots * cfg.d_model * m.d_expert
    shared = 3 * 2 * tokens * cfg.d_model * \
        (m.n_shared_experts * m.d_expert) if m.n_shared_experts else 0
    return float(router + experts + shared)


def _mamba_fwd(cfg: ModelConfig, s_q: int, decode: bool = False) -> float:
    s = cfg.ssm
    d = cfg.d_model
    d_in = s.expand * d
    n, hh, p = s.d_state, d_in // s.head_dim, s.head_dim
    in_proj = 2 * s_q * d * (2 * d_in + 2 * n + hh)
    conv = 2 * s_q * s.d_conv * (d_in + 2 * n)
    out_proj = 2 * s_q * d_in * d
    if decode:
        ssd = 3 * 2 * s_q * hh * p * n          # state update + readout
    else:
        q = min(s.chunk, s_q)
        ssd = (2 * s_q * q * n                  # C.B scores
               + 2 * s_q * q * hh * p           # y_diag contraction
               + s_q * q * hh                   # decay mult
               + 4 * s_q * hh * p * n)          # y_off + state contrib
    return float(in_proj + conv + out_proj + ssd)


def _layer_fwd(cfg: ModelConfig, kind: str, s_q: int, s_kv: int,
               tokens_for_moe: int, decode: bool = False) -> float:
    if kind == "M":
        return _mamba_fwd(cfg, s_q, decode)
    win = cfg.attn.window if kind == "L" else None
    eff_kv = min(s_kv, win) if (win and decode) else s_kv
    f = _attn_layer_fwd(cfg, s_q, eff_kv)
    if cfg.moe is not None and kind != "S":
        f += _moe_fwd(cfg, tokens_for_moe)
    else:
        f += _mlp_fwd(cfg, s_q)
    return f


def _stack_fwd(cfg: ModelConfig, b: int, s_q: int, s_kv: int,
               decode: bool = False) -> float:
    """Forward FLOPs of the layer stack for a (b, s_q) slab.

    Attention / mamba terms scale per batch element; the MoE term is a
    function of the *global* token count (capacity rounding happens on
    the full batch, matching moe_block).
    """
    tokens_moe = b * s_q
    total = 0.0
    for kind in cfg.pattern:
        if cfg.moe is not None and kind not in ("M", "S"):
            eff_kv = min(s_kv, cfg.attn.window) \
                if (kind == "L" and cfg.attn.window and decode) else s_kv
            total += b * _attn_layer_fwd(cfg, s_q, eff_kv)
            total += _moe_fwd(cfg, tokens_moe)
        else:
            total += b * _layer_fwd(cfg, kind, s_q, s_kv, tokens_moe, decode)
    return total * cfg.n_groups


def _logits_fwd(cfg: ModelConfig, b: int, s_q: int) -> float:
    return float(2 * b * s_q * cfg.d_model * cfg.vocab)


def _encoder_fwd(cfg: ModelConfig, b: int) -> float:
    if cfg.encoder is None:
        return 0.0
    f = cfg.encoder.n_frames
    per_layer = _attn_layer_fwd(cfg, f, f) + 4 * f * cfg.d_model * cfg.d_ff
    # decoder cross-attention: q from s tokens against f frames + enc kv proj
    return float(b * per_layer * cfg.encoder.n_layers)


def _xattn_fwd(cfg: ModelConfig, b: int, s_q: int) -> float:
    if cfg.encoder is None:
        return 0.0
    a = cfg.attn
    f = cfg.encoder.n_frames
    per_layer = (2 * s_q * cfg.d_model * a.n_heads * a.head_dim      # q proj
                 + 2 * f * cfg.d_model * 2 * a.n_kv_heads * a.head_dim  # kv
                 + 4 * s_q * f * a.n_heads * a.head_dim              # attn
                 + 2 * s_q * a.n_heads * a.head_dim * cfg.d_model)   # out
    return float(b * per_layer * cfg.n_layers)


# ---------------------------------------------------------------------------
# Cell-level reports
# ---------------------------------------------------------------------------


def cell_flops(cfg: ModelConfig, shape: ShapeConfig,
               microbatches: int = 4) -> FlopReport:
    b, s = shape.global_batch, shape.seq_len
    n_active = cfg.active_param_count()

    if shape.kind == "train":
        s_text = s - cfg.vision_tokens if cfg.family == "vlm" else s
        s_model = s  # vlm: vision tokens join the stack
        bm = b // microbatches
        fwd = (_stack_fwd(cfg, bm, s_model, s_model)
               + _logits_fwd(cfg, bm, s_text)
               + _encoder_fwd(cfg, bm) + _xattn_fwd(cfg, bm, s_model))
        per_micro = 3 * fwd + (fwd if cfg.remat == "full" else 0.0)
        total = per_micro * microbatches
        model = 6.0 * n_active * b * s_text
        return FlopReport(total=total, model_flops=model,
                          breakdown={"fwd_per_micro": fwd,
                                     "microbatches": microbatches,
                                     "bwd_mult": per_micro / fwd})

    if shape.kind == "prefill":
        s_model = s
        fwd = (_stack_fwd(cfg, b, s_model, s_model)
               + _logits_fwd(cfg, b, 1)
               + _encoder_fwd(cfg, b) + _xattn_fwd(cfg, b, s_model))
        model = 2.0 * n_active * b * s
        return FlopReport(total=fwd, model_flops=model,
                          breakdown={"fwd": fwd})

    # decode: one token per sequence against an s-token cache
    fwd = (_stack_fwd(cfg, b, 1, s, decode=True)
           + _logits_fwd(cfg, b, 1) + _xattn_fwd(cfg, b, 1))
    model = 2.0 * n_active * b
    return FlopReport(total=fwd, model_flops=model,
                      breakdown={"fwd": fwd})


# ---------------------------------------------------------------------------
# HBM traffic model (documented approximation; see EXPERIMENTS.md)
# ---------------------------------------------------------------------------


def cell_hbm_bytes(cfg: ModelConfig, shape: ShapeConfig, n_devices: int,
                   microbatches: int = 4, param_dtype_bytes: int = 2) -> dict:
    """Per-device HBM bytes per step.

    Terms:
      weights  : local param bytes x reads (fwd + remat-recompute + bwd
                 dgrad) x microbatches + optimizer read/write
      act      : per-layer activation tiles (residual saves, mlp/qkv
                 intermediates) at 2 bytes, x2 for write+read
      scores   : attention score tiles (f32 w+r) -- the S^2 term
      cache    : KV/state cache read (+ single-slot write) for decode
      logits   : f32 logits w+r (+ bwd)
    """
    b, s = shape.global_batch, shape.seq_len
    d, v = cfg.d_model, cfg.vocab
    p_local = cfg.param_count() * param_dtype_bytes / n_devices
    a = cfg.attn

    def attn_hd():
        return (a.n_heads * a.head_dim) if a else 0

    if shape.kind == "train":
        bm = b // microbatches
        weights = p_local * (3 * microbatches + 8)   # +m,v rw, param rw (f32-ish)
        per_layer_act = 2 * bm * s * (2.0 * d        # resid save + norm
                                      + (6 * cfg.d_ff if cfg.moe is None
                                         else 6 * cfg.moe.top_k * cfg.moe.d_expert)
                                      + 3 * attn_hd()
                                      + (3 * cfg.ssm.expand * d if cfg.ssm else 0))
        act = per_layer_act * cfg.n_layers * microbatches * 2 / n_devices
        scores = (4.0 * bm * (a.n_heads if a else 0) * s * s * 2
                  * sum(1 for k in cfg.pattern if k in ("A", "L", "G", "S"))
                  * cfg.n_groups / len(cfg.pattern) * microbatches / n_devices) \
            if a else 0.0
        logits = 3 * 4.0 * bm * s * v * microbatches / n_devices
        total = weights + act + scores + logits
        return {"weights": weights, "act": act, "scores": scores,
                "logits": logits, "total": total}

    if shape.kind == "prefill":
        weights = p_local
        per_layer_act = 2 * b * s * (2.0 * d
                                     + (2 * cfg.d_ff if cfg.moe is None
                                        else 2 * cfg.moe.top_k * cfg.moe.d_expert)
                                     + 3 * attn_hd()
                                     + (3 * cfg.ssm.expand * d if cfg.ssm else 0))
        act = per_layer_act * cfg.n_layers / n_devices
        scores = (4.0 * b * (a.n_heads if a else 0) * s * s
                  / n_devices) if a else 0.0
        total = weights + act + scores
        return {"weights": weights, "act": act, "scores": scores,
                "total": total}

    # decode: weights + full cache read per token
    weights = p_local
    cache = 0.0
    for kind in cfg.pattern:
        if kind == "M":
            ss = cfg.ssm
            d_in = ss.expand * d
            cache += b * (d_in // ss.head_dim) * ss.head_dim * ss.d_state * 4
        elif a is not None:
            length = min(a.window, s) if (kind == "L" and a.window) else s
            cache += b * length * a.n_kv_heads * a.head_dim * 2 * 2  # k+v
    cache = cache * cfg.n_groups / n_devices
    act = 2 * b * 1 * d * 10 * cfg.n_layers / n_devices
    total = weights + cache + act
    return {"weights": weights, "cache": cache, "act": act, "total": total}
