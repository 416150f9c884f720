"""A plain reference of Kimi-K2-Instruct's decoder (DeepSeek-V3's
architecture), for judging the port's ``kimi-k2-instruct``.

Plain ``torch`` only: nothing of the program, the JAX package or JAX.
Float32 throughout, TF32 off, the full forward over whole sequences in
the expanded (non-absorbed) latent-attention form, no cache, one
sequence's attention at a time.  ``forward(sd, cfg, tokens)`` takes:

- ``sd``: the weights by the port's state-dict names, each ``(d_in,
  d_out)`` (the published checkpoint's ``nn.Linear`` weights
  transposed): ``embed``; per layer i ``layers.i.norm1`` / ``norm2``
  (input / post-attention layernorm), ``layers.i.attn.wq_a`` (q_a_proj),
  ``q_norm`` (q_a_layernorm), ``wq_b`` (q_b_proj), ``wkv_a``
  (kv_a_proj_with_mqa), ``kv_norm`` (kv_a_layernorm), ``wkv_b``
  (kv_b_proj), ``wo`` (o_proj); a dense layer's ``layers.i.mlp.w_gate``
  / ``w_up`` / ``w_down``; an MoE layer's ``layers.i.moe.router`` (gate),
  ``bias`` (e_score_correction_bias), ``w_gate`` / ``w_up`` / ``w_down``
  stacked over the held experts, ``shared.*`` (shared_experts);
  ``final_norm`` and ``head`` (lm_head).
- ``cfg``: the published ``config.json``'s keys, and
  ``experts_held_from``: the first expert this chip holds.  How many it
  holds is the expert weights' first dim; the router's width is its own.

Departures from the published description, each deliberate:

- Only the held experts are computed: a token's routed output sums its
  chosen experts that lie in ``[experts_held_from, + held)``, each
  weighted as the full router weights it; the shared expert is added
  once.  With every expert held this is the published layer.
- ``n_group`` and ``topk_group`` must be 1 (Kimi-K2's values): no group
  limit is applied.
- RoPE turns adjacent pairs in place (DeepSeek-V3's inference code,
  ``view_as_complex``); its HF code permutes q_pe and k_pe alike first,
  which leaves every score as it is.
- No multi-token-prediction layer (``num_nextn_predict_layers`` 0).

``fp8=True`` is the control: every weight and the hidden state between
layers rounded through fp8 e4m3 with one scale per tensor, the step
below the bf16 the model is served in (``to_fp8``, the formula of the
benchmark's head reference).  ``cache_fp8=True`` is the latent cache's
control: only each layer's latent c and rotated k_pe rounded so, as a
program that kept its ``{c, kr}`` cache in fp8 would read them back.
"""

from __future__ import annotations

import math

import torch

FP8_MAX = 448.0


def to_fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded through e4m3 with one per-tensor scale, back in f32."""
    scale = t.float().abs().max().clamp_min(1e-30) / FP8_MAX
    return (t.float() / scale).to(torch.float8_e4m3fn).float() * scale


def rms_norm(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def swiglu(x, w_gate, w_up, w_down):
    return (torch.nn.functional.silu(x @ w_gate) * (x @ w_up)) @ w_down


def yarn_mscale(scale, mscale):
    return 1.0 if scale <= 1 else 0.1 * mscale * math.log(scale) + 1.0


def rope_frequencies(cfg) -> torch.Tensor:
    """DeepSeek-V3's YaRN inverse frequencies, float64."""
    dim, base = cfg["qk_rope_head_dim"], float(cfg["rope_theta"])
    rs = cfg.get("rope_scaling") or {}
    freqs = 1.0 / base ** (torch.arange(0, dim, 2, dtype=torch.float64)
                           / dim)
    factor = rs.get("factor", 1.0)
    if factor <= 1:
        return freqs
    orig = rs["original_max_position_embeddings"]

    def corr(n):
        return dim * math.log(orig / (n * 2 * math.pi)) / (2 * math.log(base))

    low = max(math.floor(corr(rs["beta_fast"])), 0)
    high = min(math.ceil(corr(rs["beta_slow"])), dim - 1)
    if low == high:
        high += 0.001
    ramp = torch.clamp((torch.arange(dim // 2, dtype=torch.float64) - low)
                       / (high - low), 0, 1)
    smooth = 1 - ramp
    return freqs / factor * (1 - smooth) + freqs * smooth


def rotate(x, pos, cfg):
    """x (..., S, [H,] D) float32, pairs turned as complex numbers."""
    rs = cfg.get("rope_scaling") or {}
    factor = rs.get("factor", 1.0)
    amp = yarn_mscale(factor, rs.get("mscale", 1.0)) / yarn_mscale(
        factor, rs.get("mscale_all_dim", 0.0))
    ang = torch.outer(pos.double(), rope_frequencies(cfg).to(pos.device))
    turn = torch.polar(torch.full_like(ang, amp), ang).to(torch.complex64)
    if x.dim() == 4:
        turn = turn[:, None]
    xc = torch.view_as_complex(x.float().reshape(*x.shape[:-1], -1, 2)
                               .contiguous())
    return torch.view_as_real(xc * turn).flatten(-2)


def attention(p, h, cfg, eps, rnd, kept):
    b, s, _ = h.shape
    nh = cfg["num_attention_heads"]
    dn, dr, dv = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                  cfg["v_head_dim"])
    kvr = cfg["kv_lora_rank"]
    rs = cfg.get("rope_scaling") or {}
    scale = (dn + dr) ** -0.5
    if rs.get("factor", 1.0) > 1 and rs.get("mscale_all_dim"):
        scale *= yarn_mscale(rs["factor"], rs["mscale_all_dim"]) ** 2
    pos = torch.arange(s, device=h.device)
    q = rms_norm(h @ rnd(p["wq_a"]), rnd(p["q_norm"]), eps) @ rnd(p["wq_b"])
    q = q.view(b, s, nh, dn + dr)
    q_nope, q_pe = q[..., :dn], rotate(q[..., dn:], pos, cfg)
    ckv = h @ rnd(p["wkv_a"])
    c = kept(rms_norm(ckv[..., :kvr], rnd(p["kv_norm"]), eps))
    k_pe = kept(rotate(ckv[..., kvr:], pos, cfg))              # (b, s, dr)
    kv = (c @ rnd(p["wkv_b"])).view(b, s, nh, dn + dv)
    k_nope, v = kv[..., :dn], kv[..., dn:]
    causal = torch.ones(s, s, dtype=torch.bool, device=h.device).tril()
    outs = []
    for i in range(b):
        sc = (torch.einsum("qhd,khd->hqk", q_nope[i], k_nope[i])
              + torch.einsum("qhd,kd->hqk", q_pe[i], k_pe[i])) * scale
        sc = sc.masked_fill(~causal, float("-inf"))
        outs.append(torch.einsum("hqk,khd->qhd", sc.softmax(-1), v[i]))
    o = torch.stack(outs).reshape(b, s, nh * dv)
    return o @ rnd(p["wo"])


def moe(p, h, cfg, rnd):
    """noaux_tc over the router's width; only the held experts computed."""
    if cfg.get("n_group", 1) != 1 or cfg.get("topk_group", 1) != 1:
        raise ValueError("grouped routing is not modelled")
    x = h.reshape(-1, h.shape[-1])
    scores = torch.sigmoid(x @ rnd(p["router"]))
    top = torch.topk(scores + rnd(p["bias"]), cfg["num_experts_per_tok"],
                     dim=-1).indices
    w = scores.gather(1, top)
    if cfg.get("norm_topk_prob", True):
        w = w / (w.sum(-1, keepdim=True) + 1e-20)
    w = w * cfg["routed_scaling_factor"]
    out = torch.zeros_like(x)
    e0 = cfg.get("experts_held_from", 0)
    for j in range(p["w_gate"].shape[0]):
        tok, slot = torch.nonzero(top == e0 + j, as_tuple=True)
        if tok.numel():
            y = swiglu(x[tok], rnd(p["w_gate"][j]), rnd(p["w_up"][j]),
                       rnd(p["w_down"][j]))
            out.index_add_(0, tok, y * w[tok, slot, None])
    if cfg.get("n_shared_experts"):
        sp = p["shared"]
        out = out + swiglu(x, rnd(sp["w_gate"]), rnd(sp["w_up"]),
                           rnd(sp["w_down"]))
    return out.reshape(h.shape)


def _group(sd, prefix):
    out = {}
    for name, t in sd.items():
        if name.startswith(prefix):
            keys = name[len(prefix):].split(".")
            node = out
            for k in keys[:-1]:
                node = node.setdefault(k, {})
            node[keys[-1]] = t
    return out


def forward(sd: dict, cfg: dict, tokens: torch.Tensor, *, fp8: bool = False,
            cache_fp8: bool = False, positions=None) -> torch.Tensor:
    """tokens (B, S) -> float32 logits (B, S, vocab), or (B, P, vocab) at
    the P indices ``positions`` only."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return _forward(sd, cfg, tokens, fp8, cache_fp8, positions)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _forward(sd, cfg, tokens, fp8, cache_fp8, positions):
    def rnd(t):
        return to_fp8(t) if fp8 else t.float()

    def kept(t):
        return to_fp8(t) if cache_fp8 else t

    eps = cfg["rms_norm_eps"]
    x = rnd(sd["embed"])[tokens.to(sd["embed"].device).long()]
    for i in range(cfg["num_hidden_layers"]):
        p = _group(sd, f"layers.{i}.")
        x = x + attention(p["attn"], rms_norm(x, rnd(p["norm1"]), eps), cfg,
                          eps, rnd, kept)
        h = rms_norm(x, rnd(p["norm2"]), eps)
        if i < cfg["first_k_dense_replace"]:
            m = p["mlp"]
            x = x + swiglu(h, rnd(m["w_gate"]), rnd(m["w_up"]),
                           rnd(m["w_down"]))
        else:
            x = x + moe(p["moe"], h, cfg, rnd)
        if fp8:
            x = to_fp8(x)
    if positions is not None:
        x = x[:, list(positions)]
    return rms_norm(x, rnd(sd["final_norm"]), eps) @ rnd(sd["head"])
