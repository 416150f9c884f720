"""A plain reference of DeepSeek-V3.2's decoder (DeepSeek-V3's architecture
made sparse by DeepSeek Sparse Attention), for judging the port's
``deepseek-v3.2``.

Plain ``torch`` only: nothing of the program, the JAX package or JAX;
the helpers it shares with Kimi-K2's reference (``reference/kimi_k2.py``)
are copies of that file's.  Float32
throughout, TF32 off, the full forward over whole sequences in the
expanded (non-absorbed) latent-attention form, no cache, one sequence's
attention at a time in blocks of ``BLOCK`` query positions, so that a
33k-token sequence fits on one card.  ``forward(sd, cfg, tokens)``
takes:

- ``sd``: the weights by the port's state-dict names, each ``(d_in,
  d_out)``: Kimi-K2's reference's names, and per layer the indexer's
  ``layers.i.attn.indexer.wq_b`` (indexer.wq_b), ``wk`` (indexer.wk),
  ``k_norm`` / ``k_bias`` (indexer.k_norm's weight and bias) and
  ``w_proj`` (indexer.weights_proj).
- ``cfg``: the published ``config.json``'s keys, and
  ``experts_held_from``: the first expert this chip holds.

Per layer, for the token at position p with normed input x and normed
query latent r: the indexer's queries q_h = (W_qb r)_h and key k =
LayerNorm(W_k x) (eps 1e-6), dims 0..qk_rope_head_dim-1 of both turned
by RoPE in halves (x_j, x_j+rope/2), weights w_h = (W_w x)_h
index_n_heads^-1/2 index_head_dim^-1/2, scores I(p, s) = sum_h w_h
ReLU(q_h . k_s) for s <= p, and S(p) the top min(index_topk, p + 1)
positions.  Latent attention's scores are -inf outside S(p).

Departures from the published description, each deliberate:

- Only the held experts are computed, as in Kimi-K2's reference; the
  router keeps its whole width and its groups: each group of
  n_routed_experts / n_group scores the sum of its two best biased
  scores, the best topk_group groups' experts are chosen from (-inf
  elsewhere, as the published inference code masks them), and the top
  num_experts_per_tok of those are taken.
- The indexer's q and k are neither rotated by the Hadamard matrix nor
  cast to fp8: the rotation is orthonormal, so q . k is unchanged in
  exact arithmetic, and exists only for the cast; the indexer computes
  in f32 here and is served in bf16 by the port.
- Latent attention's RoPE turns adjacent pairs in place, the indexer's
  halves, as the published inference code's two paths do.
- No multi-token-prediction layer (``num_nextn_predict_layers`` 0).
- The published weights are fp8 blocks; the port serves bf16, which is
  what is compared with this f32 reference.

``fp8=True`` is the control of Kimi-K2's reference: every weight and the
hidden state between layers rounded through fp8 e4m3; ``cache_fp8=True``
rounds only each layer's latent c and rotated k_pe.  ``dense=True`` is
the selection's control: every causal position attended, as a program
that ignored the indexer would.

``probe``, a dict, receives layer 0's state, which no selection has
touched yet: its latent ``c``, rotated ``kr`` and indexer key ``ik`` of
every position (b, s, .), as a program caches them (through fp8 under
either control), and under ``chosen`` the positions each of
``positions`` attends there (b, P, s) bool.
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


# query positions whose scores are computed at once
BLOCK = 128
# the indexer key's LayerNorm eps
INDEX_NORM_EPS = 1e-6


def rotate_halves(x, pos, cfg):
    """x (..., S, [H,] D) float32 with its first qk_rope_head_dim dims
    turned in halves: (x_j, x_j+rope/2) by pos x frequency_j, times
    YaRN's amplitude; the other dims as they are."""
    dr = cfg["qk_rope_head_dim"]
    rs = cfg.get("rope_scaling") or {}
    factor = rs.get("factor", 1.0)
    amp = yarn_mscale(factor, rs.get("mscale", 1.0)) / yarn_mscale(
        factor, rs.get("mscale_all_dim", 0.0))
    ang = torch.outer(pos.double(), rope_frequencies(cfg).to(pos.device))
    cos, sin = (amp * ang.cos()).float(), (amp * ang.sin()).float()
    if x.dim() == 4:
        cos, sin = cos[:, None], sin[:, None]
    x1, x2, rest = x[..., :dr // 2], x[..., dr // 2:dr], x[..., dr:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin, rest], -1)


def index_keys(p, h, pos, cfg, rnd):
    """The indexer's keys of every position: h (b, s, d) -> (b, s, D)."""
    k = h @ rnd(p["wk"])
    k = torch.nn.functional.layer_norm(k, k.shape[-1:], rnd(p["k_norm"]),
                                       rnd(p["k_bias"]), INDEX_NORM_EPS)
    return rotate_halves(k, pos, cfg)


def selected(qi, w, ki, qpos, cfg, dense):
    """Which keys each query of a block attends: qi (n, Hi, D) and w (n,
    Hi) at positions qpos (n,), ki (L, D) the keys of positions 0..L-1.
    -> bool (n, L): S(p) of each query, or every s <= p if ``dense``."""
    causal = torch.arange(ki.shape[0], device=ki.device)[None] \
        <= qpos[:, None]
    if dense:
        return causal
    index = torch.einsum("nhd,kd->nhk", qi, ki).relu()
    index = torch.einsum("nhk,nh->nk", index, w)
    index = index.masked_fill(~causal, float("-inf"))
    top = index.topk(min(cfg["index_topk"], ki.shape[0]), dim=-1).indices
    return torch.zeros_like(causal).scatter_(1, top, True) & causal


def attention(p, h, cfg, eps, rnd, kept, dense, rows, probe=None,
              at=None):
    """Sparse latent attention of the query positions ``rows`` (r,) over
    every position of h (b, s, d) -> (b, r, d); ``probe`` (a dict) takes
    the layer's cached state and the selections of the positions ``at``
    (among ``rows``)."""
    b, s, _ = h.shape
    nh = cfg["num_attention_heads"]
    dn, dr, dv = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                  cfg["v_head_dim"])
    kvr = cfg["kv_lora_rank"]
    hi_, di = cfg["index_n_heads"], cfg["index_head_dim"]
    rs = cfg.get("rope_scaling") or {}
    scale = (dn + dr) ** -0.5
    if rs.get("factor", 1.0) > 1 and rs.get("mscale_all_dim"):
        scale *= yarn_mscale(rs["factor"], rs["mscale_all_dim"]) ** 2
    pos = torch.arange(s, device=h.device)
    hq = h[:, rows]
    qr = rms_norm(hq @ rnd(p["wq_a"]), rnd(p["q_norm"]), eps)
    q = (qr @ rnd(p["wq_b"])).view(b, len(rows), nh, dn + dr)
    q_nope, q_pe = q[..., :dn], rotate(q[..., dn:], rows, cfg)
    ckv = h @ rnd(p["wkv_a"])
    c = kept(rms_norm(ckv[..., :kvr], rnd(p["kv_norm"]), eps))
    k_pe = kept(rotate(ckv[..., kvr:], pos, cfg))              # (b, s, dr)
    kv = (c @ rnd(p["wkv_b"])).view(b, s, nh, dn + dv)
    # per head, keys [k_nope | k_pe] and values laid out (nh, s, .)
    k = torch.cat([kv[..., :dn], k_pe[:, :, None].expand(b, s, nh, dr)],
                  dim=-1).transpose(1, 2).contiguous()
    v = kv[..., dn:].transpose(1, 2).contiguous()
    q = torch.cat([q_nope, q_pe], dim=-1).transpose(1, 2)   # (b, nh, r, .)
    ix = p["indexer"]
    ki = index_keys(ix, h, pos, cfg, rnd)                      # (b, s, di)
    qi = rotate_halves((qr @ rnd(ix["wq_b"])).view(b, len(rows), hi_, di),
                       rows, cfg)
    w = (hq @ rnd(ix["w_proj"])) * (hi_ * di) ** -0.5
    if probe is not None:
        probe.update(c=c, kr=k_pe, ik=ki)
        if at is not None:
            j = (rows[None] == at[:, None]).int().argmax(1)
            probe["chosen"] = torch.stack([
                selected(qi[i, j], w[i, j], ki[i], at, cfg, dense)
                for i in range(b)])
    outs = []
    for i in range(b):
        out = []
        for at in range(0, len(rows), BLOCK):
            blk = slice(at, at + BLOCK)
            qpos = rows[blk]
            end = int(qpos.max()) + 1
            keep = selected(qi[i, blk], w[i, blk], ki[i, :end], qpos, cfg,
                            dense)
            sc = torch.bmm(q[i, :, blk], k[i, :, :end].transpose(1, 2))
            sc = (sc * scale).masked_fill_(~keep, float("-inf"))
            out.append(torch.bmm(sc.softmax(-1), v[i, :, :end])
                       .transpose(0, 1))                   # (nq, nh, dv)
        outs.append(torch.cat(out))
    o = torch.stack(outs).reshape(b, len(rows), nh * dv)
    return o @ rnd(p["wo"])


def moe(p, h, cfg, rnd):
    """Group-limited noaux_tc over the router's width; only the held
    experts computed."""
    x = h.reshape(-1, h.shape[-1])
    scores = torch.sigmoid(x @ rnd(p["router"]))
    choice = scores + rnd(p["bias"])
    groups, kept_groups = cfg.get("n_group", 1), cfg.get("topk_group", 1)
    if groups > 1:
        g = choice.view(len(x), groups, -1)
        best = g.topk(2, dim=-1).values.sum(-1)
        keep = torch.zeros_like(best, dtype=torch.bool).scatter_(
            1, best.topk(kept_groups, dim=-1).indices, True)
        choice = g.masked_fill(~keep[..., None], float("-inf")).flatten(1)
    top = torch.topk(choice, cfg["num_experts_per_tok"], dim=-1).indices
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


def forward(sd: dict, cfg: dict, tokens: torch.Tensor, *, fp8: bool = False,
            cache_fp8: bool = False, dense: bool = False,
            positions=None, probe=None) -> torch.Tensor:
    """tokens (B, S) -> float32 logits (B, S, vocab), or (B, P, vocab) at
    the P indices ``positions`` only (the last layer then computes only
    those rows); ``probe``: a dict for layer 0's state."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return _forward(sd, cfg, tokens, fp8, cache_fp8, dense, positions,
                        probe)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _forward(sd, cfg, tokens, fp8, cache_fp8, dense, positions, probe):
    def rnd(t):
        return to_fp8(t) if fp8 else t.float()

    def kept(t):
        return to_fp8(t) if cache_fp8 else t

    eps = cfg["rms_norm_eps"]
    x = rnd(sd["embed"])[tokens.to(sd["embed"].device).long()]
    s = x.shape[1]
    every = torch.arange(s, device=x.device)
    last = cfg["num_hidden_layers"] - 1
    wanted = None if positions is None else torch.as_tensor(
        sorted(set(positions)), device=x.device)
    for i in range(last + 1):
        p = _group(sd, f"layers.{i}.")
        rows = every if i < last or positions is None else torch.as_tensor(
            list(positions), device=x.device)
        x = x[:, rows] + attention(p["attn"], rms_norm(x, rnd(p["norm1"]),
                                                       eps),
                                   cfg, eps, rnd, kept, dense, rows,
                                   probe if i == 0 else None, wanted)
        h = rms_norm(x, rnd(p["norm2"]), eps)
        if i < cfg["first_k_dense_replace"]:
            m = p["mlp"]
            x = x + swiglu(h, rnd(m["w_gate"]), rnd(m["w_up"]),
                           rnd(m["w_down"]))
        else:
            x = x + moe(p["moe"], h, cfg, rnd)
        if fp8:
            x = to_fp8(x)
    return rms_norm(x, rnd(sd["final_norm"]), eps) @ rnd(sd["head"])

