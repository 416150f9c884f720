"""Multi-head latent attention (MLA), as DeepSeek-V3's published modelling
code defines it and Kimi-K2 uses it, in two forms.

Per head i, with ``h`` the layer's normed input:

  q = W_qb RMSNorm(W_qa h), split into q_nope and q_pe;
  [c~, k_pe] = W_kva h;  c = RMSNorm(c~);
  [k_nope_i, v_i] = W_kvb,i c;
  score = (q_nope . k_nope + q_pe . k_pe) * s;  softmax;  out over v;  W_o.

q_pe and k_pe take RoPE with YaRN-scaled frequencies (``yarn_freqs``);
k_pe is one vector shared by every head.  The rotation turns each
*adjacent* pair (x_2j, x_2j+1) by pos * theta_j, in place: the layout
DeepSeek-V3's inference code rotates (``view_as_complex``), where the
port's ``layers.rope`` rotates halves.  Both q_pe and k_pe take the same
layout, so the scores do not depend on it.

- **Prefill** (``mla_prefill``) expands keys and values per head and
  runs ``scaled_dot_product_attention`` (v zero-padded to the qk width
  so that every SDPA backend takes the shapes).
- **Decode** (``mla_decode``) is the absorbed form: W_kvb's key half is
  folded into the query (q^ = W_kvb,k^T q_nope per head), the scores
  read the cached latent c and rotated k_pe directly, and W_kvb's value
  half is applied after the softmax-weighted sum of c.  The cache per
  layer is ``{"c": (B, L, kv_lora_rank), "kr": (B, L, qk_rope_head_dim)}``
  in the model's dtype: 1,152 bytes a token a layer in bf16 at Kimi-K2's
  widths, where expanded keys and values would take 40,960.  A step
  reads the cache up to its position, not the whole buffer.

Weights keep the port's ``(d_in, d_out)`` orientation.  ``wkv_b``'s
columns are per head ``[k_nope (qk_nope), v (v_head)]``, as the
published checkpoint lays ``kv_b_proj`` out.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from ..configs.base import MLAConfig
from ..obs.trace import scope
from .layers import normal_, rms_norm


def yarn_get_mscale(scale: float, mscale: float) -> float:
    return 1.0 if scale <= 1 else 0.1 * mscale * math.log(scale) + 1.0


def yarn_freqs(m: MLAConfig) -> torch.Tensor:
    """The (qk_rope_head_dim / 2,) f32 rotation frequencies: theta_j =
    rope_theta^(-2j/d), divided by ``rope_factor`` in proportion to a
    linear ramp between the correction dims of ``beta_fast`` and
    ``beta_slow`` (DeepSeek-V3's ``yarn_find_correction_range`` and
    ``yarn_linear_ramp_mask``)."""
    d, base = m.qk_rope_head_dim, m.rope_theta
    j = torch.arange(0, d, 2, dtype=torch.float64) / d
    extra = 1.0 / base ** j
    inter = extra / m.rope_factor       # factor 1: plain RoPE

    def dim(rotations: float) -> float:
        return d * math.log(m.rope_original_max / (rotations * 2 * math.pi)) \
            / (2 * math.log(base))

    low = max(math.floor(dim(m.beta_fast)), 0)
    high = min(math.ceil(dim(m.beta_slow)), d - 1)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(d // 2, dtype=torch.float64) - low)
            / (high - low)).clamp(0.0, 1.0)
    return (inter * ramp + extra * (1.0 - ramp)).float()


@functools.lru_cache(maxsize=16)
def _freqs_on(m: MLAConfig, device: torch.device) -> torch.Tensor:
    """``yarn_freqs`` on ``device``, made once: a step uploads nothing
    (an upload from pageable host memory waits for the device)."""
    with torch.inference_mode(False):
        return yarn_freqs(m).to(device)


def softmax_scale(m: MLAConfig) -> float:
    """qk_head_dim^-0.5, times mscale(factor, mscale_all_dim)^2 under
    YaRN (~0.13086 at Kimi-K2's widths)."""
    return m.qk_head_dim ** -0.5 * yarn_get_mscale(
        m.rope_factor, m.mscale_all_dim) ** 2


def rope_pairs(x: torch.Tensor, positions: torch.Tensor, m: MLAConfig
               ) -> torch.Tensor:
    """x (..., S, [H,] D) rotated pair by pair: (x_2j, x_2j+1) turns by
    positions * freq_j, times the YaRN amplitude (1 at Kimi-K2's mscale
    1/1).  ``positions`` broadcasts against x without its last dim:
    (S, 1) for (B, S, H, D), (S,) for (B, S, D).  Computed in f32,
    returned in x's dtype."""
    freqs = _freqs_on(m, x.device)
    amp = yarn_get_mscale(m.rope_factor, m.mscale) / yarn_get_mscale(
        m.rope_factor, m.mscale_all_dim)
    ang = positions[..., None].float() * freqs
    cos, sin = torch.cos(ang), torch.sin(ang)
    if amp != 1.0:
        cos, sin = cos * amp, sin * amp
    xf = x.float().unflatten(-1, (-1, 2))
    x0, x1 = xf[..., 0], xf[..., 1]
    out = torch.stack([x0 * cos - x1 * sin, x1 * cos + x0 * sin], dim=-1)
    return out.flatten(-2).to(x.dtype)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def mla_param_shapes(d_model: int, m: MLAConfig) -> dict:
    h = m.n_heads
    return {"wq_a": (d_model, m.q_lora_rank), "q_norm": (m.q_lora_rank,),
            "wq_b": (m.q_lora_rank, h * m.qk_head_dim),
            "wkv_a": (d_model, m.kv_lora_rank + m.qk_rope_head_dim),
            "kv_norm": (m.kv_lora_rank,),
            "wkv_b": (m.kv_lora_rank, h * (m.qk_nope_head_dim
                                           + m.v_head_dim)),
            "wo": (h * m.v_head_dim, d_model)}


def init_mla_params(p: dict, std: float, gen: torch.Generator) -> dict:
    """Norms at 1; every matrix N(0, std)."""
    p["q_norm"].fill_(1.0)
    p["kv_norm"].fill_(1.0)
    for name in ("wq_a", "wq_b", "wkv_a", "wkv_b", "wo"):
        normal_(p[name], std, gen)
    return p


def init_latent_cache(batch: int, max_len: int, m: MLAConfig, dtype,
                      device) -> dict:
    return {"c": torch.zeros((batch, max_len, m.kv_lora_rank), dtype=dtype,
                             device=device),
            "kr": torch.zeros((batch, max_len, m.qk_rope_head_dim),
                              dtype=dtype, device=device)}


def _query(p: dict, h: torch.Tensor, m: MLAConfig, positions, eps: float):
    """-> q_nope (B, S, H, nope), rotated q_pe (B, S, H, rope)."""
    b, s, _ = h.shape
    q = torch.einsum("bsd,dr->bsr", h, p["wq_a"])
    q = torch.einsum("bsr,re->bse", rms_norm(q, p["q_norm"], eps),
                     p["wq_b"]).view(b, s, m.n_heads, m.qk_head_dim)
    q_nope, q_pe = q.split([m.qk_nope_head_dim, m.qk_rope_head_dim], dim=-1)
    return q_nope, rope_pairs(q_pe, positions[:, None], m)


def _latent(p: dict, h: torch.Tensor, m: MLAConfig, positions, eps: float):
    """-> normed latent c (B, S, kv_lora_rank), rotated k_pe (B, S, rope)."""
    ckv = torch.einsum("bsd,dr->bsr", h, p["wkv_a"])
    c, k_pe = ckv.split([m.kv_lora_rank, m.qk_rope_head_dim], dim=-1)
    return rms_norm(c, p["kv_norm"], eps), rope_pairs(k_pe, positions, m)


# ---------------------------------------------------------------------------
# The two forms
# ---------------------------------------------------------------------------


def mla_prefill(p: dict, h: torch.Tensor, m: MLAConfig, *, eps: float):
    """A whole sequence in the expanded form, causal.  h (B, S, d) -> (out (B, S,
    d), c (B, S, kv_lora_rank), kr (B, S, rope)): the latent and rotated
    key to cache."""
    with scope("mla.prefill"):
        b, s, _ = h.shape
        hn, dn, dv = m.n_heads, m.qk_nope_head_dim, m.v_head_dim
        positions = torch.arange(s, device=h.device)
        q_nope, q_pe = _query(p, h, m, positions, eps)
        c, kr = _latent(p, h, m, positions, eps)
        kv = torch.einsum("bsc,ce->bse", c, p["wkv_b"]).view(b, s, hn,
                                                            dn + dv)
        k_nope, v = kv.split([dn, dv], dim=-1)
        q = torch.cat([q_nope, q_pe], dim=-1).transpose(1, 2)
        k = torch.cat([k_nope, kr[:, :, None].expand(b, s, hn, -1)],
                      dim=-1).transpose(1, 2)
        pad = m.qk_head_dim - dv
        vp = (F.pad(v, (0, pad)) if pad > 0 else v).transpose(1, 2)
        o = F.scaled_dot_product_attention(q, k, vp, is_causal=True,
                                           scale=softmax_scale(m))
        o = o[..., :dv].transpose(1, 2).reshape(b, s, hn * dv)
        return torch.einsum("bse,ed->bsd", o, p["wo"]), c, kr


def mla_decode(p: dict, h: torch.Tensor, cache: dict, step: int,
               m: MLAConfig, *, eps: float) -> torch.Tensor:
    """One token per row in the absorbed form.  h (B, 1, d); ``step``, a
    host int, is the position every row writes and reads up to.  The
    latent cache is written at ``step`` in place; the scores read
    positions 0..step only.  -> out (B, 1, d)."""
    with scope("mla.decode"):
        b = h.shape[0]
        length = cache["c"].shape[1]
        if not 0 <= step < length:
            raise ValueError(f"position {step} outside a latent cache of "
                             f"{length}")
        hn, dn, dv = m.n_heads, m.qk_nope_head_dim, m.v_head_dim
        positions = torch.full((1,), step, device=h.device)
        q_nope, q_pe = _query(p, h, m, positions, eps)
        c_new, kr_new = _latent(p, h, m, positions, eps)
        cache["c"][:, step] = c_new[:, 0]
        cache["kr"][:, step] = kr_new[:, 0]
        c, kr = cache["c"][:, :step + 1], cache["kr"][:, :step + 1]
        wkv = p["wkv_b"].view(m.kv_lora_rank, hn, dn + dv)
        wk, wv = wkv[..., :dn], wkv[..., dn:]
        # fold W_kvb's key half into the query: (B, H, kv_lora_rank)
        q_hat = torch.einsum("bhn,chn->bhc", q_nope[:, 0], wk)
        sc = softmax_scale(m)
        # scores laid out (B, L, H): each session's cache is the GEMM's
        # tall operand, which cuBLAS streams ~3x faster than as the wide
        # one of (B, H, L); the softmax runs on a (B, H, L) copy, and the
        # probabilities go back to (B, L, H) for the same reason
        scores = torch.bmm(kr, q_pe[:, 0].transpose(1, 2))     # (B, L, H)
        scores.baddbmm_(c, q_hat.transpose(1, 2), beta=sc, alpha=sc)
        # the softmax sums in f32 whatever its operand's type, and writes
        # the probabilities in the cache's type, which the next product
        # reads them in
        probs = torch.softmax(scores.transpose(1, 2).contiguous(), dim=-1)
        probs = probs.transpose(1, 2).contiguous()             # (B, L, H)
        o_lat = torch.bmm(probs.transpose(1, 2), c)            # (B, H, c)
        o = torch.einsum("bhc,chv->bhv", o_lat, wv).reshape(b, 1, hn * dv)
        return torch.einsum("bse,ed->bsd", o, p["wo"])
