"""Neural-net building blocks of the model zoo, in plain PyTorch.

The counterpart of ``repro.models.layers``: the same functions on
tensors, with the reference's arithmetic kept step for step so that a
model's logits match the JAX package's given the same weights (f32
within 2e-5).  Weights keep the reference's orientation, ``(d_in,
d_out)`` used as ``x @ w``.

Attention comes in two implementations, as in the reference:
  * ``plain``    -- full-score einsum with mask; used for short
                    sequences and single-token decode.
  * ``chunked``  -- flash-style online softmax over query / key chunks;
                    the prefill takes it past 2048 tokens.
Both support GQA (grouped einsum, no KV repetition), causal masking,
sliding windows and qk-norm.  Scores, softmax and both products run in
f32 (the reference's ``preferred_element_type=jnp.float32``): bf16
operands are widened before the product, which is exact, so a bf16
model rounds only where the reference does.  ``scaled_dot_product_
attention`` is not used: it orders the arithmetic differently.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..configs.base import AttnConfig
from ..parallel.ctx import _is_dtensor, per_head, psum, reshape, shard

# ---------------------------------------------------------------------------
# Norms, activations, embeddings
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * w).to(dtype)


def swiglu(x: torch.Tensor, w_gate, w_up, w_down) -> torch.Tensor:
    g = torch.einsum("...d,df->...f", x, w_gate)
    u = torch.einsum("...d,df->...f", x, w_up)
    return torch.einsum("...f,fd->...d", F.silu(g) * u, w_down)


def gelu_mlp(x: torch.Tensor, w_up, w_down) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return torch.einsum("...f,fd->...d", F.gelu(
        torch.einsum("...d,df->...f", x, w_up), approximate="tanh"), w_down)


def embedding(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """``table[tokens]`` (``F.embedding``).

    On a mesh whose table is vocab-parallel (its rows sharded), the
    lookup runs on each rank's local shards (``local_map``): a rank
    looks up the tokens its rows hold, writes zeros for the rest, and
    one sum over the table's shard axes gives every rank the rows
    (Megatron's vocab-parallel embedding).  DTensor's own lowering
    leaves a masked partial sum instead, which it can neither add to
    another partial nor take a partial gradient back into.  The output
    keeps the tokens' batch shard; the table's gradient is its own
    shard, partial over the batch's axes."""
    if not _is_dtensor(table):
        return F.embedding(tokens, table)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard  # noqa: PLC0415
    from torch.distributed.tensor.experimental import local_map  # noqa: PLC0415

    vocab_dims = [i for i, pl in enumerate(table.placements)
                  if isinstance(pl, Shard) and pl.dim == 0]
    if not vocab_dims:
        return F.embedding(tokens, table)

    mesh = table.device_mesh
    if not isinstance(tokens, DTensor):
        tokens = DTensor.from_local(tokens, mesh, [Replicate()] * mesh.ndim,
                                    run_check=False)
    tok_in, w_in, w_grad = [], [], []
    for i, (tp, wp) in enumerate(zip(tokens.placements, table.placements)):
        batch = isinstance(tp, Shard) and tp.dim == 0 and i not in vocab_dims
        tok_in.append(Shard(0) if batch else Replicate())
        w_in.append(Shard(0) if i in vocab_dims else Replicate())
        w_grad.append(Shard(0) if i in vocab_dims
                      else Partial() if batch else Replicate())
    rows = table.shape[0]
    coord = mesh.get_coordinate()
    offset = 0
    for i in vocab_dims:
        rows //= mesh.size(i)
        offset = offset * mesh.size(i) + coord[i]
    offset *= rows
    groups = [mesh.get_group(i) for i in vocab_dims]

    def lookup(tok, w):
        local = tok - offset
        inside = (local >= 0) & (local < rows)
        y = F.embedding(torch.where(inside, local, 0), w)
        y = torch.where(inside[..., None], y, y.new_zeros(()))
        for group in groups:
            y = psum(y, group)
        return y

    run = local_map(lookup, out_placements=(tuple(tok_in),),
                    in_placements=(tuple(tok_in), tuple(w_in)),
                    in_grad_placements=(tuple(tok_in), tuple(w_grad)),
                    device_mesh=mesh, redistribute_inputs=True)
    return run(tokens, table)


def sinusoidal_positions(n: int, d: int) -> np.ndarray:
    pos = np.arange(n)[:, None]
    dim = np.arange(d // 2)[None, :]
    ang = pos / np.power(10000.0, 2 * dim / d)
    return np.concatenate([np.sin(ang), np.cos(ang)], axis=-1).astype(np.float32)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """x: (..., S, H, D), positions: broadcastable to (..., S)."""
    d = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                          device=x.device) / d))
    ang = positions[..., None].float() * freqs              # (..., S, D/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x, 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention parameters
# ---------------------------------------------------------------------------


def normal_(t: torch.Tensor, scale: float, gen: torch.Generator
            ) -> torch.Tensor:
    """Fill ``t`` with N(0, 1) draws in its own dtype, then scale them in
    that dtype, as ``jax.random.normal(k, shape, dtype) * scale`` does."""
    return t.normal_(generator=gen).mul_(scale)


def attn_param_shapes(d_model: int, a: AttnConfig) -> dict:
    h, kv, hd = a.n_heads, a.n_kv_heads, a.head_dim
    shapes = {"wq": (d_model, h * hd), "wk": (d_model, kv * hd),
              "wv": (d_model, kv * hd), "wo": (h * hd, d_model)}
    if a.qk_norm:
        shapes["q_norm"] = shapes["k_norm"] = (hd,)
    return shapes


def init_attn_params(p: dict, d_model: int, a: AttnConfig,
                     gen: torch.Generator) -> dict:
    """Draw an attention layer's weights into the tensors of ``p`` (the
    reference's ``init_attn_params``: N(0, 1/d_model), norms at 1)."""
    scale = d_model ** -0.5
    for name in ("wq", "wk", "wv", "wo"):
        normal_(p[name], scale, gen)
    if a.qk_norm:
        p["q_norm"].fill_(1.0)
        p["k_norm"].fill_(1.0)
    return p


def _project_qkv(p: dict, x: torch.Tensor, a: AttnConfig,
                 positions: torch.Tensor, eps: float):
    b, s, _ = x.shape
    h, kv, hd = a.n_heads, a.n_kv_heads, a.head_dim
    q = reshape(torch.einsum("bsd,de->bse", x, p["wq"]), b, s, h, hd)
    k = reshape(torch.einsum("bsd,de->bse", x, p["wk"]), b, s, kv, hd)
    v = reshape(torch.einsum("bsd,de->bse", x, p["wv"]), b, s, kv, hd)
    # sharding cut point (the reference's): pins the q/k/v layout once
    q, k, v = shard("attn_q", q), shard("attn_kv", k), shard("attn_kv", v)
    if a.qk_norm:
        q = rms_norm(q, p["q_norm"], eps)
        k = rms_norm(k, p["k_norm"], eps)
    q = rope(q, positions, a.rope_theta)
    k = rope(k, positions, a.rope_theta)
    return q, k, v


# ---------------------------------------------------------------------------
# Plain attention (short sequences, decode)
# ---------------------------------------------------------------------------


def _mask_bias(qpos: torch.Tensor, kpos: torch.Tensor, causal: bool,
               window: int | None) -> torch.Tensor:
    """(..., Sq, Sk) additive bias from position tensors."""
    ok = torch.ones(torch.broadcast_shapes(qpos[..., :, None].shape,
                                           kpos[..., None, :].shape),
                    dtype=torch.bool, device=qpos.device)
    if causal:
        ok &= kpos[..., None, :] <= qpos[..., :, None]
    if window is not None:
        ok &= qpos[..., :, None] - kpos[..., None, :] < window
    zero = torch.zeros((), dtype=torch.float32, device=qpos.device)
    return torch.where(ok, zero, -math.inf)


@per_head
def attention_plain(q, k, v, qpos, kpos, causal=True, window=None):
    """q (B,Sq,H,D), k/v (B,Sk,KV,D) -> (B,Sq,H,D).  GQA via grouping."""
    b, sq, h, d = q.shape
    kvh = k.shape[2]
    g = h // kvh
    qg = reshape(q, b, sq, kvh, g, d)
    scores = torch.einsum("bqkgd,bpkd->bkgqp", qg.float(), k.float()) \
        * (d ** -0.5)
    bias = _mask_bias(qpos, kpos, causal, window)      # (B?, Sq, Sk)
    scores = scores + bias[..., None, None, :, :] if bias.ndim == 3 \
        else scores + bias[None, None, None, :, :]
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqp,bpkd->bqkgd", w.to(v.dtype).float(), v.float())
    return reshape(out, b, sq, h, d).to(q.dtype)


# ---------------------------------------------------------------------------
# Chunked flash-style attention (prefill at long context)
# ---------------------------------------------------------------------------


@per_head
def attention_chunked(q, k, v, causal=True, window=None, chunk=512):
    """Online-softmax over query and key chunks.  q (B,S,H,D), k/v
    (B,S,KV,D).

    Memory per step: one (B, KV, G, qc, kc) score tile.  Every key chunk
    is visited with masking, as in the reference's double scan.
    """
    b, s, h, d = q.shape
    kvh = k.shape[2]
    g = h // kvh
    qc = min(chunk, s)
    if s % qc:
        raise ValueError(f"S={s} not a multiple of chunk={qc}")
    nq = s // qc
    scale = d ** -0.5
    dev = q.device
    qg = reshape(q, b, nq, qc, kvh, g, d)
    kc_ = reshape(k, b, nq, qc, kvh, d)
    vc_ = reshape(v, b, nq, qc, kvh, d)
    ar = torch.arange(qc, device=dev)
    outs = []
    for iq in range(nq):
        qblk = qg[:, iq].float()                        # (b,qc,kv,g,d)
        qpos = iq * qc + ar
        m = torch.full((b, kvh, g, qc), -math.inf, device=dev)
        l_ = torch.zeros((b, kvh, g, qc), device=dev)
        acc = torch.zeros((b, kvh, g, qc, d), device=dev)
        for jk in range(nq):
            kblk, vblk = kc_[:, jk], vc_[:, jk]
            kpos = jk * qc + ar
            sc = torch.einsum("bqkgd,bpkd->bkgqp", qblk, kblk.float()) * scale
            ok = kpos[None, :] <= qpos[:, None] if causal else \
                torch.ones((qc, qc), dtype=torch.bool, device=dev)
            if window is not None:
                ok &= qpos[:, None] - kpos[None, :] < window
            sc = torch.where(ok[None, None, None], sc, -math.inf)
            m_new = torch.maximum(m, sc.amax(dim=-1))
            # guard fully-masked rows (m_new = -inf)
            m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
            p = torch.exp(sc - m_safe[..., None])
            corr = torch.exp(torch.where(torch.isfinite(m), m - m_safe,
                                         -math.inf))
            l_ = l_ * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgqp,bpkd->bkgqd", p.to(vblk.dtype).float(), vblk.float())
            m = m_new
        out = acc / torch.clamp(l_[..., None], min=1e-30)   # (b,kv,g,qc,d)
        outs.append(out.permute(0, 3, 1, 2, 4))             # (b,qc,kv,g,d)
    out = reshape(torch.cat(outs, dim=1), b, s, h, d)
    return out.to(q.dtype)


def use_chunked(impl: str, s: int, chunk: int) -> bool:
    """The reference's pick: chunked when asked, or past 2048 tokens,
    and only when the chunk divides the sequence."""
    wanted = impl == "chunked" or (impl == "auto" and s > 2048)
    return wanted and s % min(chunk, s) == 0


def self_attention(q, k, v, *, causal: bool, window: int | None,
                   impl: str, chunk: int) -> torch.Tensor:
    """Attention of a whole sequence over itself, plain or chunked."""
    s = q.shape[1]
    if use_chunked(impl, s, chunk):
        return attention_chunked(q, k, v, causal=causal, window=window,
                                 chunk=chunk)
    pos = torch.arange(s, device=q.device)
    return attention_plain(q, k, v, pos, pos, causal=causal, window=window)


# ---------------------------------------------------------------------------
# Full attention block (train/prefill path)
# ---------------------------------------------------------------------------


def attention_block(p: dict, x: torch.Tensor, a: AttnConfig, *, eps: float,
                    impl: str = "auto", chunk: int = 512,
                    window: int | None = None) -> torch.Tensor:
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None, :]
    q, k, v = _project_qkv(p, x, a, positions, eps)
    out = self_attention(q, k, v, causal=a.causal, window=window, impl=impl,
                         chunk=chunk)
    return torch.einsum("bse,ed->bsd", reshape(out, b, s, -1), p["wo"])


# ---------------------------------------------------------------------------
# Decode-step attention with KV cache (full-context and ring-buffer window)
# ---------------------------------------------------------------------------


def init_kv_cache(batch: int, max_len: int, a: AttnConfig, window: int | None,
                  dtype=torch.float32, device=None) -> dict:
    length = min(window, max_len) if window else max_len
    shape = (batch, length, a.n_kv_heads, a.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def prefix_cache(kv: torch.Tensor, length: int, dtype) -> torch.Tensor:
    """A cache of ``length`` slots holding the first keys or values of
    ``kv`` (B, S, KV, D), zeros after, built out of place: on a mesh it
    is then a DTensor laid out as ``kv`` (DTensor refuses a write into a
    plain buffer)."""
    upto = min(kv.shape[1], length)
    out = kv[:, :upto].to(dtype).contiguous()
    if upto == length:
        return out
    return torch.cat([out, out.new_zeros(
        (out.shape[0], length - upto) + tuple(out.shape[2:]))], dim=1)


def ring_cache(kv: torch.Tensor, length: int, roll: int, dtype
               ) -> torch.Tensor:
    """The last ``length`` keys or values of ``kv`` (B, S, KV, D) laid
    out as a ring buffer whose next slot is ``roll``: ``torch.roll`` of
    them by ``roll`` along the sequence, as two slices (DTensor in torch
    2.11 has no rule for ``roll``)."""
    tail = kv[:, -length:]
    return torch.cat([tail[:, length - roll:], tail[:, :length - roll]],
                     dim=1).to(dtype)


def attention_decode(p: dict, x: torch.Tensor, cache: dict, step: int,
                     a: AttnConfig, *, eps: float,
                     window: int | None = None) -> tuple[torch.Tensor, dict]:
    """One-token attention.  x (B,1,d); ``step`` (a host int) = current
    position.

    Full-context layers write the cache at ``step``; window layers use a
    ring buffer of size W with slot = step mod W.  The cache tensors are
    written in place and returned.
    """
    b = x.shape[0]
    dev = x.device
    # one position for every row (broadcast): no batch dim, so a mesh's
    # attention can run on each rank's rows (ctx.per_head)
    positions = torch.full((1, 1), step, device=dev)
    q, k_new, v_new = _project_qkv(p, x, a, positions, eps)
    ck, cv = cache["k"], cache["v"]
    length = ck.shape[1]
    # the reference's dynamic_update_slice clamps a start past the end
    slot = step % length if window else min(step, length - 1)
    ck[:, slot] = k_new[:, 0].to(ck.dtype)
    cv[:, slot] = v_new[:, 0].to(cv.dtype)
    ck, cv = shard("attn_kv", ck), shard("attn_kv", cv)

    idx = torch.arange(length, device=dev)
    if window:
        # absolute position of ring slot j after writing at `slot`
        kpos = torch.where(idx <= slot, step - slot + idx,
                           step - slot - length + idx)
        valid = kpos >= max(0, step - length + 1)
        kpos = torch.where(valid, kpos, step + 1)  # invalid -> future -> masked
    else:
        kpos = torch.where(idx <= step, idx, step + 1)
    out = attention_plain(q, ck, cv, positions, kpos[None, :],
                          causal=True, window=window)
    y = torch.einsum("bse,ed->bsd", reshape(out, b, 1, -1), p["wo"])
    return y, {"k": ck, "v": cv}


# ---------------------------------------------------------------------------
# FFN params
# ---------------------------------------------------------------------------


def mlp_param_shapes(d_model: int, d_ff: int, act: str) -> dict:
    if act == "swiglu":
        return {"w_gate": (d_model, d_ff), "w_up": (d_model, d_ff),
                "w_down": (d_ff, d_model)}
    return {"w_up": (d_model, d_ff), "w_down": (d_ff, d_model)}


def init_mlp_params(p: dict, d_model: int, d_ff: int, act: str,
                    gen: torch.Generator) -> dict:
    """Draw an FFN's weights into the tensors of ``p`` (the reference's
    scales: 1/sqrt(d_model) into the hidden width, 1/sqrt(d_ff) out)."""
    scale_in, scale_out = d_model ** -0.5, d_ff ** -0.5
    for name in mlp_param_shapes(d_model, d_ff, act):
        normal_(p[name], scale_out if name == "w_down" else scale_in, gen)
    return p


def mlp_block(p: dict, x: torch.Tensor, act: str) -> torch.Tensor:
    if act == "swiglu":
        return swiglu(x, p["w_gate"], p["w_up"], p["w_down"])
    return gelu_mlp(x, p["w_up"], p["w_down"])
