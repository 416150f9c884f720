"""DeepSeek Sparse Attention (DSA, DeepSeek-V3.2): the lightning indexer,
its key cache, and latent attention over the positions it selects.

Per layer, for a token at position p with normed input x and normed
query latent r = RMSNorm(W_qa x) (``mla._q_latent``):

  q_h = (W_qb r)_h,  h = 1..n_heads, each of head_dim;
  k   = LayerNorm(W_k x)  (weight, bias, eps 1e-6), cached per position;
  dims 0..rope-1 of q_h and k turn by RoPE at p with the layer's YaRN
  frequencies in halves (``rope_halves``), the rest are not rotated;
  w_h = (W_w x)_h * n_heads^-1/2 * head_dim^-1/2;
  I(p, s) = sum_h w_h ReLU(q_h . k_s),  s <= p  (p's key written first);
  S(p) = the top min(topk, p + 1) positions of I(p, .).

Latent attention's scores are -inf outside S(p), so its softmax and its
sum over values run over S(p) only, in prefill (each query its own S)
and in decode.  While p < topk, S(p) is every position up to p: those
queries take dense causal attention as they are.

- **Prefill** (``dsa_prefill``): the first ``topk`` queries through the
  expanded causal SDPA (``mla.expanded``); the later ones in chunks of
  queries (``chunk_rows``, sized by ``CHUNK_ELEMENTS`` so that a call of
  65,536 tokens fits beside a large cache), each chunk scoring every
  earlier key, taking each query's top-k, gathering its rows of ``[c |
  kr]`` and attending them in the absorbed form (``mla.absorbed``: every
  query one row).
- **Decode** (``dsa_decode``): the step's key written at ``step``, the
  cached keys 0..step scored (in whole ``KEY_BLOCK``s, the keys past
  ``step`` masked out), ``torch.topk`` on the card, each session's
  rows gathered into scratch of ``topk`` rows, and ``mla.absorbed`` over
  them.  The step's length is a host int: the host never waits.

The index that ``topk`` ranks is f32, as the published code's: the
per-head scores leave their product in the model's dtype, and the
weighted sum over heads accumulates and stays in f32 (a bf16 index holds
~3 digits, and over 32k keys many positions would tie the 2048th).

The cache per layer is ``{"c", "kr", "ik"}``: the latent, the rotated key
and the indexer's key (256 bytes a token in bf16 at head_dim 128).

Departures from the published code: no Hadamard rotation of q and k (it
is orthonormal, so q . k is unchanged in exact arithmetic, and exists
for the fp8 cast) and no fp8: the indexer runs in the model's dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import IndexerConfig, MLAConfig
from ..obs.trace import scope
from .layers import normal_
from .mla import (
    _freqs_on,
    _heads,
    _latent,
    _q_latent,
    absorbed,
    expanded,
    rope_amplitude,
    write_latent,
)

# the indexer key's LayerNorm eps (the published code's LayerNorm)
KEY_NORM_EPS = 1e-6
# a decode step's indexer scores the cached keys in whole blocks of this
# many positions, those past the step masked out: the per-head scores'
# rows keep a 16-byte-aligned length that changes once a block, not once
# a step (a row of odd length took GEMM kernels ~4.6 ms a step slower at
# DeepSeek-V3.2's widths, and each new length picked its kernels anew)
KEY_BLOCK = 256
# elements of a prefill chunk's largest intermediate (its per-head index
# scores or its gathered rows): 1 GB in bf16
CHUNK_ELEMENTS = 1 << 29


def indexer_param_shapes(d_model: int, m: MLAConfig, ix: IndexerConfig
                         ) -> dict:
    """``wq_b`` (q_lora_rank, heads x head_dim), ``wk`` (d, head_dim), the
    key's LayerNorm ``k_norm`` and ``k_bias``, ``w_proj`` (d, heads): the
    published ``wq_b``, ``wk``, ``k_norm`` and ``weights_proj``."""
    return {"wq_b": (m.q_lora_rank, ix.n_heads * ix.head_dim),
            "wk": (d_model, ix.head_dim), "k_norm": (ix.head_dim,),
            "k_bias": (ix.head_dim,), "w_proj": (d_model, ix.n_heads)}


def init_indexer_params(p: dict, std: float, gen: torch.Generator) -> dict:
    """The LayerNorm's weight 1 and bias 0; every matrix N(0, std)."""
    p["k_norm"].fill_(1.0)
    p["k_bias"].zero_()
    for name in ("wq_b", "wk", "w_proj"):
        normal_(p[name], std, gen)
    return p


def rope_halves(x: torch.Tensor, positions: torch.Tensor, m: MLAConfig
                ) -> torch.Tensor:
    """x (..., S, [H,] D) with its first ``qk_rope_head_dim`` dims turned
    in halves: (x_j, x_j+rope/2) by positions * freq_j, times the YaRN
    amplitude; the other dims as they are.  ``positions`` broadcasts as
    in ``mla.rope_pairs``.  Computed in f32, returned in x's dtype."""
    r = m.qk_rope_head_dim
    ang = positions[..., None].float() * _freqs_on(m, x.device)
    cos, sin = torch.cos(ang), torch.sin(ang)
    amp = rope_amplitude(m)
    if amp != 1.0:
        cos, sin = cos * amp, sin * amp
    x1, x2 = x[..., :r].float().chunk(2, dim=-1)
    turned = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return torch.cat([turned.to(x.dtype), x[..., r:]], dim=-1)


def index_keys(p: dict, h: torch.Tensor, positions: torch.Tensor,
               m: MLAConfig) -> torch.Tensor:
    """The indexer's keys to cache: h (B, S, d) -> (B, S, head_dim)."""
    k = torch.einsum("bsd,de->bse", h, p["wk"])
    k = F.layer_norm(k.float(), k.shape[-1:], p["k_norm"].float(),
                     p["k_bias"].float(), KEY_NORM_EPS).to(h.dtype)
    return rope_halves(k, positions, m)


def index_topk(p: dict, qr: torch.Tensor, h: torch.Tensor,
               keys: torch.Tensor, first, m: MLAConfig,
               ix: IndexerConfig) -> torch.Tensor:
    """The positions each query attends: the top ``ix.topk`` of I(p, s)
    over the cached ``keys`` (B, L, head_dim), where a query at position
    p scores the keys s <= p.  qr (B, n, q_lora_rank) and h (B, n, d) are
    the latent and input of the queries at positions ``first`` (a host
    int, or a (1,) int64 tensor on the device; at least ``ix.topk``) to
    ``first + n - 1``.  -> (B, n, topk) int64, in no order.  The per-head
    scores are (B, n x heads, L) in the model's dtype, summed over the
    heads by one batched product into the f32 index (B, n, L)."""
    b, n, _ = h.shape
    hn, hd = ix.n_heads, ix.head_dim
    on_host = not isinstance(first, torch.Tensor)
    positions = (torch.arange(first, first + n, device=h.device) if on_host
                 else first + torch.arange(n, device=h.device))
    q = torch.einsum("bsr,re->bse", qr, p["wq_b"]).view(b, n, hn, hd)
    q = rope_halves(q, positions[:, None], m)
    w = torch.einsum("bsd,dh->bsh", h, p["w_proj"])
    scores = torch.bmm(q.reshape(b, n * hn, hd), keys.transpose(1, 2))
    scores.relu_()
    index = _f32_bmm(w.reshape(b * n, 1, hn), scores.view(b * n, hn, -1))
    index = index.view(b, n, -1).mul_((hn * hd) ** -0.5)
    length = keys.shape[1]
    if not on_host or length > first + 1:   # keys past a query: masked
        later = (torch.arange(length, device=h.device)[None, :]
                 > positions[:, None])
        index.masked_fill_(later, float("-inf"))
    return index.topk(ix.topk, dim=-1, sorted=False).indices


def _f32_bmm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.bmm`` -> f32: on the card the product of bf16 operands
    leaves its f32 accumulator unrounded (``out_dtype``); elsewhere the
    operands are widened first (a no-op for f32)."""
    if a.is_cuda and a.dtype != torch.float32:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def select_rows(chosen: torch.Tensor, *ts: torch.Tensor) -> list:
    """Each t (B, L, D)'s rows at ``chosen`` (B, n, k) -> (B x n, k, D):
    one ``index_select`` of its flattened rows."""
    b, n, k = chosen.shape
    flat = (chosen + (torch.arange(b, device=chosen.device)
                      * ts[0].shape[1])[:, None, None]).reshape(-1)
    return [t.reshape(-1, t.shape[-1]).index_select(0, flat).view(b * n, k,
                                                                  -1)
            for t in ts]


def chunk_rows(batch: int, length: int, m: MLAConfig, ix: IndexerConfig
               ) -> int:
    """Queries a prefill chunk takes: as many as keep its per-head index
    scores (batch x rows x heads x length) and its gathered rows (batch x
    rows x topk x (kv_lora_rank + rope)) within ``CHUNK_ELEMENTS``."""
    per = max(ix.n_heads * length,
              ix.topk * (m.kv_lora_rank + m.qk_rope_head_dim))
    return max(1, CHUNK_ELEMENTS // (batch * per))


def dsa_prefill(p: dict, h: torch.Tensor, m: MLAConfig, ix: IndexerConfig,
                *, eps: float):
    """A whole sequence, each query over its selected positions.  h (B, S,
    d) -> (out (B, S, d), its cache {"c", "kr", "ik"} (B, S, .))."""
    with scope("mla.prefill"):
        b, s, d = h.shape
        positions = torch.arange(s, device=h.device)
        qr = _q_latent(p, h, eps)
        q_nope, q_pe = _heads(p, qr, m, positions)
        c, kr = _latent(p, h, m, positions, eps)
        with scope("mla.index"):
            ik = index_keys(p["indexer"], h, positions, m)
        first = min(s, ix.topk)
        out = h.new_empty((b, s, d))
        out[:, :first] = expanded(p, q_nope[:, :first], q_pe[:, :first],
                                  c[:, :first], kr[:, :first], m)
        rows = chunk_rows(b, s, m, ix)
        for lo in range(first, s, rows):
            hi = min(s, lo + rows)
            n = hi - lo
            with scope("mla.index"):
                chosen = index_topk(p["indexer"], qr[:, lo:hi], h[:, lo:hi],
                                    ik[:, :hi], lo, m, ix)
            with scope("mla.select"):
                c_sel, kr_sel = select_rows(chosen, c, kr)
            o = absorbed(p, q_nope[:, lo:hi].reshape(b * n, 1, m.n_heads, -1),
                         q_pe[:, lo:hi].reshape(b * n, 1, m.n_heads, -1),
                         c_sel, kr_sel, ix.topk, m)
            out[:, lo:hi] = o.view(b, n, d)
        return out, {"c": c, "kr": kr, "ik": ik}


def dsa_decode(p: dict, h: torch.Tensor, cache: dict, step,
               m: MLAConfig, ix: IndexerConfig, *, eps: float
               ) -> torch.Tensor:
    """One token per row over its selected positions.  h (B, 1, d);
    ``step``, a host int, is the position every row writes.  The cache
    ``{"c", "kr", "ik"}`` is written at ``step`` in place; the indexer
    scores positions 0..step and attention reads the top ``ix.topk`` of
    them (all of them while step < topk).  ``step`` may instead be the
    position on the device, (1,) int64, at least ``ix.topk`` (a CUDA
    graph's, ``decode_graph.py``): the indexer then scores every position
    of the cache, those past the step masked out, so that the step's
    shapes do not depend on it.  -> (out (B, 1, d), the positions each
    row attended (B, 1, topk) in no order, or None where it attended
    every position)."""
    with scope("mla.decode"):
        positions = write_latent(p, h, cache, step, m, eps)
        qr = _q_latent(p, h, eps)
        q_nope, q_pe = _heads(p, qr, m, positions)
        on_host = not isinstance(step, torch.Tensor)
        c, kr = cache["c"], cache["kr"]
        length = step + 1 if on_host else None
        chosen = None
        with scope("mla.index"):
            keys = index_keys(p["indexer"], h, positions, m)
            span = cache["ik"].shape[1]
            if on_host:
                cache["ik"][:, step] = keys[:, 0]
                span = min(span, -(-length // KEY_BLOCK) * KEY_BLOCK)
            else:
                cache["ik"].index_copy_(1, step, keys)
            if not on_host or length > ix.topk:
                chosen = index_topk(p["indexer"], qr, h,
                                    cache["ik"][:, :span], step, m, ix)
        if chosen is not None:
            with scope("mla.select"):
                c, kr = select_rows(chosen, c, kr)
            length = chosen.shape[-1]
        return absorbed(p, q_nope, q_pe, c, kr, length, m), chosen
