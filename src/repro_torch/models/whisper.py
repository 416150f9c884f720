"""Whisper-style encoder-decoder backbone (audio family), as a
``torch.nn.Module``.

The counterpart of ``repro.models.whisper.WhisperLM``.  The audio
frontend (log-mel + conv downsampling) is a stub: callers pass
precomputed frame embeddings (B, n_frames, d_model).  The backbone is a
bidirectional encoder and a causal decoder with cross-attention; RoPE
replaces Whisper's learned absolute positions, as in the reference.

The reference stacks the encoder's and the decoder's layers and scans;
the port keeps them in ``enc`` and ``layers`` (``nn.ModuleList``s),
layer j being the reference's ``enc`` / ``groups`` leaf at index j.
Serving state is ``{"layers": [{"k", "v", "xk", "xv"} per decoder
layer], "step": int}``: the self-attention cache and the encoder's
keys and values, projected once at prefill.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from .._device import as_tensor, resolve_device
from ..configs.base import ModelConfig
from ..parallel.ctx import reshape, shard
from .layers import (
    _project_qkv,
    attention_block,
    attention_decode,
    attention_plain,
    attn_param_shapes,
    embedding,
    init_attn_params,
    init_kv_cache,
    init_mlp_params,
    mlp_block,
    mlp_param_shapes,
    normal_,
    prefix_cache,
    rms_norm,
)
from .transformer import _params, _vector, sharded_cross_entropy


def _cross_attention(p, x, enc_kv, a):
    """x (B,Sq,d) queries against precomputed encoder K/V."""
    b, sq, _ = x.shape
    h, hd = a.n_heads, a.head_dim
    q = reshape(torch.einsum("bsd,de->bse", x, p["wq"]), b, sq, h, hd)
    k, v = enc_kv
    qpos = torch.zeros((sq,), dtype=torch.long, device=x.device)
    kpos = torch.zeros((k.shape[1],), dtype=torch.long, device=x.device)
    o = attention_plain(q, k, v, qpos, kpos, causal=False, window=None)
    return torch.einsum("bse,ed->bsd", reshape(o, b, sq, -1), p["wo"])


def _encode_kv(p, enc_out, a):
    b, f, _ = enc_out.shape
    kv, hd = a.n_kv_heads, a.head_dim
    k = reshape(torch.einsum("bsd,de->bse", enc_out, p["wk"]), b, f, kv, hd)
    v = reshape(torch.einsum("bsd,de->bse", enc_out, p["wv"]), b, f, kv, hd)
    return k, v


class EncoderLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        d = cfg.d_model
        self.norm1 = _vector(d, dtype, device)
        self.norm2 = _vector(d, dtype, device)
        self.attn = _params(attn_param_shapes(d, cfg.attn), dtype, device)
        self.mlp = _params(mlp_param_shapes(d, cfg.d_ff, cfg.act), dtype,
                           device)


class DecoderLayer(EncoderLayer):
    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__(cfg, dtype, device)
        d = cfg.d_model
        self.norm_x = _vector(d, dtype, device)
        self.xattn = _params(attn_param_shapes(d, cfg.attn), dtype, device)


class WhisperLM(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype=torch.float32, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.dtype = dtype
        d = cfg.d_model
        self.embed = nn.Parameter(
            torch.empty((cfg.vocab, d), dtype=dtype, device=dev),
            requires_grad=False)
        self.enc = nn.ModuleList(EncoderLayer(cfg, dtype, dev)
                                 for _ in range(cfg.encoder.n_layers))
        self.enc_norm = _vector(d, dtype, dev)
        self.layers = nn.ModuleList(DecoderLayer(cfg, dtype, dev)
                                    for _ in range(cfg.n_layers))
        self.final_norm = _vector(d, dtype, dev)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    @torch.no_grad()
    def init(self, gen: torch.Generator) -> dict:
        """Draw every weight from ``gen`` with the reference's
        distributions and scales, in place -> the state dict."""
        cfg = self.cfg
        d = cfg.d_model
        normal_(self.embed, 0.02, gen)
        for lyr in list(self.enc) + list(self.layers):
            lyr.norm1.fill_(1.0)
            lyr.norm2.fill_(1.0)
            init_attn_params(lyr.attn, d, cfg.attn, gen)
            if isinstance(lyr, DecoderLayer):
                lyr.norm_x.fill_(1.0)
                init_attn_params(lyr.xattn, d, cfg.attn, gen)
            init_mlp_params(lyr.mlp, d, cfg.d_ff, cfg.act, gen)
        self.enc_norm.fill_(1.0)
        self.final_norm.fill_(1.0)
        return self.state_dict()

    # -------------------- encoder --------------------

    def encode(self, frames) -> torch.Tensor:
        cfg = self.cfg
        bidir = dataclasses.replace(cfg.attn, causal=False)
        x = as_tensor(frames, self.device).to(self.dtype)
        for lyr in self.enc:
            h = rms_norm(x, lyr.norm1, cfg.norm_eps)
            x = x + attention_block(lyr.attn, h, bidir, eps=cfg.norm_eps,
                                    impl="plain")
            h = rms_norm(x, lyr.norm2, cfg.norm_eps)
            x = shard("resid", x + mlp_block(lyr.mlp, h, cfg.act))
        return rms_norm(x, self.enc_norm, cfg.norm_eps)

    # -------------------- decoder --------------------

    def _embed(self, tokens) -> torch.Tensor:
        tokens = as_tensor(tokens, self.device).long()
        return embedding(tokens, self.embed).to(self.dtype)

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        x = rms_norm(x, self.final_norm, self.cfg.norm_eps)
        return torch.einsum("bsd,dv->bsv", x, self.embed.T).float()

    def _cross_and_ffn(self, lyr: DecoderLayer, x, enc_kv):
        cfg = self.cfg
        h = rms_norm(x, lyr.norm_x, cfg.norm_eps)
        x = x + _cross_attention(lyr.xattn, h, enc_kv, cfg.attn)
        h = rms_norm(x, lyr.norm2, cfg.norm_eps)
        return x + mlp_block(lyr.mlp, h, cfg.act)

    def forward(self, tokens, frames) -> tuple[torch.Tensor, torch.Tensor]:
        """-> (logits (B, S, V) f32, aux = 0)."""
        cfg = self.cfg
        enc_out = self.encode(frames)
        x = self._embed(tokens)
        for lyr in self.layers:
            h = rms_norm(x, lyr.norm1, cfg.norm_eps)
            x = x + attention_block(lyr.attn, h, cfg.attn, eps=cfg.norm_eps,
                                    impl=cfg.attn_impl, chunk=cfg.attn_chunk)
            x = shard("resid", self._cross_and_ffn(
                lyr, x, _encode_kv(lyr.xattn, enc_out, cfg.attn)))
        return (shard("logits", self._logits(x)),
                torch.zeros((), dtype=torch.float32, device=x.device))

    def train_loss(self, batch: dict) -> torch.Tensor:
        """CE of the decoder's logits (the reference checkpoints no
        layer of this model)."""
        logits, _ = self(batch["tokens"], batch["frames"])
        return sharded_cross_entropy(
            logits, as_tensor(batch["labels"], self.device))

    # -------------------- serving --------------------

    def init_cache(self, batch: int, max_len: int) -> dict:
        cfg = self.cfg
        f = cfg.encoder.n_frames
        kv, hd = cfg.attn.n_kv_heads, cfg.attn.head_dim
        layers = []
        for _ in range(cfg.n_layers):
            c = init_kv_cache(batch, max_len, cfg.attn, None, self.dtype,
                              self.device)
            c["xk"] = torch.zeros((batch, f, kv, hd), dtype=self.dtype,
                                  device=self.device)
            c["xv"] = torch.zeros_like(c["xk"])
            layers.append(c)
        return {"layers": layers, "step": 0}

    def prefill(self, tokens, max_len: int, frames=None
                ) -> tuple[torch.Tensor, dict]:
        """Encode ``frames``, process the prompt, build the decode cache
        -> (last logits (B, V), cache)."""
        cfg = self.cfg
        enc_out = self.encode(frames)
        x = self._embed(tokens)
        b, s, _ = x.shape
        positions = torch.arange(s, device=x.device)
        caches = []
        for lyr in self.layers:
            h = rms_norm(x, lyr.norm1, cfg.norm_eps)
            q, kk, vv = _project_qkv(lyr.attn, h, cfg.attn, positions[None],
                                     cfg.norm_eps)
            o = attention_plain(q, kk, vv, positions, positions, causal=True)
            x = x + torch.einsum("bse,ed->bsd", reshape(o, b, s, -1),
                                 lyr.attn["wo"])
            xk, xv = _encode_kv(lyr.xattn, enc_out, cfg.attn)
            x = self._cross_and_ffn(lyr, x, (xk, xv))
            caches.append({"k": prefix_cache(kk, max_len, self.dtype),
                           "v": prefix_cache(vv, max_len, self.dtype),
                           "xk": xk.to(self.dtype), "xv": xv.to(self.dtype)})
        logits = self._logits(x[:, -1:])
        return logits[:, 0], {"layers": caches, "step": s}

    def decode_step(self, cache: dict, tokens) -> tuple[torch.Tensor, dict]:
        """One-token step.  tokens (B, 1) -> (logits (B, V), cache); the
        self-attention cache is advanced in place and returned."""
        cfg = self.cfg
        x = self._embed(tokens)
        step = cache["step"]
        for lyr, c in zip(self.layers, cache["layers"]):
            h = rms_norm(x, lyr.norm1, cfg.norm_eps)
            y, _ = attention_decode(lyr.attn, h, c, step, cfg.attn,
                                    eps=cfg.norm_eps)
            x = self._cross_and_ffn(lyr, x + y, (c["xk"], c["xv"]))
        logits = self._logits(x)
        return logits[:, 0], {"layers": cache["layers"], "step": step + 1}
