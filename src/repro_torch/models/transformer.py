"""Decoder-only LM of the ``dense`` family, as a ``torch.nn.Module``.

The counterpart of ``repro.models.transformer.TransformerLM`` for the
attention layer kinds of the dense family:

  dense (qwen3, phi3):   ("A",) x n_layers
  gemma3:                ("L","L","L","L","L","G") x 8   (5:1 local:global)

``L`` layers attend within ``cfg.attn.window`` and keep a ring-buffer
KV cache of that length; ``A`` and ``G`` layers attend to the whole
context.  The reference stacks each pattern position's weights over
``n_groups`` and scans; the port keeps one module per layer in an
``nn.ModuleList`` (layer ``g * len(pattern) + i`` is the reference's
``groups/l{i}`` at group ``g``).  Weights keep the reference's
``(d_in, d_out)`` orientation, so ``repro_torch.convert`` carries them
across as plain copies.

The families of later slices raise ``NotImplementedError``: mamba2
layers (``M``), the hybrid's shared layer (``S``), MoE layers, the
vision prefix and the whisper encoder (ROADMAP.md §1 item 12), and the
training loss (item 13).

Serving state is a dict ``{"layers": [{"k", "v"} per layer], "step":
int}``; ``step`` is a host int, so a decode step needs no device-to-
host copy, and ``decode_step`` writes the cache tensors in place.
"""

from __future__ import annotations

import torch
from torch import nn

from .._device import as_tensor, resolve_device
from ..configs.base import ModelConfig
from .layers import (
    _project_qkv,
    attention_decode,
    attn_param_shapes,
    init_attn_params,
    init_kv_cache,
    init_mlp_params,
    mlp_block,
    mlp_param_shapes,
    normal_,
    rms_norm,
    self_attention,
)

ATTENTION_KINDS = ("A", "L", "G")

# what a config of each family needs beyond the dense path
_LATER = {
    "moe": "the MoE layers (models/moe.py)",
    "ssm": "the mamba2 layers (models/mamba2.py)",
    "hybrid": "the mamba2 layers and the shared attention layer S",
    "audio": "WhisperLM (models/whisper.py)",
    "vlm": "the vision-token prefix",
}


def unported(cfg: ModelConfig) -> str | None:
    """Why the port cannot build ``cfg`` yet, or None when it can."""
    if cfg.family != "dense":
        what = _LATER.get(cfg.family, f"family {cfg.family!r}")
    elif cfg.moe is not None:
        what = _LATER["moe"]
    elif set(cfg.pattern) - set(ATTENTION_KINDS):
        what = f"layer kinds {sorted(set(cfg.pattern) - set(ATTENTION_KINDS))}"
    else:
        return None
    return (f"{cfg.name}: the {cfg.family} family needs {what}, which the "
            "port has not yet (ROADMAP.md §1 item 12)")


def _params(shapes: dict, dtype, device) -> nn.ParameterDict:
    return nn.ParameterDict({
        name: nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                           requires_grad=False)
        for name, shape in shapes.items()})


def _vector(d: int, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty((d,), dtype=dtype, device=device),
                        requires_grad=False)


class Block(nn.Module):
    """One attention layer: pre-norm attention, then pre-norm FFN."""

    def __init__(self, cfg: ModelConfig, kind: str, dtype, device):
        super().__init__()
        d = cfg.d_model
        self.window = cfg.attn.window if kind == "L" else None
        self.norm1 = _vector(d, dtype, device)
        self.norm2 = _vector(d, dtype, device)
        self.attn = _params(attn_param_shapes(d, cfg.attn), dtype, device)
        self.mlp = _params(mlp_param_shapes(d, cfg.d_ff, cfg.act), dtype,
                           device)


class TransformerLM(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype=torch.float32, device=None):
        super().__init__()
        why = unported(cfg)
        if why is not None:
            raise NotImplementedError(why)
        dev = resolve_device(device)
        self.cfg = cfg
        self.dtype = dtype
        self.embed = nn.Parameter(
            torch.empty((cfg.vocab, cfg.d_model), dtype=dtype, device=dev),
            requires_grad=False)
        self.layers = nn.ModuleList(
            Block(cfg, cfg.pattern[i % len(cfg.pattern)], dtype, dev)
            for i in range(cfg.n_groups * len(cfg.pattern)))
        self.final_norm = _vector(cfg.d_model, dtype, dev)
        if not cfg.tie_embeddings:
            self.head = nn.Parameter(
                torch.empty((cfg.d_model, cfg.vocab), dtype=dtype,
                            device=dev), requires_grad=False)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    # -------------------- params --------------------

    @torch.no_grad()
    def init(self, gen: torch.Generator) -> dict:
        """Draw every weight from ``gen`` (a generator on the model's
        device) with the reference's distributions and scales, in place,
        and return the state dict.  The bits differ from
        ``jax.random``'s; parity goes through ``repro_torch.convert``."""
        cfg = self.cfg
        normal_(self.embed, 0.02, gen)
        for blk in self.layers:
            blk.norm1.fill_(1.0)
            blk.norm2.fill_(1.0)
            init_attn_params(blk.attn, cfg.d_model, cfg.attn, gen)
            init_mlp_params(blk.mlp, cfg.d_model, cfg.d_ff, cfg.act, gen)
        self.final_norm.fill_(1.0)
        if not cfg.tie_embeddings:
            normal_(self.head, 0.02, gen)
        return self.state_dict()

    # -------------------- forward --------------------

    def _embed(self, tokens) -> torch.Tensor:
        tokens = as_tensor(tokens, self.device).long()
        return self.embed[tokens].to(self.dtype)

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        x = rms_norm(x, self.final_norm, self.cfg.norm_eps)
        head = self.embed.T if self.cfg.tie_embeddings else self.head
        return torch.einsum("bsd,dv->bsv", x, head).float()

    def _layer(self, blk: Block, x: torch.Tensor, causal: bool):
        """One layer over a whole sequence -> (x, k, v)."""
        cfg = self.cfg
        b, s, _ = x.shape
        h = rms_norm(x, blk.norm1, cfg.norm_eps)
        positions = torch.arange(s, device=x.device)[None, :]
        q, k, v = _project_qkv(blk.attn, h, cfg.attn, positions, cfg.norm_eps)
        o = self_attention(q, k, v, causal=causal, window=blk.window,
                           impl=cfg.attn_impl, chunk=cfg.attn_chunk)
        x = x + torch.einsum("bse,ed->bsd", o.reshape(b, s, -1),
                             blk.attn["wo"])
        h = rms_norm(x, blk.norm2, cfg.norm_eps)
        return x + mlp_block(blk.mlp, h, cfg.act), k, v

    def forward(self, tokens) -> tuple[torch.Tensor, torch.Tensor]:
        """Full forward -> (logits (B, S, V) f32, aux)."""
        x = self._embed(tokens)
        for blk in self.layers:
            x, _, _ = self._layer(blk, x, self.cfg.attn.causal)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return self._logits(x), aux / self.cfg.n_layers

    # -------------------- serving --------------------

    def init_cache(self, batch: int, max_len: int) -> dict:
        return {"layers": [init_kv_cache(batch, max_len, self.cfg.attn,
                                         blk.window, self.dtype, self.device)
                           for blk in self.layers],
                "step": 0}

    def prefill(self, tokens, max_len: int) -> tuple[torch.Tensor, dict]:
        """Process a full prompt, build the decode cache -> (last logits
        (B, V), cache).  Window layers keep the last W keys in ring
        order, as the reference lays them out."""
        cfg = self.cfg
        x = self._embed(tokens)
        b, s, _ = x.shape
        caches = []
        for blk in self.layers:
            x, kk, vv = self._layer(blk, x, causal=True)
            window = blk.window
            length = min(window, max_len) if window else max_len
            if window and s > length:
                roll = s % length
                ck = torch.roll(kk[:, -length:], roll, dims=1).to(self.dtype)
                cv = torch.roll(vv[:, -length:], roll, dims=1).to(self.dtype)
            else:
                ck = torch.zeros((b, length, cfg.attn.n_kv_heads,
                                  cfg.attn.head_dim), dtype=self.dtype,
                                 device=x.device)
                cv = torch.zeros_like(ck)
                upto = min(s, length)
                ck[:, :upto] = kk[:, :upto]
                cv[:, :upto] = vv[:, :upto]
            caches.append({"k": ck, "v": cv})
        logits = self._logits(x[:, -1:, :])
        return logits[:, 0], {"layers": caches, "step": s}

    def decode_step(self, cache: dict, tokens) -> tuple[torch.Tensor, dict]:
        """One-token step.  tokens (B, 1) -> (logits (B, V), cache); the
        cache is advanced in place and returned."""
        cfg = self.cfg
        x = self._embed(tokens)
        step = cache["step"]
        for blk, c in zip(self.layers, cache["layers"]):
            h = rms_norm(x, blk.norm1, cfg.norm_eps)
            y, _ = attention_decode(blk.attn, h, c, step, cfg.attn,
                                    eps=cfg.norm_eps, window=blk.window)
            x = x + y
            h = rms_norm(x, blk.norm2, cfg.norm_eps)
            x = x + mlp_block(blk.mlp, h, cfg.act)
        logits = self._logits(x)
        return logits[:, 0], {"layers": cache["layers"], "step": step + 1}
