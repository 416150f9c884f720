"""Unified decoder-only LM covering the dense / moe / ssm / hybrid / vlm
families, as a ``torch.nn.Module``.

The counterpart of ``repro.models.transformer.TransformerLM``.  The
layer stack repeats a *pattern* of layer kinds ``n_groups`` times:

  dense (qwen3, phi3):   ("A",) x n_layers
  gemma3:                ("L","L","L","L","L","G") x 8   (5:1 local:global)
  mamba2:                ("M",) x 48
  zamba2:                ("M","M","M","M","M","S") x 9   (S = shared block)

``L`` layers attend within ``cfg.attn.window`` and keep a ring-buffer
KV cache of that length; ``A``, ``G`` and ``S`` layers attend to the
whole context; ``M`` layers are Mamba-2 (SSD) blocks.  With ``cfg.moe``
every attention layer but ``S`` has an MoE FFN (``moe``) in place of
its dense one (``mlp``).  ``S`` is the hybrid's shared attention layer:
one ``Block`` (the module's ``shared``) applied at every ``S`` position
with the same weights, each position keeping its own KV cache.  A vlm
config prepends ``image_embeds`` (the stub CLIP tokens) to the token
embeddings.

The reference stacks each pattern position's weights over ``n_groups``
and scans; the port keeps one module per layer in an ``nn.ModuleList``
(layer ``g * len(pattern) + i`` is the reference's ``groups/l{i}`` at
group ``g``; an ``S`` position holds an empty ``SharedSlot``).  Weights
keep the reference's ``(d_in, d_out)`` orientation, so
``repro_torch.convert`` carries them across as plain copies.

Every parameter is built frozen (``requires_grad=False``): serving runs
under ``torch.inference_mode``.  The trainer turns grad on
(``model.requires_grad_(True)``) and calls ``train_loss``; while grad
is enabled, ``forward`` checkpoints each layer as ``cfg.remat`` says
(the reference's ``_maybe_remat``).

Serving state is a dict ``{"layers": [per-layer cache], "step": int}``:
``{"k", "v"}`` for an attention layer, ``{"conv", "state"}`` for a
mamba layer.  ``step`` is a host int, so a decode step needs no
device-to-host copy, and ``decode_step`` writes the cache tensors in
place.
"""

from __future__ import annotations

import functools

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .._device import as_tensor, resolve_device
from ..configs.base import ModelConfig
from ..parallel.ctx import reshape, shard
from .layers import (
    _project_qkv,
    attention_decode,
    attn_param_shapes,
    embedding,
    init_attn_params,
    init_kv_cache,
    init_mlp_params,
    mlp_block,
    mlp_param_shapes,
    normal_,
    prefix_cache,
    ring_cache,
    rms_norm,
    self_attention,
)
from .mamba2 import (
    F32_PARAMS,
    init_mamba_cache,
    init_mamba_params,
    mamba_block,
    mamba_decode_step,
    mamba_param_shapes,
    mamba_prefill,
)
from .moe import init_moe_params, moe_apply, moe_param_shapes

LAYER_KINDS = ("A", "L", "G", "S", "M")


# ---------------------------------------------------------------------------
# Sharded cross-entropy
# ---------------------------------------------------------------------------


def sharded_cross_entropy(logits: torch.Tensor, labels: torch.Tensor
                          ) -> torch.Tensor:
    """The reference's CE, reduction for reduction: a max taken without
    gradient, log-sum-exp of the shifted logits, the label's logit
    picked by a one-hot multiply-reduce, and labels < 0 masked out.  On
    a mesh the logits' vocab dim may be sharded (``shard("logits")``):
    DTensor lowers each reduction to its shards."""
    logits = logits.float()
    labels = labels.long()
    zmax = logits.max(dim=-1, keepdim=True).values.detach()
    shifted = logits - zmax
    lse = torch.log(torch.sum(torch.exp(shifted), dim=-1)) + zmax[..., 0]
    # jax.nn.one_hot: all zeros for a label outside [0, V)
    onehot = (labels[..., None] == torch.arange(
        logits.shape[-1], device=logits.device)).to(logits.dtype)
    label_logit = torch.sum(logits * onehot, dim=-1)
    ce = lse - label_logit
    mask = (labels >= 0).to(torch.float32)
    return (ce * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def remat_layer(fn, mode: str, x: torch.Tensor):
    """``fn(x)`` with activation checkpointing per ``mode`` while grad is
    enabled (the reference's ``_maybe_remat``): "full" recomputes the
    layer in the backward pass, so only the residual stream crosses
    layer boundaries.  "dots" (the reference keeps matmul outputs and
    recomputes the rest) is taken as "full": the values are the same
    either way, and the stable checkpoint API has no save policy by op
    kind.  "none", and any call with grad off, runs ``fn`` as is."""
    if mode == "none" or not torch.is_grad_enabled():
        return fn(x)
    return checkpoint(fn, x, use_reentrant=False)


def _params(shapes: dict, dtype, device, f32: tuple = ()
            ) -> nn.ParameterDict:
    """Frozen parameters of ``shapes`` (a nested dict becomes a nested
    ``ParameterDict``); the names in ``f32`` are f32 whatever ``dtype``."""
    out = {}
    for name, shape in shapes.items():
        if isinstance(shape, dict):
            out[name] = _params(shape, dtype, device)
        else:
            out[name] = nn.Parameter(
                torch.empty(shape, dtype=torch.float32 if name in f32
                            else dtype, device=device),
                requires_grad=False)
    return nn.ParameterDict(out)


def _vector(d: int, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty((d,), dtype=dtype, device=device),
                        requires_grad=False)


class Block(nn.Module):
    """One attention layer: pre-norm attention, then a pre-norm FFN
    (``moe`` for an MoE config's A/L/G layers, else ``mlp``)."""

    def __init__(self, cfg: ModelConfig, kind: str, dtype, device):
        super().__init__()
        d = cfg.d_model
        self.kind = kind
        self.window = cfg.attn.window if kind == "L" else None
        self.norm1 = _vector(d, dtype, device)
        self.norm2 = _vector(d, dtype, device)
        self.attn = _params(attn_param_shapes(d, cfg.attn), dtype, device)
        if cfg.moe is not None and kind != "S":
            self.moe = _params(moe_param_shapes(d, cfg.moe), dtype, device,
                               f32=("router",))
        else:
            self.mlp = _params(mlp_param_shapes(d, cfg.d_ff, cfg.act), dtype,
                               device)

    @torch.no_grad()
    def init(self, cfg: ModelConfig, gen: torch.Generator) -> None:
        self.norm1.fill_(1.0)
        self.norm2.fill_(1.0)
        init_attn_params(self.attn, cfg.d_model, cfg.attn, gen)
        if hasattr(self, "moe"):
            init_moe_params(self.moe, cfg.d_model, cfg.moe, gen)
        else:
            init_mlp_params(self.mlp, cfg.d_model, cfg.d_ff, cfg.act, gen)


class MambaBlock(nn.Module):
    """One Mamba-2 layer: pre-norm SSD block."""

    kind = "M"
    window = None

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        self.norm = _vector(cfg.d_model, dtype, device)
        self.mamba = _params(mamba_param_shapes(cfg.d_model, cfg.ssm),
                             dtype, device, f32=F32_PARAMS)

    @torch.no_grad()
    def init(self, cfg: ModelConfig, gen: torch.Generator) -> None:
        self.norm.fill_(1.0)
        init_mamba_params(self.mamba, cfg.d_model, cfg.ssm, gen)


class SharedSlot(nn.Module):
    """An ``S`` position of the layer list: it holds no weights (the
    model's ``shared`` block is applied there)."""

    kind = "S"


class TransformerLM(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype=torch.float32, device=None):
        super().__init__()
        unknown = set(cfg.pattern) - set(LAYER_KINDS)
        if unknown:
            raise ValueError(f"{cfg.name}: unknown layer kinds "
                             f"{sorted(unknown)}")
        dev = resolve_device(device)
        self.cfg = cfg
        self.dtype = dtype
        self.embed = nn.Parameter(
            torch.empty((cfg.vocab, cfg.d_model), dtype=dtype, device=dev),
            requires_grad=False)
        self.layers = nn.ModuleList(
            self._make(cfg, cfg.pattern[i % len(cfg.pattern)], dtype, dev)
            for i in range(cfg.n_groups * len(cfg.pattern)))
        if "S" in cfg.pattern:
            self.shared = Block(cfg, "S", dtype, dev)
        self.final_norm = _vector(cfg.d_model, dtype, dev)
        if not cfg.tie_embeddings:
            self.head = nn.Parameter(
                torch.empty((cfg.d_model, cfg.vocab), dtype=dtype,
                            device=dev), requires_grad=False)

    @staticmethod
    def _make(cfg: ModelConfig, kind: str, dtype, device) -> nn.Module:
        if kind == "M":
            return MambaBlock(cfg, dtype, device)
        if kind == "S":
            return SharedSlot()
        return Block(cfg, kind, dtype, device)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def _blocks(self):
        """The module applied at each layer position, in order."""
        return [self.shared if blk.kind == "S" else blk
                for blk in self.layers]

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
            if blk.kind != "S":
                blk.init(cfg, gen)
        if "S" in cfg.pattern:
            self.shared.init(cfg, gen)
        self.final_norm.fill_(1.0)
        if not cfg.tie_embeddings:
            normal_(self.head, 0.02, gen)
        return self.state_dict()

    # -------------------- forward --------------------

    def _embed(self, tokens, image_embeds=None) -> torch.Tensor:
        tokens = as_tensor(tokens, self.device).long()
        x = embedding(tokens, self.embed).to(self.dtype)
        if self.cfg.vision_tokens and image_embeds is not None:
            img = as_tensor(image_embeds, self.device).to(self.dtype)
            x = torch.cat([img, x], dim=1)
        return x

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        x = rms_norm(x, self.final_norm, self.cfg.norm_eps)
        head = self.embed.T if self.cfg.tie_embeddings else self.head
        return shard("logits", torch.einsum("bsd,dv->bsv", x, head).float())

    def _ffn(self, blk: Block, x: torch.Tensor):
        """Pre-norm FFN residual -> (x, aux)."""
        cfg = self.cfg
        h = rms_norm(x, blk.norm2, cfg.norm_eps)
        if hasattr(blk, "moe"):
            y, aux = moe_apply(blk.moe, h, cfg.moe)
            return x + y, aux
        return x + mlp_block(blk.mlp, h, cfg.act), None

    def _layer(self, blk: Block, x: torch.Tensor, causal: bool,
               cut: bool = False):
        """One attention layer over a whole sequence -> (x, k, v, aux);
        ``cut``: the residual's sharding cut point between attention and
        FFN (the reference's training layer has it, its prefill not)."""
        cfg = self.cfg
        b, s, _ = x.shape
        h = rms_norm(x, blk.norm1, cfg.norm_eps)
        positions = torch.arange(s, device=x.device)[None, :]
        q, k, v = _project_qkv(blk.attn, h, cfg.attn, positions, cfg.norm_eps)
        o = self_attention(q, k, v, causal=causal, window=blk.window,
                           impl=cfg.attn_impl, chunk=cfg.attn_chunk)
        x = x + torch.einsum("bse,ed->bsd", reshape(o, b, s, -1),
                             blk.attn["wo"])
        if cut:
            x = shard("resid", x)
        x, aux = self._ffn(blk, x)
        return x, k, v, aux

    def _train_layer(self, blk, x: torch.Tensor):
        """One layer of the forward -> (x, aux or None)."""
        cfg = self.cfg
        if blk.kind == "M":
            return x + mamba_block(blk.mamba,
                                   rms_norm(x, blk.norm, cfg.norm_eps),
                                   cfg.ssm, eps=cfg.norm_eps), None
        x, _, _, a = self._layer(blk, x, cfg.attn.causal, cut=True)
        return shard("resid", x), a

    def forward(self, tokens, image_embeds=None
                ) -> tuple[torch.Tensor, torch.Tensor]:
        """Full forward -> (logits (B, S_total, V) f32, aux).  With grad
        enabled each layer is checkpointed as ``cfg.remat`` says."""
        cfg = self.cfg
        x = shard("resid", self._embed(tokens, image_embeds))
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for blk in self._blocks():
            x, a = remat_layer(functools.partial(self._train_layer, blk),
                               cfg.remat, x)
            if a is not None:
                aux = aux + a
        return self._logits(x), aux / cfg.n_layers

    def train_loss(self, batch: dict) -> torch.Tensor:
        """CE over the text positions (the vision prefix's logits cut
        off) + 0.01 x the MoE load-balancing aux loss."""
        image = batch.get("image_embeds")
        logits, aux = self(batch["tokens"], image)
        v = self.cfg.vision_tokens if image is not None else 0
        labels = as_tensor(batch["labels"], self.device)
        ce = sharded_cross_entropy(logits[:, v:], labels)
        return ce + 0.01 * aux

    # -------------------- serving --------------------

    def init_cache(self, batch: int, max_len: int) -> dict:
        cfg = self.cfg
        caches = []
        for blk in self._blocks():
            if blk.kind == "M":
                caches.append(init_mamba_cache(batch, cfg.d_model, cfg.ssm,
                                               self.dtype, self.device))
            else:
                caches.append(init_kv_cache(batch, max_len, cfg.attn,
                                            blk.window, self.dtype,
                                            self.device))
        return {"layers": caches, "step": 0}

    def prefill(self, tokens, max_len: int, image_embeds=None
                ) -> tuple[torch.Tensor, dict]:
        """Process a full prompt (after the image prefix, when given),
        build the decode cache -> (last logits (B, V), cache).  Window
        layers keep the last W keys in ring order, as the reference lays
        them out; mamba layers keep the last ``d_conv - 1`` conv inputs
        and the final SSD state."""
        cfg = self.cfg
        x = shard("resid", self._embed(tokens, image_embeds))
        b, s, _ = x.shape
        caches = []
        for blk in self._blocks():
            if blk.kind == "M":
                y, c = mamba_prefill(blk.mamba,
                                     rms_norm(x, blk.norm, cfg.norm_eps),
                                     cfg.ssm, eps=cfg.norm_eps)
                x = shard("resid", x + y)
                caches.append(c)
                continue
            x, kk, vv, _ = self._layer(blk, x, causal=True)
            window = blk.window
            length = min(window, max_len) if window else max_len
            if window and s > length:
                ck = ring_cache(kk, length, s % length, self.dtype)
                cv = ring_cache(vv, length, s % length, self.dtype)
            else:
                ck = prefix_cache(kk, length, self.dtype)
                cv = prefix_cache(vv, length, self.dtype)
            caches.append({"k": shard("kv", ck), "v": shard("kv", cv)})
            x = shard("resid", x)
        logits = self._logits(x[:, -1:, :])
        return logits[:, 0], {"layers": caches, "step": s}

    def decode_step(self, cache: dict, tokens) -> tuple[torch.Tensor, dict]:
        """One-token step.  tokens (B, 1) -> (logits (B, V), cache); the
        cache is advanced in place and returned."""
        cfg = self.cfg
        x = self._embed(tokens)
        step = cache["step"]
        for blk, c in zip(self._blocks(), cache["layers"]):
            if blk.kind == "M":
                y, _ = mamba_decode_step(blk.mamba,
                                         rms_norm(x, blk.norm, cfg.norm_eps),
                                         c, cfg.ssm, eps=cfg.norm_eps)
                x = x + y
                continue
            h = rms_norm(x, blk.norm1, cfg.norm_eps)
            y, _ = attention_decode(blk.attn, h, c, step, cfg.attn,
                                    eps=cfg.norm_eps, window=blk.window)
            x, _ = self._ffn(blk, x + y)
        logits = self._logits(x)
        return logits[:, 0], {"layers": cache["layers"], "step": step + 1}
