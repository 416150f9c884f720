"""Unified decoder-only LM covering the dense / moe / ssm / hybrid / vlm
families, as a ``torch.nn.Module``.

The counterpart of ``repro.models.transformer.TransformerLM``.  The
layer stack repeats a *pattern* of layer kinds ``n_groups`` times:

  dense (qwen3, phi3):   ("A",) x n_layers
  gemma3:                ("L","L","L","L","L","G") x 8   (5:1 local:global)
  mamba2:                ("M",) x 48
  zamba2:                ("M","M","M","M","M","S") x 9   (S = shared block)

``L`` layers attend within ``cfg.attn.window``; ``A``, ``G`` and ``S``
layers attend to the whole context; ``M`` layers are Mamba-2 (SSD)
blocks.  With ``cfg.moe`` every attention layer but ``S`` and the
``cfg.first_dense`` leading ones has an MoE FFN (``moe``) in place of
its dense one (``mlp``).  ``S`` is the hybrid's shared attention layer:
one block (the module's ``shared``) applied at every ``S`` position
with the same weights, each position keeping its own cache.  A vlm
config prepends ``image_embeds`` (the stub CLIP tokens) to the tokens.

The reference stacks each pattern position's weights over ``n_groups``
and scans; the port keeps one module per layer in an ``nn.ModuleList``
(layer ``g * len(pattern) + i`` is the reference's ``groups/l{i}`` at
group ``g``; an ``S`` position holds an empty ``SharedSlot``).  Weights
keep the reference's ``(d_in, d_out)`` orientation, so
``repro_torch.convert`` carries them across as plain copies.

Each layer kind is one class (``AttentionBlock``, ``LatentBlock`` for
``cfg.mla``, ``MambaBlock``) and every entry of ``_blocks()`` answers
``init(gen)``, ``forward(x) -> (x, aux or None)`` (training),
``init_cache(batch, max_len)``, ``prefill(x, max_len) -> (x, cache)``
and ``decode(x, cache, step) -> x``, so the model's loops never ask
what a layer is.  A new kind is a class and a line in ``_make``.

Every parameter is built frozen (``requires_grad=False``): serving runs
under ``torch.inference_mode``.  The trainer turns grad on
(``model.requires_grad_(True)``) and calls ``train_loss``; while grad
is enabled, ``forward`` checkpoints each layer as ``cfg.remat`` says
(the reference's ``_maybe_remat``).

Serving state is ``{"layers": [per-layer cache], "step": int}``, each
cache laid out by its layer's class and written in place by ``decode``;
``step`` is a host int, so a decode step needs no device-to-host copy.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .._device import as_tensor, resolve_device
from ..configs.base import ModelConfig
from ..obs.trace import scope
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
    prompt_kv_cache,
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
from .mla import (
    init_latent_cache,
    init_mla_params,
    mla_decode,
    mla_param_shapes,
    mla_prefill,
)
from .moe import init_moe_params, moe_apply, moe_param_shapes

LAYER_KINDS = ("A", "L", "G", "S", "M")


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
    """An attention layer: pre-norm attention (the subclass's
    ``_init_attn``, ``_attend``, ``_attend_one``, ``init_cache`` and
    ``prefill``), then a pre-norm FFN, ``moe`` or ``mlp``.  A sigmoid-
    routed ``moe`` keeps ``held_tokens``, the slots routed to each held
    expert, summed on the device (not in the state dict)."""

    causal = True   # training's mask; prefill is always causal

    def __init__(self, cfg: ModelConfig, kind: str, attn_shapes: dict,
                 dtype, device, dense: bool):
        super().__init__()
        d = cfg.d_model
        self.cfg, self.kind, self.dtype = cfg, kind, dtype
        self.norm1 = _vector(d, dtype, device)
        self.norm2 = _vector(d, dtype, device)
        self.attn = _params(attn_shapes, dtype, device)
        self.routed = cfg.moe is not None and kind != "S" and not dense
        if self.routed:
            self.moe = _params(moe_param_shapes(d, cfg.moe), dtype, device,
                               f32=("router", "bias"))
            if cfg.moe.scoring == "sigmoid":
                self.register_buffer("held_tokens", torch.zeros(
                    cfg.moe.held, dtype=torch.long, device=device),
                    persistent=False)
        else:
            self.mlp = _params(mlp_param_shapes(d, cfg.d_ff, cfg.act), dtype,
                               device)

    @torch.no_grad()
    def init(self, gen: torch.Generator) -> None:
        cfg, std = self.cfg, self.cfg.init_std
        self.norm1.fill_(1.0)
        self.norm2.fill_(1.0)
        self._init_attn(gen)
        if self.routed:
            init_moe_params(self.moe, cfg.d_model, cfg.moe, gen, std)
        elif std is not None:
            for w in self.mlp.values():
                normal_(w, std, gen)
        else:
            init_mlp_params(self.mlp, cfg.d_model, cfg.d_ff, cfg.act, gen)

    def _ffn(self, x: torch.Tensor):
        """Pre-norm FFN residual -> (x, aux)."""
        cfg = self.cfg
        h = rms_norm(x, self.norm2, cfg.norm_eps)
        if self.routed:
            y, aux = moe_apply(self.moe, h, cfg.moe,
                               getattr(self, "held_tokens", None))
            return x + y, aux
        return x + mlp_block(self.mlp, h, cfg.act), None

    def _seq(self, x: torch.Tensor, causal: bool, cut: bool = False):
        """The layer over a whole sequence -> (x, aux, k, v); ``cut``: the
        residual's sharding cut point between attention and FFN (the
        reference's training layer has it, its prefill not)."""
        y, k, v = self._attend(rms_norm(x, self.norm1, self.cfg.norm_eps),
                               causal)
        return self._ffn(shard("resid", x + y) if cut else x + y) + (k, v)

    def forward(self, x: torch.Tensor):
        x, aux, _, _ = self._seq(x, self.causal, cut=True)
        return shard("resid", x), aux

    def decode(self, x: torch.Tensor, cache: dict, step: int):
        h = rms_norm(x, self.norm1, self.cfg.norm_eps)
        return self._ffn(x + self._attend_one(h, cache, step))[0]


class AttentionBlock(Block):
    """Grouped-head attention (``cfg.attn``), its cache ``{"k", "v"}``: an
    ``L`` layer attends within ``cfg.attn.window`` and keeps a ring of
    that length, the others a prefix of ``max_len``."""

    def __init__(self, cfg: ModelConfig, kind: str, dtype, device, dense):
        super().__init__(cfg, kind, attn_param_shapes(cfg.d_model, cfg.attn),
                         dtype, device, dense)
        self.window = cfg.attn.window if kind == "L" else None
        self.causal = cfg.attn.causal

    def _init_attn(self, gen: torch.Generator) -> None:
        init_attn_params(self.attn, self.cfg.d_model, self.cfg.attn, gen)

    def _attend(self, h: torch.Tensor, causal: bool):
        cfg = self.cfg
        b, s, _ = h.shape
        positions = torch.arange(s, device=h.device)[None, :]
        q, k, v = _project_qkv(self.attn, h, cfg.attn, positions,
                               cfg.norm_eps)
        o = self_attention(q, k, v, causal=causal, window=self.window,
                           impl=cfg.attn_impl, chunk=cfg.attn_chunk)
        return (torch.einsum("bse,ed->bsd", reshape(o, b, s, -1),
                             self.attn["wo"]), k, v)

    def _attend_one(self, h: torch.Tensor, cache: dict, step: int):
        return attention_decode(self.attn, h, cache, step, self.cfg.attn,
                                eps=self.cfg.norm_eps, window=self.window)[0]

    def init_cache(self, batch: int, max_len: int) -> dict:
        return init_kv_cache(batch, max_len, self.cfg.attn, self.window,
                             self.dtype, self.norm1.device)

    def prefill(self, x: torch.Tensor, max_len: int):
        x, _, k, v = self._seq(x, causal=True)
        ck, cv = (prompt_kv_cache(t, max_len, self.window, self.dtype)
                  for t in (k, v))
        cache = {"k": shard("kv", ck), "v": shard("kv", cv)}
        return shard("resid", x), cache


class LatentBlock(Block):
    """Latent attention (``cfg.mla``, ``models/mla.py``), always causal:
    the expanded form over whole sequences, the absorbed form decoding
    against ``{"c", "kr"}``, the latent and the rotated key."""

    def __init__(self, cfg: ModelConfig, kind: str, dtype, device, dense):
        super().__init__(cfg, kind, mla_param_shapes(cfg.d_model, cfg.mla),
                         dtype, device, dense)

    def _init_attn(self, gen: torch.Generator) -> None:
        init_mla_params(self.attn, self.cfg.init_std, gen)

    def _attend(self, h: torch.Tensor, causal: bool):
        return mla_prefill(self.attn, h, self.cfg.mla, eps=self.cfg.norm_eps)

    def _attend_one(self, h: torch.Tensor, cache: dict, step: int):
        return mla_decode(self.attn, h, cache, step, self.cfg.mla,
                          eps=self.cfg.norm_eps)

    def init_cache(self, batch: int, max_len: int) -> dict:
        return init_latent_cache(batch, max_len, self.cfg.mla, self.dtype,
                                 self.norm1.device)

    def prefill(self, x: torch.Tensor, max_len: int):
        x, _, c, kr = self._seq(x, causal=True)
        return x, {"c": prefix_cache(c, max_len, self.dtype),
                   "kr": prefix_cache(kr, max_len, self.dtype)}


class MambaBlock(nn.Module):
    """One Mamba-2 layer: pre-norm SSD block, its cache ``{"conv",
    "state"}`` the last ``d_conv - 1`` conv inputs and the SSD state."""

    kind = "M"

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        self.norm = _vector(cfg.d_model, dtype, device)
        self.mamba = _params(mamba_param_shapes(cfg.d_model, cfg.ssm),
                             dtype, device, f32=F32_PARAMS)

    @torch.no_grad()
    def init(self, gen: torch.Generator) -> None:
        self.norm.fill_(1.0)
        init_mamba_params(self.mamba, self.cfg.d_model, self.cfg.ssm, gen)

    def _ssd(self, fn, x: torch.Tensor, *cache):
        """``fn`` (a ``mamba_*`` function) on the pre-normed ``x``."""
        cfg = self.cfg
        return fn(self.mamba, rms_norm(x, self.norm, cfg.norm_eps), *cache,
                  cfg.ssm, eps=cfg.norm_eps)

    def forward(self, x: torch.Tensor):
        return x + self._ssd(mamba_block, x), None

    def init_cache(self, batch: int, max_len: int) -> dict:
        return init_mamba_cache(batch, self.cfg.d_model, self.cfg.ssm,
                                self.dtype, self.norm.device)

    def prefill(self, x: torch.Tensor, max_len: int):
        y, cache = self._ssd(mamba_prefill, x)
        return shard("resid", x + y), cache

    def decode(self, x: torch.Tensor, cache: dict, step: int):
        return x + self._ssd(mamba_decode_step, x, cache)[0]


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
            SharedSlot() if kind == "S" else
            self._make(cfg, kind, dtype, dev, dense=i < cfg.first_dense)
            for i, kind in enumerate(cfg.pattern * cfg.n_groups))
        if "S" in cfg.pattern:
            self.shared = self._make(cfg, "S", dtype, dev)
        self.final_norm = _vector(cfg.d_model, dtype, dev)
        if not cfg.tie_embeddings:
            self.head = nn.Parameter(
                torch.empty((cfg.d_model, cfg.vocab), dtype=dtype,
                            device=dev), requires_grad=False)

    @staticmethod
    def _make(cfg: ModelConfig, kind: str, dtype, device,
              dense: bool = False) -> nn.Module:
        """The layer of ``kind``: the one place a layer's class is picked."""
        if kind == "M":
            return MambaBlock(cfg, dtype, device)
        if cfg.mla is not None:
            return LatentBlock(cfg, kind, dtype, device, dense=dense)
        return AttentionBlock(cfg, kind, dtype, device, dense=dense)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def _blocks(self):
        """The module applied at each layer position, in order."""
        return [self.shared if blk.kind == "S" else blk
                for blk in self.layers]

    @torch.no_grad()
    def init(self, gen: torch.Generator) -> dict:
        """Draw every weight from ``gen`` (a generator on the model's
        device) with the reference's distributions and scales, in place,
        and return the state dict.  The bits differ from
        ``jax.random``'s; parity goes through ``repro_torch.convert``."""
        cfg = self.cfg
        normal_(self.embed, cfg.init_std or 0.02, gen)
        for blk in self.layers:
            if blk.kind != "S":
                blk.init(gen)
        if "S" in cfg.pattern:
            self.shared.init(gen)
        self.final_norm.fill_(1.0)
        if not cfg.tie_embeddings:
            normal_(self.head, cfg.init_std or 0.02, gen)
        return self.state_dict()

    def _embed(self, tokens, image_embeds=None) -> torch.Tensor:
        tokens = as_tensor(tokens, self.device).long()
        x = embedding(tokens, self.embed).to(self.dtype)
        if self.cfg.vision_tokens and image_embeds is not None:
            img = as_tensor(image_embeds, self.device).to(self.dtype)
            x = torch.cat([img, x], dim=1)
        return x

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        with scope("model.head"):
            x = rms_norm(x, self.final_norm, self.cfg.norm_eps)
            head = self.embed.T if self.cfg.tie_embeddings else self.head
            return shard("logits",
                         torch.einsum("bsd,dv->bsv", x, head).float())

    def forward(self, tokens, image_embeds=None
                ) -> tuple[torch.Tensor, torch.Tensor]:
        """Full forward -> (logits (B, S_total, V) f32, aux).  With grad
        enabled each layer is checkpointed as ``cfg.remat`` says."""
        cfg = self.cfg
        x = shard("resid", self._embed(tokens, image_embeds))
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for blk in self._blocks():
            x, a = remat_layer(blk, cfg.remat, x)
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

    def init_cache(self, batch: int, max_len: int) -> dict:
        return {"layers": [blk.init_cache(batch, max_len)
                           for blk in self._blocks()], "step": 0}

    def prefill(self, tokens, max_len: int, image_embeds=None
                ) -> tuple[torch.Tensor, dict]:
        """Process a full prompt (after the image prefix, when given),
        build each layer's decode cache -> (last logits (B, V), cache)."""
        with scope("model.prefill"):
            x = shard("resid", self._embed(tokens, image_embeds))
            caches = []
            for blk in self._blocks():
                x, c = blk.prefill(x, max_len)
                caches.append(c)
            logits = self._logits(x[:, -1:, :])
            return logits[:, 0], {"layers": caches, "step": x.shape[1]}

    def decode_step(self, cache: dict, tokens) -> tuple[torch.Tensor, dict]:
        """One-token step.  tokens (B, 1) -> (logits (B, V), cache); the
        cache is advanced in place and returned."""
        with scope("model.decode_step"):
            x = self._embed(tokens)
            step = cache["step"]
            for blk, c in zip(self._blocks(), cache["layers"]):
                x = blk.decode(x, c, step)
            logits = self._logits(x)
            return logits[:, 0], {"layers": cache["layers"],
                                  "step": step + 1}


def join_caches(parts: list[dict], max_len: int) -> dict:
    """Latent caches ``{c, kr}`` of the same model and position, one per
    group of rows, joined along the batch into one of ``max_len``
    positions: the positions before ``step`` are copied, the rest are
    zeros."""
    if not parts:
        raise ValueError("no caches to join")
    step = parts[0]["step"]
    if any(p["step"] != step for p in parts):
        raise ValueError(f"caches at different positions: "
                         f"{[p['step'] for p in parts]}")
    if max_len < step:
        raise ValueError(f"max_len {max_len} < position {step}")
    layers = []
    for i, first in enumerate(parts[0]["layers"]):
        if set(first) != {"c", "kr"}:
            raise ValueError(f"layer {i} holds no latent cache")
        joined = {}
        for name, t in first.items():
            rows = [p["layers"][i][name] for p in parts]
            out = t.new_zeros((sum(r.shape[0] for r in rows), max_len,
                               t.shape[2]))
            at = 0
            for r in rows:
                out[at:at + r.shape[0], :step] = r[:, :step]
                at += r.shape[0]
            joined[name] = out
        layers.append(joined)
    return {"layers": layers, "step": step}
