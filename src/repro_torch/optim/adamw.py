"""AdamW with cosine schedule, global-norm clipping, and optional
moment-dtype control (bf16 moments for trillion-param fits).

The port of ``repro.optim.adamw``.  Plain functions over a dict of
name -> tensor (a model's ``named_parameters()``, keyed like its
``state_dict()``): state is ``{"step", "m", "v"}`` with ``m`` and ``v``
keyed like the params.  The arithmetic is the reference's, step for
step: every update is computed in f32 and cast back to the parameter's
and the moment's dtypes (no master copy); the bias corrections are
``1 - b ** step`` in f32; the schedule is computed in f32 as ``jnp``
computes it; the reported norm is the global norm before the clip.

``torch.optim.AdamW`` is not used: its decoupled weight decay and its
eps placement are not the reference's ``delta = mhat / (sqrt(vhat) +
eps) + wd * p``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1
    moment_dtype: str = "float32"    # "bfloat16" halves optimizer memory


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup -> cosine decay to min_lr_ratio * lr (f32)."""
    step = torch.as_tensor(step).to(torch.float32)
    dev = step.device
    warm = step / _f32(max(cfg.warmup_steps, 1), dev)
    prog = torch.clamp(
        (step - _f32(cfg.warmup_steps, dev))
        / _f32(max(cfg.total_steps - cfg.warmup_steps, 1), dev), 0, 1)
    cos = _f32(0.5, dev) * (_f32(1, dev) + torch.cos(_f32(math.pi, dev)
                                                     * prog))
    decay = _f32(cfg.min_lr_ratio, dev) + _f32(1 - cfg.min_lr_ratio, dev) \
        * cos
    return _f32(cfg.lr, dev) * torch.where(
        step < _f32(cfg.warmup_steps, dev), warm, decay)


def init_state(cfg: AdamWConfig, params: dict) -> dict:
    dt = torch.bfloat16 if cfg.moment_dtype == "bfloat16" else torch.float32
    dev = next(iter(params.values())).device if params else None
    return {
        "step": torch.zeros((), dtype=torch.int32, device=dev),
        "m": {k: torch.zeros(p.shape, dtype=dt, device=p.device)
              for k, p in params.items()},
        "v": {k: torch.zeros(p.shape, dtype=dt, device=p.device)
              for k, p in params.items()},
    }


def global_norm(tree: dict) -> torch.Tensor:
    total = None
    for g in tree.values():
        sq = torch.sum(torch.square(g.to(torch.float32)))
        total = sq if total is None else total + sq
    if total is None:
        return torch.zeros((), dtype=torch.float32)
    return torch.sqrt(total)


@torch.no_grad()
def apply_updates(cfg: AdamWConfig, params: dict, grads: dict, state: dict
                  ) -> tuple[dict, dict, dict]:
    """One AdamW step.  Updates ``params`` (and the moments) in place and
    returns ``(params, new_state, metrics)``; ``metrics`` holds 0-d
    tensors ``grad_norm`` (before the clip) and ``lr``."""
    gnorm = global_norm(grads)
    dev = gnorm.device
    scale = torch.minimum(
        _f32(1.0, dev),
        _f32(cfg.clip_norm, dev) / torch.maximum(gnorm, _f32(1e-9, dev)))
    step = state["step"] + 1
    lr = schedule(cfg, step).to(dev)
    stepf = step.to(device=dev, dtype=torch.float32)
    b1c = _f32(1, dev) - torch.pow(_f32(cfg.b1, dev), stepf)
    b2c = _f32(1, dev) - torch.pow(_f32(cfg.b2, dev), stepf)
    for name, p in params.items():
        m, v = state["m"][name], state["v"][name]
        g = grads[name].to(torch.float32) * scale
        m_new = cfg.b1 * m.to(torch.float32) + (1 - cfg.b1) * g
        v_new = cfg.b2 * v.to(torch.float32) + (1 - cfg.b2) * g * g
        mhat = m_new / b1c
        vhat = v_new / b2c
        p32 = p.to(torch.float32)
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * p32
        p.copy_(p32 - lr * delta)
        m.copy_(m_new)
        v.copy_(v_new)
    return params, {"step": step, "m": state["m"], "v": state["v"]}, \
        {"grad_norm": gnorm, "lr": lr}
