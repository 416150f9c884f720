"""Training loop: grad accumulation, compression, checkpoint/restart,
straggler detection, coded-plan retuning.

The port of ``repro.train.trainer`` on one device:

  * **Checkpoint/restart** -- atomic keep-last-k checkpoints of (params,
    optimizer state) in the JAX package's layout; ``fit`` auto-resumes
    from the latest surviving checkpoint, and the data pipeline is
    seekable so the token stream replays exactly.
  * **Straggler detection** -- per-step wall time is tracked against the
    median of the last 20; slow steps are logged.
  * **Gradient compression** -- int8 / top-k with error feedback
    (``repro_torch.optim.compress``), applied before AdamW.
  * **Online plan re-tuning** -- coded plans registered via
    ``coded_plans=`` are ``retune()``d every ``retune_every`` steps
    against the live weights, and a cluster serving a retuned plan gets
    its workers' shards re-shipped.

The model owns its weights: ``fit`` turns grad on for every parameter
(``model.requires_grad_(True)``), takes ``loss.backward()`` per
microbatch and updates the parameters in place.  Microbatches
accumulate as the reference's scan does: the losses and the grads are
summed (the grads in the parameters' dtype) and divided by their
number.  Elastic restart on another mesh:
``repro_torch.train.checkpoint.restore_resharded``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from .._device import as_tensor
from ..optim.adamw import AdamWConfig, apply_updates, init_state
from ..optim.compress import CompressionConfig, compress_tree, init_residual
from . import checkpoint


@dataclass(frozen=True)
class TrainConfig:
    steps: int = 100
    microbatches: int = 1            # gradient accumulation factor
    log_every: int = 10
    ckpt_every: int = 50
    ckpt_dir: str | None = None
    keep_last: int = 3
    straggler_threshold: float = 2.0  # x median step time -> flagged
    compression: CompressionConfig = field(default_factory=CompressionConfig)
    retune_every: int = 0             # re-pick coded-plan backends every N
                                      # steps (0 = off); see coded_plans=


class Trainer:
    def __init__(self, model, opt_cfg: AdamWConfig, train_cfg: TrainConfig,
                 coded_plans=()):
        """``coded_plans`` entries are ``CodedPlan``s, ``(plan,
        provider)`` pairs, or ``(plan, provider, cluster)`` triples.
        ``provider(params)`` returns the plan's current operand from the
        params dict (name -> tensor, the model's ``state_dict()`` keys);
        ``cluster`` is an optional ``ClusterPlan`` serving the plan --
        when a retune recompiles the packed shards, the workers' task
        tables are stale and the trainer re-ships them
        (``cluster.reship()``, bytes recorded in ``retunes``)."""
        self.model = model
        self.opt_cfg = opt_cfg
        self.cfg = train_cfg
        self.step_times: list[float] = []
        self.stragglers: list[int] = []

        def norm(entry):
            entry = entry if isinstance(entry, tuple) else (entry,)
            return entry + (None,) * (3 - len(entry))

        self.coded_plans = [norm(p) for p in coded_plans]
        self.retunes: list[dict] = []

    # ------------------------------------------------------------------

    def _grads(self, params: dict, batch: dict) -> tuple[torch.Tensor, dict]:
        """(loss, grads) of one batch, accumulated over microbatches."""
        m = self.cfg.microbatches
        for p in params.values():
            p.grad = None
        if m > 1:
            mbs = [{k: v.reshape((m, v.shape[0] // m) + v.shape[1:])[i]
                    for k, v in batch.items()} for i in range(m)]
        else:
            mbs = [batch]
        loss = torch.zeros((), dtype=torch.float32, device=self.model.device)
        for mb in mbs:
            l_mb = self.model.train_loss(mb)
            # backward adds each microbatch's grads into .grad in the
            # parameter's dtype, the reference scan's tree add
            l_mb.backward()
            loss = loss + l_mb.detach()
        grads = {}
        for name, p in params.items():
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            grads[name] = g / m if m > 1 else g
            p.grad = None
        return (loss / m if m > 1 else loss), grads

    def _step(self, params, opt_state, residual, batch):
        loss, grads = self._grads(params, batch)
        grads, residual = compress_tree(self.cfg.compression, grads,
                                        residual)
        _, opt_state, metrics = apply_updates(self.opt_cfg, params, grads,
                                              opt_state)
        metrics["loss"] = loss
        # keyed in sorted order, as the reference's jitted step returns it
        return opt_state, residual, dict(sorted(metrics.items()))

    # ------------------------------------------------------------------

    def init_all(self, gen: torch.Generator):
        """Draw the weights from ``gen`` (a generator on the model's
        device), turn grad on -> (params, opt_state, residual); params
        are the model's own parameters, name -> tensor."""
        self.model.init(gen)
        self.model.requires_grad_(True)
        params = dict(self.model.named_parameters())
        opt_state = init_state(self.opt_cfg, params)
        residual = init_residual(self.cfg.compression, params)
        return params, opt_state, residual

    def fit(self, data_iter_factory, gen: torch.Generator | None = None,
            resume: bool = True):
        """Train for cfg.steps.  ``data_iter_factory(start_step)`` builds
        a seekable iterator; on resume it is re-opened at the restored
        cursor, replaying the exact stream.  -> (params, opt_state,
        history): params are the model's parameters (updated in place),
        history one dict per step taken."""
        cfg = self.cfg
        dev = self.model.device
        if gen is None:
            gen = torch.Generator(device=dev).manual_seed(0)
        params, opt_state, residual = self.init_all(gen)
        start = 0
        if resume and cfg.ckpt_dir:
            last = checkpoint.latest_step(cfg.ckpt_dir)
            if last is not None:
                loaded, opt_state = checkpoint.restore_train_state(
                    cfg.ckpt_dir, last, self.model.cfg, params, opt_state)
                with torch.no_grad():
                    for name, p in params.items():
                        p.copy_(loaded[name])
                start = last
        data = data_iter_factory(start)
        history = []
        for step in range(start, cfg.steps):
            batch = next(data)
            batch = {k: as_tensor(v, dev) for k, v in batch.items()}
            t0 = time.perf_counter()
            opt_state, residual, metrics = self._step(
                params, opt_state, residual, batch)
            # the step ends once its numbers are on the host
            metrics = {k: float(v) for k, v in metrics.items()}
            dt = time.perf_counter() - t0
            self.step_times.append(dt)
            med = float(np.median(self.step_times[-20:]))
            if len(self.step_times) > 5 and dt > cfg.straggler_threshold * med:
                self.stragglers.append(step)
            metrics["step"] = step
            metrics["dt"] = dt
            history.append(metrics)
            if cfg.retune_every and (step + 1) % cfg.retune_every == 0:
                self._retune(params, step)
            if cfg.ckpt_dir and (step + 1) % cfg.ckpt_every == 0:
                checkpoint.save_train_state(
                    cfg.ckpt_dir, step + 1, params, opt_state,
                    self.model.cfg, keep_last=cfg.keep_last)
        if cfg.ckpt_dir:
            checkpoint.save_train_state(
                cfg.ckpt_dir, cfg.steps, params, opt_state, self.model.cfg,
                keep_last=cfg.keep_last)
        if hasattr(data, "close"):
            data.close()
        return params, opt_state, history

    def _retune(self, params: dict, step: int) -> None:
        """Re-run the density-based backend pick on registered plans.

        The parameters are updated in place, so the provider's tensor is
        the same object every step and aliases weights that keep moving:
        the plan gets a detached snapshot instead, which it re-encodes
        (the reference's plan sees a new array every step and re-encodes
        the same way).  A retune that recompiled the operand state
        leaves any attached cluster's workers holding stale BSR shards
        -- re-ship them so the next dispatched round computes against
        the live weights.
        """
        for plan, provider, cluster in self.coded_plans:
            before = plan.backend
            executor_before = plan.executor
            operand = None
            if provider is not None:
                with torch.no_grad():
                    operand = provider(params).detach().clone()
            after = plan.retune(operand)
            entry = {"step": step, "backend": after,
                     "changed": after != before}
            if cluster is not None and plan.executor is not executor_before:
                entry["reshipped_bytes"] = cluster.reship()
            self.retunes.append(entry)
