"""Batched serving engine with an optional coded (straggler-resilient)
LM head.

Wave-based batching: up to ``batch_size`` requests are left-padded to a
common prompt length, prefilled in one shot, then decoded token by
token (greedy or temperature sampling) until every slot emits EOS or
hits its budget.  With ``coded`` enabled the engine compiles the LM
head into a ``repro_torch.api.CodedPlan`` once, at build (on the card:
the ``cuda`` backend, so one ``cyclic_encode`` launch), and
``coded_logits`` computes logits through it under a per-step straggler
mask (simulated here; on a real edge deployment the mask comes from
worker heartbeats): one ``bcsr_matmul`` over the fastest-k workers and
one ``decode_matmul`` per call, the response identical whichever <= s
workers are lost.  As in the JAX package, the wave loop itself samples
from the model's own logits and does not call the coded head.

Straggler sampling routes through ``repro_torch.cluster.faults`` (pass
``faults=`` to change the model); the mask and temperature sampling
share the engine's one ``np.random.Generator``, drawn in the
reference's order, so a seed gives the reference's masks bitwise.

``CodedConfig.cluster`` serves the head from a private cluster of real
workers (``CodedPlan.to_cluster``: a card plan's workers run one
``bcsr_matmul`` per task and the round one ``decode_matmul``), and
``CodedConfig.fleet`` attaches it to an externally-owned
``CodedFleet``; in both the mask picks which workers' task rows a call
may use (parity mode) and ``done=None`` races them.
``CodedConfig.router`` serves the head through an endpoint of a
``repro_torch.serve.Router`` under the engine's tenant: a missing one is
registered on one owned replica fleet (``cluster_workers`` workers on
``transport``, where the plan lives) and unregistered by ``close()``; a
pre-registered one is shared and left running.  Prefill and decode run
eagerly under ``torch.inference_mode()`` where the reference jits them.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from .._device import as_tensor
from ..api.plan import compile_plan
from ..api.schemes import scheme_info, scheme_names
from ..cluster.faults import StragglerFaults
from ..configs.base import CodedConfig, ModelConfig


@dataclass
class Request:
    prompt: list[int]
    max_new: int = 32
    eos: int | None = None
    output: list[int] = field(default_factory=list)


class ServeEngine:
    def __init__(self, model, params, cfg: ModelConfig, batch_size: int = 8,
                 max_len: int = 512, coded: CodedConfig | None = None,
                 rng_seed: int = 0, faults=None):
        """``model`` is a ``repro_torch.models`` model (any family whose
        ``prefill`` takes only tokens: not whisper) and ``params`` the
        state dict it serves (loaded into the model; pass
        ``model.init(...)``'s result or a converted one).  The engine
        runs on the model's device."""
        self.model = model
        self.params = params
        self.cfg = cfg
        self.batch_size = batch_size
        self.max_len = max_len
        model.load_state_dict(params)
        self.rng = np.random.default_rng(rng_seed)
        # straggler masks come from a repro_torch.cluster.faults
        # injector that shares the engine's rng, so per-step masks stay
        # reproducible per rng_seed
        self.faults = faults if faults is not None \
            else StragglerFaults(rng=self.rng)
        self.coded = None
        self.coded_cluster = None
        self.coded_router = None
        self._owns_cluster = True
        self._owns_endpoint = False
        if coded is not None and coded.enabled:
            if not scheme_info(coded.scheme, "mv").straggler_resilient:
                # the engine samples a fresh random straggler set per
                # step; a non-resilient scheme would silently emit
                # inf/nan logits on an undecodable pattern
                raise ValueError(
                    f"scheme {coded.scheme!r} is not resilient to "
                    f"arbitrary straggler patterns; pick one of "
                    f"{scheme_names('mv', resilient_only=True)}")
            head = (params["embed"].T if cfg.tie_embeddings
                    else params["head"])
            self.coded = compile_plan(
                head, scheme=coded.scheme, n=coded.n_workers,
                s=coded.stragglers, seed=coded.seed,
                backend=coded.backend or "auto", device=model.device)
            self.s = coded.stragglers
            if coded.router is not None:
                # serve front door: submit through the router's named
                # endpoint under this engine's tenant.  A missing
                # endpoint is registered here (one owned replica) and
                # unregistered on close(); a pre-registered one is
                # shared infrastructure and left alone.
                self.coded_router = coded.router
                self._router_endpoint = coded.endpoint
                self._router_tenant = coded.tenant
                self._owns_endpoint = not coded.router.has_endpoint(
                    coded.endpoint)
                if self._owns_endpoint:
                    try:
                        coded.router.register(
                            coded.endpoint, self.coded, replicas=1,
                            n_workers=coded.cluster_workers,
                            transport=coded.transport)
                    except (ValueError, RuntimeError):
                        # the has_endpoint/register pair is not atomic:
                        # another engine may register the same endpoint
                        # in between.  Losing that race is not an error
                        # -- fall back to sharing the winner's endpoint
                        if not coded.router.has_endpoint(coded.endpoint):
                            raise
                        self._owns_endpoint = False
            elif coded.fleet is not None:
                # shared session: attach to the externally-owned fleet
                # (workers co-host other consumers' plans); close()
                # detaches without tearing the fleet down
                self.coded_cluster = coded.fleet.attach(self.coded)
                self._owns_cluster = False
            elif coded.cluster:
                self.coded_cluster = self.coded.to_cluster(
                    coded.cluster_workers, transport=coded.transport)
        self._prefill = lambda toks: model.prefill(toks, max_len=self.max_len)
        self._decode = model.decode_step

    # ------------------------------------------------------------------

    def _straggler_mask(self) -> np.ndarray:
        """Per-step straggler set: fastest-k under the engine's fault
        model (``repro_torch.cluster.faults``), a host bool array."""
        return self.faults.mask(self.coded.scheme.n, self.s)

    # ------------------------------------------------------------------

    def run(self, requests: list[Request], greedy: bool = True
            ) -> list[Request]:
        """Serve a wave of requests; returns them with ``output`` filled."""
        done_reqs: list[Request] = []
        with torch.inference_mode():
            for i in range(0, len(requests), self.batch_size):
                wave = requests[i: i + self.batch_size]
                done_reqs.extend(self._run_wave(wave, greedy))
        return done_reqs

    def _run_wave(self, wave: list[Request], greedy: bool) -> list[Request]:
        b = len(wave)
        plen = max(len(r.prompt) for r in wave)
        toks = np.zeros((b, plen), np.int32)
        for j, r in enumerate(wave):
            toks[j, plen - len(r.prompt):] = r.prompt   # left-pad, no mask
        logits, cache = self._prefill(toks)
        max_new = max(r.max_new for r in wave)
        active = np.ones(b, bool)
        for _ in range(max_new):
            nxt = self._sample(logits, greedy)
            for j, r in enumerate(wave):
                if active[j]:
                    t = int(nxt[j])
                    r.output.append(t)
                    if (r.eos is not None and t == r.eos) or \
                            len(r.output) >= r.max_new:
                        active[j] = False
            if not active.any():
                break
            logits, cache = self._decode(cache, nxt[:, None])
        return wave

    def _sample(self, logits: torch.Tensor, greedy: bool) -> np.ndarray:
        if greedy:
            return logits.argmax(dim=-1).cpu().numpy()
        p = torch.softmax(logits, dim=-1).cpu().numpy()
        return np.array([self.rng.choice(p.shape[-1], p=row) for row in p])

    # ------------------------------------------------------------------

    def coded_logits(self, hidden, done=None) -> torch.Tensor:
        """Compute logits through the coded LM head (hidden (B, d)) under
        ``done``, or a fresh straggler mask when None.

        In cluster, fleet and router mode the matvec is actually
        dispatched: the mask picks which workers' task rows this step may
        use, and the decode runs from their real, asynchronously-collected
        results.
        """
        if self.coded is None:
            raise ValueError("engine built without coded config")
        hidden = as_tensor(hidden, self.coded.device)
        mask = done if done is not None else self._straggler_mask()
        if self.coded_router is not None:
            out = self.coded_router.call(
                self._router_endpoint, hidden, done=mask,
                tenant=self._router_tenant)
            return out.to(hidden.dtype)
        head = self.coded_cluster if self.coded_cluster is not None \
            else self.coded
        return head.matvec(hidden, mask).to(hidden.dtype)

    def close(self) -> None:
        """Release cluster resources (no-op outside cluster mode).

        A private cluster is shut down for real: worker threads joined,
        worker processes reaped.  A plan attached to a shared
        ``CodedConfig.fleet`` is only detached: the fleet and its workers
        keep serving the other consumers, and its owner closes it.  An
        endpoint this engine registered is unregistered (drained, its
        fleet closed); a shared endpoint and the router stay up.
        """
        if self.coded_router is not None:
            if self._owns_endpoint:
                self.coded_router.unregister(self._router_endpoint)
            self.coded_router = None
        if self.coded_cluster is not None:
            if self._owns_cluster:
                self.coded_cluster.shutdown()
            else:
                self.coded_cluster.detach()
            self.coded_cluster = None

    def __enter__(self) -> "ServeEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
