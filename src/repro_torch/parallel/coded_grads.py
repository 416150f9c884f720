"""Coded data-parallel gradient aggregation (beyond-paper extension).

Gradient coding (Tandon et al., ICML'17) assigns each of n workers a
linear combination of k data-shard gradients so the *sum* is decodable
from any n - s workers.  The classical constructions use weight s + 1;
the paper's Prop. 1 + Alg. 1 machinery drops the weight to
omega_hat = ceil(k(s+1)/n) <= s+1 -- i.e. each worker computes gradients
on fewer shards (the training-time analogue of the sparsity-preservation
argument: per-worker work scales with omega, not with the redundancy a
dense code would need).

Decode is even cheaper than the matrix case: we only need the SUM of the
k shard gradients, i.e. a vector a with a^T R[done_k] = 1^T -- one k x k
factorisation *per straggler pattern*; the aggregated gradient is then
sum_i a_i g~_i.

``CodedAggregator`` wraps this for a tree (dicts / lists / tuples) of
gradient tensors.  ``R`` lives on the card unless the caller asks for
the CPU.  Decode routes through an aggregation-only
``repro_torch.api.CodedPlan``: repeated steps under the same done mask
hit the LRU-cached per-pattern inverse instead of re-running a k x k
solve every call.  An ``R`` that requires grad takes the differentiable
solve path instead (the JAX package takes it for traced masks).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from .._device import as_tensor, resolve_device
from ..api.plan import _tree_map
from ..core.assignment import MVScheme, proposed_mv
from ..core.coded_matmul import fastest_k_rows
from ..core.encoding import mv_encoding_matrix
from ..runtime import tracks_grad


@dataclass
class CodedAggregator:
    """Straggler-resilient sum of k shard-gradients from n workers."""

    scheme: MVScheme
    R: torch.Tensor           # (n, k) encoding matrix
    seed: int = 0
    _plan: object | None = field(default=None, repr=False, compare=False)

    @staticmethod
    def build(n_workers: int, stragglers: int, seed: int = 0, *,
              device=None) -> "CodedAggregator":
        """``R`` on ``device``: the card unless ``device="cpu"``."""
        k = n_workers - stragglers
        scheme = proposed_mv(n_workers, k)
        return CodedAggregator(
            scheme=scheme,
            R=torch.as_tensor(mv_encoding_matrix(scheme, seed),
                              dtype=torch.float32,
                              device=resolve_device(device)),
            seed=seed)

    def plan(self):
        """Aggregation-only ``CodedPlan`` (owns the LRU decode cache).

        Built around ``self.R`` directly -- R stays the single source of
        truth even when the dataclass is constructed with a custom
        encoding matrix rather than through ``build``.
        """
        if self._plan is None:
            from ..api.plan import CodedPlan  # noqa: PLC0415 - layering

            self._plan = CodedPlan(
                scheme=self.scheme, kind="mv", backend="reference",
                seed=self.seed,
                G=self.R.detach().cpu().numpy().astype(np.float64),
                device=self.R.device)
        return self._plan

    @property
    def shard_assignment(self) -> tuple[tuple[int, ...], ...]:
        """supports[i] = the data shards worker i computes gradients on
        (weight omega_hat each -- the per-worker compute budget)."""
        return self.scheme.supports

    def worker_payload(self, worker: int, shard_grads: list) -> object:
        """What worker ``worker`` sends: sum_q R[w,q] * g_q over its
        support (it only ever computes those omega shards' gradients)."""
        coeffs = self.R[worker]
        out = None
        for q in self.scheme.supports[worker]:
            term = _tree_map(
                lambda g: coeffs[q] * as_tensor(g, coeffs.device).float(),
                shard_grads[q])
            out = term if out is None else _tree_map(torch.add, out, term)
        return out

    def decode_coeffs(self, done) -> tuple[torch.Tensor, torch.Tensor]:
        """a (k,) with a^T R[rows] = 1^T, plus the chosen rows (k,).

        Masks hit the plan's LRU per-pattern inverse (zero solves on
        repeat patterns); an ``R`` that requires grad runs the solve.
        """
        k = self.scheme.k_A
        dev = self.R.device
        if not tracks_grad(self.R):
            dplan = self.plan()._decode_cache().plan(done)
            # a^T R[rows] = 1^T  <=>  a = (R[rows]^{-1})^T 1 = colsums(hinv)
            return (torch.from_numpy(dplan.hinv.sum(axis=0)).to(dev),
                    torch.from_numpy(dplan.rows).to(dev))
        rows = fastest_k_rows(as_tensor(done, dev, torch.bool), k)
        sub = self.R[rows]                       # (k, k)
        ones = torch.ones((k,), dtype=torch.float32, device=dev)
        a = torch.linalg.solve(sub.T, ones)      # sub^T a = 1
        return a, rows

    def aggregate(self, payloads: list, done=None, cluster=None) -> object:
        """Sum of all k shard gradients from any >= k completed workers.

        ``payloads`` is the length-n list of worker payloads (straggler
        entries may hold garbage -- they are masked by ``done``).
        Routes through ``plan.aggregate`` (cached-inverse decode).  Pass
        a ``cluster`` (from ``to_cluster``) to actually dispatch the
        combine: payloads ship to workers, the decode runs from the
        fastest-k real completions (``done=None`` races them).
        """
        if cluster is not None:
            return cluster.aggregate(payloads, done)
        return self.plan().aggregate(payloads, done)

    def to_cluster(self, n_workers: int | None = None, *, fleet=None, **kw):
        """Serve this aggregator's (aggregation-only) plan from real
        workers -- the training-time analogue of the coded serving head.

        With ``fleet=`` (a ``repro_torch.api.fleet.CodedFleet``) the plan
        *attaches* to that existing session and the returned
        ``PlanHandle`` aggregates off the same workers the LM head /
        MoE experts already run on (the fleet's owner closes it).
        Otherwise a private single-plan ``ClusterPlan`` is built: real
        workers (card workers when ``R`` is on the card), fault
        injection, partial-straggler credit.
        """
        if fleet is not None:
            if kw or n_workers is not None:
                raise ValueError("fleet= attaches to an existing session; "
                                 "n_workers/transport/faults belong to the "
                                 "fleet's constructor")
            return fleet.attach(self.plan())
        from ..cluster import ClusterPlan  # noqa: PLC0415 - layering

        return ClusterPlan(self.plan(), n_workers, **kw)
