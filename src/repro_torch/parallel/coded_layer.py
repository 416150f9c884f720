"""The paper's technique as a framework feature: a coded linear layer
with straggler resilience.

A ``CodedLinear`` wraps a logical (d_in, d_out) weight matrix.  At
build time the d_out block-columns are encoded per Alg. 1 into n coded
shards of width d_out/k; at apply time each virtual worker computes its
coded product, and the output is decoded from the fastest k workers a
``done`` mask names -- one layer serves every straggler pattern.

All hot methods route through a compiled ``repro_torch.api.CodedPlan``
(built once by ``build`` via ``compile_plan``): on the sparse backends
(``packed`` on the host, ``cuda`` on the card) only the fastest-k
workers' nonzero tiles are multiplied and the decode uses a cached
per-pattern inverse.  Inputs that require grad, and the ``reference``
backend, keep the dense einsum + solve, the one path autograd can
differentiate (the JAX package takes it for traced inputs).

Storage/computation overhead vs an uncoded layer is omega/k_A (omega ~=
s+1 << k_A), while tolerating any s straggling workers per matmul.
``apply_sharded`` runs the paper's scheme with one worker per rank of a
mesh axis: each rank's coded product, an all-gather of the partial
products, and the decode replicated on every rank.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from .._device import as_tensor
from ..api.plan import CodedPlan, compile_plan
from ..api.schemes import make_scheme
from ..core.assignment import MVScheme
from ..core.stability import find_good_coefficients
from ..runtime import CodedExecutor, tracks_grad


@dataclass
class CodedLinear:
    scheme: MVScheme
    coded: torch.Tensor      # (n, d_in, c) coded block-columns of W
    G: torch.Tensor          # (n_tasks, k) decode system matrix
    d_out: int
    backend: str | None = None
    _executor: CodedExecutor | None = field(
        default=None, repr=False, compare=False)
    _plan: CodedPlan | None = field(default=None, repr=False, compare=False)

    @staticmethod
    def build(w, n_workers: int, stragglers: int, seed: int | None = None,
              stability_trials: int = 0, backend: str | None = None,
              scheme: str = "proposed", device=None) -> "CodedLinear":
        """Encode a (d_in, d_out) weight for n workers / s stragglers.

        Routes through ``compile_plan``: ``scheme`` is any registered mv
        scheme name and ``backend=None``/"auto" picks ``cuda`` on the
        card, else packed/reference from the weight's block density.
        Without ``seed``, ``stability_trials > 0`` takes the best of that
        many coefficient draws (``find_good_coefficients``), else seed 0.
        """
        k = n_workers - stragglers
        sch = make_scheme(scheme, n=n_workers, k_A=k)
        if seed is None:
            if stability_trials > 0:
                seed = find_good_coefficients(
                    sch, trials=stability_trials, max_patterns=64).best_seed
            else:
                seed = 0
        plan = compile_plan(w, scheme=sch, seed=seed, backend=backend,
                            device=device)
        # compile_plan keeps the shards in w.dtype (_match_dtype)
        layer = CodedLinear(scheme=sch, coded=plan.executor.coded,
                            G=plan.executor.G, d_out=plan.r,
                            backend=plan.backend)
        if not tracks_grad(layer.coded):
            layer._executor, layer._plan = plan.executor, plan
        return layer

    # ------------------------------------------------------------------

    def plan(self) -> CodedPlan:
        """The compiled ``CodedPlan`` backing this layer."""
        if tracks_grad(self.coded):
            # shards in an autograd graph: a throwaway reference plan,
            # never cached, so no graph outlives the call
            return CodedPlan(scheme=self.scheme, kind="mv",
                             backend="reference", seed=0,
                             G=self.G.detach().cpu().numpy(), r=self.d_out,
                             executor=self.executor(),
                             device=self.coded.device)
        if self._plan is None:
            self._plan = CodedPlan(
                scheme=self.scheme, kind="mv",
                backend=self.executor().backend, seed=0,
                G=self.G.cpu().numpy(), r=self.d_out,
                executor=self.executor(), device=self.coded.device)
        return self._plan

    def executor(self) -> CodedExecutor:
        if tracks_grad(self.coded):
            return CodedExecutor(self.coded, self.G, self.scheme.k_A,
                                 self.d_out, backend="reference")
        if self._executor is None:
            self._executor = CodedExecutor(
                self.coded, self.G, self.scheme.k_A, self.d_out,
                backend=self.backend)
        return self._executor

    def worker_compute(self, x) -> torch.Tensor:
        """All-worker products: x (..., d_in) -> (n, ..., c).

        The all-n contract exists for the tests and for callers that
        bring their own worker results; the fused fastest-k path lives
        in ``apply``.
        """
        x = as_tensor(x, self.coded.device)
        dt = torch.promote_types(self.coded.dtype, x.dtype)
        return torch.einsum("ntc,...t->n...c", self.coded.to(dt), x.to(dt))

    def decode(self, y, done=None) -> torch.Tensor:
        """y (n_tasks, ..., c) worker results -> (..., d_out).

        ``done`` is worker-level; Delta-partition schemes (scs36 /
        class29 run ``tasks_per_worker`` tasks each) expand it to task
        rows via the plan.
        """
        return self.executor().decode(y, self.plan()._task_done(done))

    def apply(self, x, done=None) -> torch.Tensor:
        """Single-device (virtual workers) coded apply."""
        x = as_tensor(x, self.coded.device)
        ex = self.executor()
        if ex.backend == "reference" or tracks_grad(x):
            return self.decode(self.worker_compute(x), done)
        lead = x.shape[:-1]
        out = self.plan().matvec(x.reshape(-1, x.shape[-1]), done)
        return out.reshape(lead + (self.d_out,)).to(x.dtype)

    # ------------------------------------------------------------------

    def apply_sharded(self, mesh, axis: str, x, done=None) -> torch.Tensor:
        """local_map apply: each ``axis`` rank computes its coded shard's
        product; results all-gather over the axis; the decode is
        replicated (k x k solve on a tiny matrix).  ``x`` is the global
        input, the same on every rank (or a replicated DTensor); the
        result is the decoded (..., d_out) on every rank."""
        from ..parallel.ctx import all_gather, shard_map_compat  # noqa: PLC0415
        from ..parallel.sharding import placements  # noqa: PLC0415

        n = self.scheme.n
        size = mesh.size(tuple(mesh.mesh_dim_names).index(axis))
        if size != n:
            raise ValueError(f"mesh axis {axis} has {size} "
                             f"devices, scheme expects n={n}")
        if done is None:
            done = np.ones(n, bool)
        group = mesh.get_group(axis)

        def worker(coded_shard, xx):
            # coded_shard: (1, d_in, c) local slice
            y_local = torch.einsum("tc,...t->...c", coded_shard[0],
                                   xx.to(coded_shard.dtype))
            y_all = all_gather(y_local[None], group, 0)     # (n, ..., c)
            return (self.decode(y_all, done),)

        fn = shard_map_compat(worker, mesh=mesh,
                              in_specs=[placements(mesh, (axis,)),
                                        placements(mesh, ())],
                              out_specs=[placements(mesh, ())])
        return fn(self.coded, as_tensor(x, self.coded.device))[0]
