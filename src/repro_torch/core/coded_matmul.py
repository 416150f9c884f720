"""End-to-end coded matrix computation in PyTorch.

The paper's pipeline:

    partition -> encode (weight-omega linear combinations)
              -> per-worker compute (packed block-sparse products)
              -> straggler selection (fastest-k mask)
              -> decode (cached k x k inverse)

Two execution styles, both shims over the plan API
(``repro_torch.api.compile_plan``):

  * ``coded_matvec`` / ``coded_matmat``: one-shot functions that compile
    a throwaway plan per call.  Hot loops over a fixed matrix should
    compile the plan once.
  * ``CodedOperator``: a pre-encoded operator whose plan (packing,
    decode-plan cache, backend choice) is built once and reused.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..runtime import CodedExecutor
from .assignment import MMScheme, MVScheme


# ---------------------------------------------------------------------------
# Partitioning helpers
# ---------------------------------------------------------------------------


def pad_to_multiple(x: torch.Tensor, axis: int, k: int) -> torch.Tensor:
    rem = (-x.shape[axis]) % k
    if rem == 0:
        return x
    pads = [0, 0] * x.ndim
    pads[2 * (x.ndim - 1 - axis) + 1] = rem    # F.pad lists the last dim first
    return torch.nn.functional.pad(x, pads)


def split_block_columns(x: torch.Tensor, k: int) -> torch.Tensor:
    """(t, r) -> (k, t, r/k) stacked block-columns (pads r if needed)."""
    x = pad_to_multiple(x, 1, k)
    t, r = x.shape
    return torch.movedim(x.reshape(t, k, r // k), 1, 0)


def merge_block_columns(blocks: torch.Tensor, r: int) -> torch.Tensor:
    """(k, t, c) -> (t, k*c)[:, :r] inverse of split_block_columns."""
    k, t, c = blocks.shape
    return torch.movedim(blocks, 0, 1).reshape(t, k * c)[:, :r]


# ---------------------------------------------------------------------------
# Fastest-k selection
# ---------------------------------------------------------------------------


def fastest_k_rows(done: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the first k set bits of ``done`` (n,) -> (k,) int64.

    A stable sort on (!done, index).  If fewer than k workers completed
    the result includes dead workers; callers check ``done.sum() >= k``.
    """
    n = done.shape[0]
    ar = torch.arange(n, device=done.device)
    order = torch.argsort(torch.where(done, 0, 1) * n + ar)
    return order[:k]


# ---------------------------------------------------------------------------
# One-shot functions
# ---------------------------------------------------------------------------


def coded_matvec(A, x, scheme: MVScheme, seed: int = 0, done=None,
                 backend: str | None = None, device=None) -> torch.Tensor:
    """Compute A^T x through the coded pipeline; returns (r,).

    One-shot shim over ``repro_torch.api.compile_plan``.
    """
    from ..api.plan import compile_plan  # noqa: PLC0415 - layering

    plan = compile_plan(A, scheme=scheme, seed=seed, backend=backend,
                        device=device)
    return plan.matvec(x, done)


def coded_matmat(A, B, scheme: MMScheme, seed: int = 0, done=None,
                 backend: str | None = None, device=None) -> torch.Tensor:
    """Compute A^T B through the coded pipeline; returns (r, w).

    One-shot shim over ``repro_torch.api.compile_plan``: A is
    plan-encoded, B is encoded per call as ``plan.matmat`` does.
    """
    from ..api.plan import compile_plan  # noqa: PLC0415 - layering

    plan = compile_plan(A, scheme=scheme, seed=seed, backend=backend,
                        device=device)
    return plan.matmat(B, done)


# ---------------------------------------------------------------------------
# Pre-encoded operator (weights encoded once, reused per step)
# ---------------------------------------------------------------------------


@dataclass
class CodedOperator:
    """A^T-apply operator with straggler resilience.

    ``build`` compiles a ``CodedPlan`` once and ``apply(x, done)``
    routes through it.  Constructing the dataclass directly from
    pre-encoded shards (tests, checkpoint restore) also works: the plan
    is then built lazily around the existing ``coded``/``G``.
    """

    scheme: MVScheme
    coded: torch.Tensor       # (n_tasks, t, c) encoded block-columns
    G: torch.Tensor           # (n_tasks, k) system matrix
    r: int                    # original output dim
    backend: str | None = None
    _executor: CodedExecutor | None = field(
        default=None, repr=False, compare=False)
    _plan: object | None = field(default=None, repr=False, compare=False)

    @staticmethod
    def build(A, scheme: MVScheme, seed: int = 0,
              backend: str | None = None, device=None) -> "CodedOperator":
        from ..api.plan import compile_plan  # noqa: PLC0415 - layering

        plan = compile_plan(A, scheme=scheme, seed=seed, backend=backend,
                            device=device)
        op = CodedOperator(scheme=scheme, coded=plan.executor.coded,
                           G=plan.executor.G, r=plan.r,
                           backend=plan.backend)
        op._executor, op._plan = plan.executor, plan
        return op

    def plan(self):
        """The compiled ``CodedPlan`` backing this operator."""
        if self._plan is None:
            from ..api.plan import CodedPlan  # noqa: PLC0415 - layering

            ex = self.executor()
            self._plan = CodedPlan(
                scheme=self.scheme, kind="mv", backend=ex.backend, seed=0,
                G=self.G.detach().cpu().numpy(), r=self.r, executor=ex,
                device=ex.device)
        return self._plan

    def executor(self) -> CodedExecutor:
        if self._executor is None:
            self._executor = CodedExecutor(
                self.coded, self.G, self.scheme.k_A, self.r,
                backend=self.backend)
        return self._executor

    def apply(self, x, done=None) -> torch.Tensor:
        return self.plan().matvec(x, done)

    def worker_nnz(self) -> np.ndarray:
        c = self.coded.detach()
        return (c != 0).reshape(c.shape[0], -1).sum(dim=1).cpu().numpy()

    def worker_tile_counts(self) -> np.ndarray:
        """Nonzero packed tiles per worker -- proportional to the
        per-apply work (scales with omega)."""
        return self.executor().worker_tile_counts()
