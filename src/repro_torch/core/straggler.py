"""Straggler models and completion-time simulation.

The paper's AWS experiments observe stragglers from heterogeneous t2
instances and network congestion.  For reproducible simulation we model
per-worker task completion with the standard shifted-exponential model
used throughout the coded-computation literature (e.g. [22]):

    T_i = tau_shift * work_i + Exp(lambda / work_i)

where ``work_i`` is the worker's compute cost (proportional to the nnz
of its coded submatrices -- this is how sparsity-preservation shows up
as wall-clock gain).  Deterministic adversarial patterns are also
supported for worst-case testing.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class ShiftedExponential:
    """T = shift * work + Exp(rate / work)."""

    shift: float = 1.0
    rate: float = 2.0

    def sample(self, work: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        work = np.asarray(work, dtype=np.float64)
        return self.shift * work + rng.exponential(work / self.rate)


@dataclass(frozen=True)
class AdversarialSlow:
    """A fixed straggler set is ``slowdown``x slower than the rest."""

    stragglers: tuple[int, ...]
    slowdown: float = 10.0

    def sample(self, work: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        t = np.asarray(work, dtype=np.float64).copy()
        idx = list(self.stragglers)
        t[idx] *= self.slowdown
        return t


def completion_order(times: np.ndarray) -> np.ndarray:
    """Worker ids sorted by completion time (fastest first)."""
    return np.argsort(times, kind="stable")


def fastest_k(times: np.ndarray, k: int) -> list[int]:
    return completion_order(times)[:k].tolist()


def job_time(times: np.ndarray, k: int) -> float:
    """Wall-clock of the coded job: the k-th fastest completion."""
    return float(np.sort(times)[k - 1])


def simulate_job(work: np.ndarray, k: int, model=None,
                 rng: np.random.Generator | None = None,
                 n_rounds: int = 1) -> dict:
    """Monte-Carlo job-completion statistics for a coded scheme.

    ``work`` is per-worker compute cost (e.g. encoded nnz).  Returns mean
    / p50 / p99 of the k-th order statistic, i.e. the coded job time.
    """
    rng = rng or np.random.default_rng(0)
    model = model or ShiftedExponential()
    ts = np.array([job_time(model.sample(work, rng), k) for _ in range(n_rounds)])
    return {
        "mean": float(ts.mean()),
        "p50": float(np.percentile(ts, 50)),
        "p99": float(np.percentile(ts, 99)),
        "min": float(ts.min()),
        "max": float(ts.max()),
    }
