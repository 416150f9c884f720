"""Decoding: recovering the unknowns from the fastest-k worker results.

Given the scheme's system matrix ``G`` (n_tasks x k) -- ``R`` itself for
matrix-vector, the Khatri-Rao rows for matrix-matrix -- and a set of
completed tasks, the server solves ``G[done] @ U = Y[done]`` for the k
unknowns.  For the Delta-partition baselines (SCS/class-based) the same
machinery runs with k = Delta.

Also provides the condition-number analysis used for the numerical-
stability experiments (Table III / Fig. 6): kappa_worst over straggler
patterns, either exhaustively (small C(n, s)) or by Monte-Carlo.

A numpy copy of ``repro.core.decoding``; the decode cache of the
runtime inverts ``G[rows]`` on the host from the same G.
"""

from __future__ import annotations

import itertools
import math
from dataclasses import dataclass

import numpy as np

from .assignment import MMScheme, MVScheme
from .encoding import khatri_rao_rows, mm_encoding_matrices, mv_encoding_matrix


def system_matrix(scheme: MVScheme | MMScheme, seed: int | None = None) -> np.ndarray:
    """(n_tasks x k) coefficient matrix over the unknowns."""
    if isinstance(scheme, MVScheme):
        return mv_encoding_matrix(scheme, seed)
    ra, rb = mm_encoding_matrices(scheme, seed)
    return khatri_rao_rows(ra, rb)


def worker_task_ids(scheme: MVScheme | MMScheme, workers: list[int]) -> list[int]:
    """Task rows owned by the given workers (multi-task baselines own
    ``tasks_per_worker`` consecutive rows)."""
    per = getattr(scheme, "tasks_per_worker", 1)
    out = []
    for wkr in workers:
        out.extend(range(wkr * per, (wkr + 1) * per))
    return out


def decode(G: np.ndarray, done_rows: list[int], Y: np.ndarray) -> np.ndarray:
    """Solve for the unknowns from completed task results.

    G : (n_tasks, k) system matrix
    Y : (n_tasks, ...) per-task results (missing rows may hold garbage)
    Returns U : (k, ...) decoded unknowns.
    """
    sub = G[done_rows]
    ysub = Y[done_rows]
    if sub.shape[0] == sub.shape[1]:
        return np.linalg.solve(sub, ysub.reshape(sub.shape[0], -1)).reshape(
            (sub.shape[1],) + ysub.shape[1:])
    # over-determined (e.g. partial stragglers contributed extra tasks)
    sol, *_ = np.linalg.lstsq(sub, ysub.reshape(sub.shape[0], -1), rcond=None)
    return sol.reshape((sub.shape[1],) + ysub.shape[1:])


def is_recoverable(G: np.ndarray, done_rows: list[int], rtol: float = 1e-9) -> bool:
    sub = G[done_rows]
    if sub.shape[0] < sub.shape[1]:
        return False
    return np.linalg.matrix_rank(sub, tol=rtol * max(sub.shape)) == sub.shape[1]


def condition_number(G: np.ndarray, done_rows: list[int]) -> float:
    sub = G[done_rows]
    try:
        return float(np.linalg.cond(sub))
    except np.linalg.LinAlgError:  # pragma: no cover - singular
        return float("inf")


@dataclass(frozen=True)
class StabilityReport:
    kappa_worst: float
    kappa_mean: float
    patterns_checked: int
    exhaustive: bool
    failures: int          # patterns where the decode matrix was singular


def _fastest_k_rows(scheme, stragglers: tuple[int, ...]) -> list[int]:
    alive = [w for w in range(scheme.n) if w not in stragglers]
    rows = worker_task_ids(scheme, alive)
    # server uses exactly k equations: take the first k alive task rows
    k = scheme.k if isinstance(scheme, MMScheme) else scheme.k_A
    return rows[:k] if len(rows) >= k else rows


def straggler_patterns(n: int, s: int, limit: int, rng: np.random.Generator):
    """All C(n, s) patterns if small enough, else ``limit`` random ones."""
    total = math.comb(n, s)
    if total <= limit:
        return list(itertools.combinations(range(n), s)), True
    pats = set()
    while len(pats) < limit:
        pats.add(tuple(sorted(rng.choice(n, size=s, replace=False).tolist())))
    return sorted(pats), False


def stability_report(scheme: MVScheme | MMScheme, seed: int | None = None,
                     max_patterns: int = 512,
                     rng: np.random.Generator | None = None) -> StabilityReport:
    """kappa_worst / kappa_mean across straggler patterns."""
    rng = rng or np.random.default_rng(1234)
    G = system_matrix(scheme, seed)
    pats, exhaustive = straggler_patterns(scheme.n, scheme.s, max_patterns, rng)
    kappas, failures = [], 0
    for pat in pats:
        rows = _fastest_k_rows(scheme, pat)
        kap = condition_number(G, rows)
        if not np.isfinite(kap) or kap > 1e15:
            failures += 1
        kappas.append(min(kap, 1e30))
    arr = np.array(kappas)
    return StabilityReport(
        kappa_worst=float(arr.max()),
        kappa_mean=float(np.exp(np.mean(np.log(np.maximum(arr, 1.0))))),
        patterns_checked=len(pats),
        exhaustive=exhaustive,
        failures=failures,
    )


def verify_full_recovery(scheme: MVScheme | MMScheme, seed: int | None = None,
                         max_patterns: int = 2048,
                         rng: np.random.Generator | None = None
                         ) -> tuple[bool, int, int]:
    """Check decodability for straggler patterns (exhaustive when feasible).

    Returns (all_ok, n_checked, n_failed).
    """
    rng = rng or np.random.default_rng(7)
    G = system_matrix(scheme, seed)
    pats, _ = straggler_patterns(scheme.n, scheme.s, max_patterns, rng)
    failed = 0
    for pat in pats:
        rows = _fastest_k_rows(scheme, pat)
        if not is_recoverable(G, rows):
            failed += 1
    return failed == 0, len(pats), failed
