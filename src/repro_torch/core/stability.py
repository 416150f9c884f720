"""Random-coefficient search for numerical stability (Sec. IV-D, VI).

Random-code schemes (proposed, cyclic31, RKRP, SCS, class-based) draw
their coefficients from a continuous distribution; the paper's protocol
generates ``trials`` candidate coefficient sets and keeps the one with
the smallest worst-case condition number kappa_worst over straggler
patterns.

The cost of one trial is C(n, s) condition evaluations on k x k
matrices for the proposed scheme but on Delta x Delta (Delta =
lcm(n, k_A)) matrices for SCS [36] / class-based [29] -- the source of
the order-of-magnitude coefficient-determination-time gap in Table III.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np

from .assignment import MMScheme, MVScheme
from .decoding import StabilityReport, stability_report


@dataclass(frozen=True)
class CoefficientSearchResult:
    best_seed: int
    best_kappa_worst: float
    per_trial_kappas: tuple[float, ...]
    wall_time_s: float
    report: StabilityReport


def find_good_coefficients(scheme: MVScheme | MMScheme,
                           trials: int = 10,
                           max_patterns: int = 256,
                           base_seed: int = 0) -> CoefficientSearchResult:
    """Best-of-``trials`` coefficient search (paper uses 10-20 trials).

    Deterministic schemes (poly / orthopoly) have nothing to search; a
    single evaluation is returned with zero extra trials, matching the
    "0 time" rows of Table III.
    """
    deterministic = scheme.name in ("poly", "orthopoly", "repetition")
    t0 = time.perf_counter()
    rng = np.random.default_rng(99)
    best: tuple[float, int, StabilityReport] | None = None
    kappas = []
    n_trials = 1 if deterministic else trials
    for t in range(n_trials):
        seed = base_seed + t
        rep = stability_report(scheme, seed=seed, max_patterns=max_patterns, rng=rng)
        kappas.append(rep.kappa_worst)
        if best is None or rep.kappa_worst < best[0]:
            best = (rep.kappa_worst, seed, rep)
    wall = time.perf_counter() - t0
    kw, seed, rep = best
    return CoefficientSearchResult(
        best_seed=seed,
        best_kappa_worst=kw,
        per_trial_kappas=tuple(kappas),
        wall_time_s=wall,
        report=rep,
    )
