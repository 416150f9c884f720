"""The paper's matrix-vector code (Alg. 1 of arXiv:2408.05152), built
again from its description, and the error each straggler pattern's
decode may amplify.

Worker i of n holds a combination of omega = ceil(k (s + 1) / (k + s))
of A's k block-columns (s = n - k): workers i < k the cyclic run
{i, ..., i + omega - 1}, the s others {i omega, ..., (i + 1) omega - 1},
both mod k; each coefficient is drawn uniformly from [-1, 1] by
``numpy.random.default_rng(seed)``, worker by worker.  A call decodes
from the first k workers in index order that are not left out.

A coded product stores each worker's combination once, rounded to the
served precision u, and the decode multiplies those products by
G[rows]^-1.  Row q of the result then errs by at most
u * sum_j |G[rows]^-1|_qj sum_p |G[rows]|_jp |A_p x|, so a call's error
over the head's largest logit is bounded by u times

    amplification = max_q sum_j (|G[rows]^-1| |G[rows]|)_qj  (>= 1),

whatever the values: each call's error divided by its amplification
is steady from pattern to pattern where the program is sound.
"""

from __future__ import annotations

import math

import numpy as np


def weight(n: int, k: int) -> int:
    """omega, the paper's lower bound on the weight of the coding."""
    s = n - k
    return math.ceil(k * (s + 1) / (k + s)) if s > 0 else 1


def supports(n: int, k: int) -> list[tuple[int, ...]]:
    """The block-columns each worker combines (Alg. 1)."""
    w = weight(n, k)
    return [tuple(((i if i < k else i * w) + j) % k for j in range(w))
            for i in range(n)]


def system_matrix(n: int, k: int, seed: int) -> np.ndarray:
    """(n, k): worker i's coefficient of each block-column."""
    gen = np.random.default_rng(seed)
    g = np.zeros((n, k))
    for i, sup in enumerate(supports(n, k)):
        g[i, list(sup)] = gen.uniform(-1.0, 1.0, size=len(sup))
    return g


def decode_rows(done, k: int) -> np.ndarray:
    """The k workers a call decodes from: the first k not left out."""
    return np.flatnonzero(np.asarray(done, bool))[:k]


def amplification(g: np.ndarray, done) -> float:
    """max_q sum_j (|G[rows]^-1| |G[rows]|)_qj for the call's rows."""
    sub = g[decode_rows(done, g.shape[1])]
    return float((np.abs(np.linalg.inv(sub)) @ np.abs(sub)).sum(1).max())
