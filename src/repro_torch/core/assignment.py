"""Job-assignment structure for coded matrix computation.

Implements the support-set construction of the paper's Alg. 1
(matrix-vector) and Alg. 2 (matrix-matrix), the heterogeneous-device
expansion of Sec. IV-B, and the baseline schemes compared against in
Sec. VI:

  * polynomial codes [25]          (dense, Vandermonde)
  * orthogonal-polynomial codes [32] (dense, Chebyshev basis)
  * RKRP codes [33]                (dense, random)
  * cyclic low-weight codes [31]   (sparse, weight min(s+1, k))
  * SCS-optimal scheme [36]        (sparse, Delta = lcm(n, k) partitions)
  * class-based scheme [29]        (sparse, Delta partitions, classes)
  * repetition (uncoded)           (weight 1, suboptimal threshold)

Every scheme is reduced to the same normal form: per-worker support sets
over the uncoded block-column indices, from which encoding matrices are
materialised in ``encoding.py``.  That normal form is what the framework
layers (coded matmul, coded linear, benchmarks) consume.

Numpy only, and a line-for-line copy of ``repro.core.assignment``: the
PyTorch package must not import the JAX package, and the supports have
to stay bitwise the reference's.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from .weights import MMWeights, choose_mm_weights, cyclic31_mm_weights, min_weight, mv_weight


# ---------------------------------------------------------------------------
# Scheme descriptors
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MVScheme:
    """Matrix-vector scheme: worker i computes sum_q R[i,q] * (A_q^T x).

    ``supports[i]`` lists the uncoded block-columns combined at worker i;
    ``tasks_per_worker`` > 1 only for the Delta-partition baselines.
    """

    name: str
    n: int                      # number of (virtual) workers
    k_A: int                    # number of uncoded block-columns == unknowns
    s: int                      # straggler resilience target
    omega_A: int                # homogeneous weight (max support size)
    supports: tuple[tuple[int, ...], ...]   # len n (or n*tasks) support sets
    tasks_per_worker: int = 1
    threshold_optimal: bool = True

    @property
    def k(self) -> int:
        return self.k_A

    def weight(self) -> int:
        return max(len(t) for t in self.supports)


@dataclass(frozen=True)
class MMScheme:
    """Matrix-matrix scheme: worker i computes (sum_q Ra[i,q] A_q)^T (sum_p Rb[i,p] B_p).

    Unknowns are A_q^T B_p, indexed u = q * k_B + p.
    """

    name: str
    n: int
    k_A: int
    k_B: int
    s: int
    omega_A: int
    omega_B: int
    supports_A: tuple[tuple[int, ...], ...]
    supports_B: tuple[tuple[int, ...], ...]
    threshold_optimal: bool = True

    @property
    def k(self) -> int:
        return self.k_A * self.k_B

    def weight(self) -> int:
        return max(len(a) * len(b) for a, b in zip(self.supports_A, self.supports_B))


# ---------------------------------------------------------------------------
# Alg. 1 — proposed matrix-vector scheme
# ---------------------------------------------------------------------------


def alg1_supports(n: int, k_A: int) -> list[tuple[int, ...]]:
    """Support sets of Alg. 1 (paper Sec. IV).

    Workers 0..k_A-1:  T = {i, i+1, ..., i+omega_A-1}            (mod k_A)
    Workers k_A..n-1:  T = {i*omega_A, ..., (i+1)*omega_A - 1}   (mod k_A)
    """
    s = n - k_A
    if s < 0:
        raise ValueError(f"need n >= k_A (n={n}, k_A={k_A})")
    if s > k_A:
        raise ValueError(f"paper assumes s <= k_A (s={s}, k_A={k_A})")
    w = mv_weight(n, k_A)
    sup: list[tuple[int, ...]] = []
    for i in range(n):
        if i < k_A:
            t = tuple((i + j) % k_A for j in range(w))
        else:
            t = tuple((i * w + j) % k_A for j in range(w))
        sup.append(t)
    return sup


def proposed_mv(n: int, k_A: int) -> MVScheme:
    s = n - k_A
    return MVScheme(
        name="proposed",
        n=n, k_A=k_A, s=s,
        omega_A=mv_weight(n, k_A),
        supports=tuple(alg1_supports(n, k_A)),
    )


# ---------------------------------------------------------------------------
# Alg. 2 — proposed matrix-matrix scheme
# ---------------------------------------------------------------------------


def alg2_supports(
    n: int, k_A: int, k_B: int, omega_A: int, omega_B: int
) -> tuple[list[tuple[int, ...]], list[tuple[int, ...]]]:
    """Support sets of Alg. 2 (paper Sec. V).

    Workers i < k = k_A k_B:
        T = {i, ..., i + omega_A - 1}           (mod k_A)
        S = {j, ..., j + omega_B - 1}           (mod k_B), j = floor(i / k_A)
    Workers i >= k (the s "extra" devices):
        l = i mod k_A
        T = {l*omega_A, ..., (l+1)*omega_A - 1} (mod k_A)
        m = floor(i * omega_A / k_A)
        S = {m*omega_B, ..., (m+1)*omega_B - 1} (mod k_B)
    """
    k = k_A * k_B
    sup_a: list[tuple[int, ...]] = []
    sup_b: list[tuple[int, ...]] = []
    for i in range(n):
        if i < k:
            t = tuple((i + j) % k_A for j in range(omega_A))
            jj = i // k_A
            s_ = tuple((jj + j) % k_B for j in range(omega_B))
        else:
            ell = i % k_A
            t = tuple((ell * omega_A + j) % k_A for j in range(omega_A))
            m = (i * omega_A) // k_A
            s_ = tuple((m * omega_B + j) % k_B for j in range(omega_B))
        sup_a.append(t)
        sup_b.append(s_)
    return sup_a, sup_b


def proposed_mm(n: int, k_A: int, k_B: int,
                weights: MMWeights | None = None) -> MMScheme:
    if k_A > k_B:
        # w.l.o.g. k_A <= k_B (paper computes (B^T A)^T otherwise)
        raise ValueError("use k_A <= k_B; compute (B^T A)^T for the transpose")
    w = weights or choose_mm_weights(n, k_A, k_B)
    sup_a, sup_b = alg2_supports(n, k_A, k_B, w.omega_A, w.omega_B)
    return MMScheme(
        name="proposed",
        n=n, k_A=k_A, k_B=k_B, s=n - k_A * k_B,
        omega_A=w.omega_A, omega_B=w.omega_B,
        supports_A=tuple(sup_a), supports_B=tuple(sup_b),
    )


# ---------------------------------------------------------------------------
# Heterogeneous extension (Sec. IV-B)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class HeteroSystem:
    """A heterogeneous system of ``n_bar`` physical devices with integer
    capacities c_j >= 1, mapped onto a homogeneous system of
    n = sum(c_j) virtual "weakest-type" workers (Sec. IV-B).

    ``virtual_of[d]`` lists the virtual worker ids owned by physical
    device d; physical device d is a straggler <=> all its virtual
    workers are stragglers (full straggler) or a suffix of them is
    (partial straggler, Sec. IV-B discussion).
    """

    capacities: tuple[int, ...]          # non-ascending, c >= 1
    n: int                               # total virtual workers
    virtual_of: tuple[tuple[int, ...], ...]

    @property
    def n_bar(self) -> int:
        return len(self.capacities)


def make_hetero_system(capacities: list[int]) -> HeteroSystem:
    caps = tuple(sorted((int(c) for c in capacities), reverse=True))
    if any(c < 1 for c in caps):
        raise ValueError("capacities must be >= 1")
    virtual, start = [], 0
    for c in caps:
        virtual.append(tuple(range(start, start + c)))
        start += c
    return HeteroSystem(capacities=caps, n=start, virtual_of=tuple(virtual))


def hetero_mv(system: HeteroSystem, k_A: int) -> MVScheme:
    """Alg. 1 run over the virtualised homogeneous system (Corollary 2).

    Each physical device receives the coded tasks of its virtual workers;
    partial completion of a strong device contributes the finished
    virtual tasks (partial-straggler exploitation).
    """
    sch = proposed_mv(system.n, k_A)
    return MVScheme(
        name="proposed-hetero",
        n=sch.n, k_A=k_A, s=sch.s, omega_A=sch.omega_A,
        supports=sch.supports,
    )


# ---------------------------------------------------------------------------
# Baseline schemes
# ---------------------------------------------------------------------------


def dense_mv(n: int, k_A: int, name: str) -> MVScheme:
    sup = tuple(tuple(range(k_A)) for _ in range(n))
    return MVScheme(name=name, n=n, k_A=k_A, s=n - k_A, omega_A=k_A, supports=sup)


def poly_mv(n: int, k_A: int) -> MVScheme:
    return dense_mv(n, k_A, "poly")


def orthopoly_mv(n: int, k_A: int) -> MVScheme:
    return dense_mv(n, k_A, "orthopoly")


def rkrp_mv(n: int, k_A: int) -> MVScheme:
    return dense_mv(n, k_A, "rkrp")


def cyclic31_mv(n: int, k_A: int) -> MVScheme:
    """Cyclic code with random coefficients [31]: weight min(s+1, k_A),
    supports cyclically shifted across all n workers."""
    s = n - k_A
    w = min(s + 1, k_A)
    sup = tuple(tuple((i + j) % k_A for j in range(w)) for i in range(n))
    return MVScheme(name="cyclic31", n=n, k_A=k_A, s=s, omega_A=w, supports=sup)


def repetition_mv(n: int, k_A: int) -> MVScheme:
    """Repetition: worker i computes the single block i mod k_A.  Weight 1
    but NOT resilient to arbitrary s = n - k_A stragglers."""
    sup = tuple((i % k_A,) for i in range(n))
    return MVScheme(name="repetition", n=n, k_A=k_A, s=n - k_A, omega_A=1,
                    supports=sup, threshold_optimal=False)


def scs_mv(n: int, k_A: int) -> MVScheme:
    """Sparsely-Coded Straggler-optimal scheme [36] (structural model).

    Partitions A into Delta = lcm(n, k_A) block-columns.  Each worker
    stores 1/k_A of A = Delta/k_A block-columns' worth and processes
    Delta/k_A coded tasks, so the fastest k_A workers return exactly
    Delta equations.  Decoding therefore inverts Delta x Delta systems
    -- the source of the scheme's large coefficient-search cost
    (Table III).  Tasks are cyclic weight-(s+1) combinations.
    """
    s = n - k_A
    delta = math.lcm(n, k_A)
    per = delta // k_A
    w = min(s + 1, delta)
    sup = []
    for i in range(n):
        for t in range(per):
            j0 = (i + t * k_A) % delta
            sup.append(tuple((j0 + j) % delta for j in range(w)))
    return MVScheme(name="scs36", n=n, k_A=delta, s=s, omega_A=w,
                    supports=tuple(sup), tasks_per_worker=per)


def class_based_mv(n: int, k_A: int) -> MVScheme:
    """Class-based scheme [29] (structural model).

    Like SCS it works on Delta = lcm(n, k_A) block-columns with
    Delta/k_A tasks per worker, but tasks are grouped into classes, the
    last of which is more densely coded (the partial-straggler
    exploitation structure of [29]).
    """
    s = n - k_A
    delta = math.lcm(n, k_A)
    per = delta // k_A
    sup = []
    for i in range(n):
        for t in range(per):
            c = 1 if t < max(per - 1, 1) else 2
            w = min(c * (s + 1), delta)
            j0 = (i + t * k_A) % delta
            sup.append(tuple((j0 + j) % delta for j in range(w)))
    return MVScheme(name="class29", n=n, k_A=delta, s=s,
                    omega_A=max(len(t) for t in sup),
                    supports=tuple(sup), tasks_per_worker=per)


def dense_mm(n: int, k_A: int, k_B: int, name: str) -> MMScheme:
    sup_a = tuple(tuple(range(k_A)) for _ in range(n))
    sup_b = tuple(tuple(range(k_B)) for _ in range(n))
    return MMScheme(name=name, n=n, k_A=k_A, k_B=k_B, s=n - k_A * k_B,
                    omega_A=k_A, omega_B=k_B, supports_A=sup_a, supports_B=sup_b)


def poly_mm(n: int, k_A: int, k_B: int) -> MMScheme:
    return dense_mm(n, k_A, k_B, "poly")


def orthopoly_mm(n: int, k_A: int, k_B: int) -> MMScheme:
    return dense_mm(n, k_A, k_B, "orthopoly")


def rkrp_mm(n: int, k_A: int, k_B: int) -> MMScheme:
    return dense_mm(n, k_A, k_B, "rkrp")


def cyclic31_mm(n: int, k_A: int, k_B: int) -> MMScheme:
    """Baseline [31] matrix-matrix: weight min(s+1, k) factored, cyclic
    supports over both A and B."""
    k = k_A * k_B
    s = n - k
    w = cyclic31_mm_weights(n, k_A, k_B)
    sup_a, sup_b = alg2_supports(n, k_A, k_B, w.omega_A, w.omega_B)
    return MMScheme(name="cyclic31", n=n, k_A=k_A, k_B=k_B, s=s,
                    omega_A=w.omega_A, omega_B=w.omega_B,
                    supports_A=tuple(sup_a), supports_B=tuple(sup_b))


# The scheme registry -- ``repro_torch.api.make_scheme(name, n=...,
# k_A=...)`` / ``repro_torch.api.list_schemes()`` -- is the single
# lookup surface.  The free constructors above are the implementations
# the registry wraps.


# ---------------------------------------------------------------------------
# Structural invariants (used by tests and by Lemma-1-style validation)
# ---------------------------------------------------------------------------


def union_cover_count(supports, workers: list[int]) -> int:
    """|union of supports over the chosen workers| (Lemma 1 quantity)."""
    u: set[int] = set()
    for i in workers:
        u.update(supports[i])
    return len(u)


def appearances(supports, k: int) -> np.ndarray:
    """Number of workers each unknown appears in (must be >= s+1)."""
    cnt = np.zeros(k, dtype=np.int64)
    for t in supports:
        for q in t:
            cnt[q] += 1
    return cnt


def mm_unknown_supports(scheme: MMScheme) -> list[tuple[int, ...]]:
    """Per-worker unknown sets u = q*k_B + p for the MM bipartite analysis."""
    out = []
    for ta, tb in zip(scheme.supports_A, scheme.supports_B):
        out.append(tuple(q * scheme.k_B + p for q in ta for p in tb))
    return out
