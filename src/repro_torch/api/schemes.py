"""Scheme registry: one namespace for the paper's family of encodings.

The paper contributes a *family* of weight-optimal sparsity-preserving
schemes (Alg. 1 matrix-vector, Alg. 2 matrix-matrix, the cyclic and
Delta-partition baselines of Table I, the heterogeneous expansion of
Sec. IV-B).  ``@register_scheme(name, kind=...)`` registers a normalized
factory; ``make_scheme(name, n=..., k_A=..., ...)`` is the single entry
point the plan compiler (``repro_torch.api.plan``) uses;
``list_schemes()`` exposes the metadata (weight law, Corollary-1
regime, straggler resilience) that a scheduler would pick on.

The same 14 names, metadata and error messages as ``repro.api.schemes``;
the factories are the port's copies in ``repro_torch.core.assignment``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Sequence

from ..core.assignment import (
    MMScheme,
    MVScheme,
    class_based_mv,
    cyclic31_mm,
    cyclic31_mv,
    hetero_mv,
    make_hetero_system,
    poly_mm,
    poly_mv,
    proposed_mm,
    proposed_mv,
    repetition_mv,
    rkrp_mm,
    rkrp_mv,
    scs_mv,
    orthopoly_mm,
    orthopoly_mv,
)

KINDS = ("mv", "mm")


@dataclass(frozen=True)
class SchemeInfo:
    """Registry metadata for one scheme (what a scheduler picks on)."""

    name: str
    kind: str                     # "mv" (Alg. 1 family) | "mm" (Alg. 2 family)
    factory: Callable = field(repr=False, compare=False)
    sparse: bool = True           # weight << k (sparsity-preserving)
    weight: str = ""              # human-readable weight law
    regime: str = ""              # where the scheme sits (optimal/baseline/...)
    straggler_resilient: bool = True   # decodes under ANY s-straggler pattern
    hetero: bool = False          # built from device capacities (Sec. IV-B)
    description: str = ""

    def as_dict(self) -> dict:
        return {
            "name": self.name, "kind": self.kind, "sparse": self.sparse,
            "weight": self.weight, "regime": self.regime,
            "straggler_resilient": self.straggler_resilient,
            "hetero": self.hetero, "description": self.description,
        }


_REGISTRY: dict[tuple[str, str], SchemeInfo] = {}


def register_scheme(name: str, kind: str = "mv", *, sparse: bool = True,
                    weight: str = "", regime: str = "",
                    straggler_resilient: bool = True, hetero: bool = False,
                    description: str = ""):
    """Decorator registering a scheme factory under ``(kind, name)``.

    The factory must accept the normalized keyword signature
    ``(n, k_A)`` for ``kind="mv"``, ``(n, k_A, k_B)`` for ``kind="mm"``,
    or ``(capacities, k_A)`` when ``hetero=True``.
    """
    if kind not in KINDS:
        raise ValueError(f"kind must be one of {KINDS}, got {kind!r}")

    def deco(fn):
        key = (kind, name)
        if key in _REGISTRY:
            raise ValueError(f"scheme {name!r} already registered for "
                             f"kind={kind!r}")
        _REGISTRY[key] = SchemeInfo(
            name=name, kind=kind, factory=fn, sparse=sparse, weight=weight,
            regime=regime, straggler_resilient=straggler_resilient,
            hetero=hetero, description=description)
        return fn

    return deco


def scheme_info(name: str, kind: str = "mv") -> SchemeInfo:
    key = (kind, name)
    if key not in _REGISTRY:
        known = sorted(n for k, n in _REGISTRY if k == kind)
        raise KeyError(f"unknown {kind} scheme {name!r}; known: {known}")
    return _REGISTRY[key]


def list_schemes(kind: str | None = None) -> tuple[SchemeInfo, ...]:
    """All registered schemes (optionally one kind), sorted by name."""
    if kind is not None and kind not in KINDS:
        raise ValueError(f"kind must be one of {KINDS} or None, got {kind!r}")
    return tuple(sorted(
        (info for (k, _), info in _REGISTRY.items()
         if kind is None or k == kind),
        key=lambda i: (i.kind, i.name)))


def scheme_names(kind: str | None = None, *,
                 resilient_only: bool = False) -> tuple[str, ...]:
    """Registered names; ``resilient_only`` keeps schemes that decode
    under ANY s-straggler pattern and need no capacities (what a CLI
    can safely offer for random-straggler serving)."""
    return tuple(i.name for i in list_schemes(kind)
                 if not resilient_only
                 or (i.straggler_resilient and not i.hetero))


def make_scheme(name: str, *, n: int | None = None, k_A: int | None = None,
                k_B: int | None = None, s: int | None = None,
                capacities: Sequence[int] | None = None,
                kind: str | None = None) -> MVScheme | MMScheme:
    """Factory: registry name + system shape -> scheme descriptor.

    ``kind`` is inferred when omitted: ``k_B`` given -> "mm", else "mv".
    For mv schemes exactly one of ``k_A`` / ``s`` fixes the split
    (``k_A = n - s``); hetero schemes take ``capacities`` (per-device
    integer speeds, Sec. IV-B) instead of ``n``.
    """
    if kind is None:
        kind = "mm" if k_B is not None else "mv"
    info = scheme_info(name, kind)

    if info.hetero:
        if capacities is None:
            raise ValueError(f"scheme {name!r} is heterogeneous: pass "
                             f"capacities= (per-device integer speeds)")
        if k_A is None:
            raise ValueError("hetero schemes need k_A= (uncoded block-columns)")
        return info.factory(capacities, k_A)
    if capacities is not None:
        raise ValueError(f"capacities= only applies to hetero schemes "
                         f"(got scheme {name!r}); use 'proposed-hetero'")
    if n is None:
        raise ValueError("n= (number of workers) is required")

    if kind == "mv":
        if k_A is None and s is None:
            raise ValueError("pass k_A= or s= (k_A = n - s)")
        if k_A is not None and s is not None and k_A != n - s:
            raise ValueError(f"inconsistent k_A={k_A} and s={s} for n={n}")
        k_A = k_A if k_A is not None else n - s
        if not 0 < k_A <= n:
            raise ValueError(f"need 0 < k_A <= n, got k_A={k_A}, n={n}")
        return info.factory(n, k_A)

    if k_A is None or k_B is None:
        raise ValueError("mm schemes need both k_A= and k_B=")
    if s is not None and s != n - k_A * k_B:
        raise ValueError(f"inconsistent s={s}: mm resilience is "
                         f"n - k_A*k_B = {n - k_A * k_B}")
    return info.factory(n, k_A, k_B)


# ---------------------------------------------------------------------------
# Registered factories (the constructors of repro_torch.core.assignment)
# ---------------------------------------------------------------------------


register_scheme(
    "proposed", "mv", sparse=True,
    weight="ceil(k_A(s+1)/n)  (Prop. 1 bound, met)",
    regime="weight-optimal (Alg. 1)",
    description="the paper's matrix-vector scheme",
)(proposed_mv)

register_scheme(
    "proposed-hetero", "mv", sparse=True, hetero=True,
    weight="ceil(k_A(s+1)/n) over sum(c_j) virtual workers",
    regime="weight-optimal, heterogeneous (Sec. IV-B / Corollary 2)",
    description="Alg. 1 over capacity-virtualised devices; exploits "
                "partial stragglers",
)(lambda capacities, k_A: hetero_mv(make_hetero_system(list(capacities)), k_A))

register_scheme(
    "cyclic31", "mv", sparse=True,
    weight="min(s+1, k_A)  (above the Prop. 1 bound when k <= s^2)",
    regime="sparse baseline [31]",
    description="cyclic supports, random coefficients",
)(cyclic31_mv)

register_scheme(
    "poly", "mv", sparse=False, weight="k_A (dense)",
    regime="dense MDS baseline [25]",
    description="polynomial codes, Vandermonde rows",
)(poly_mv)

register_scheme(
    "orthopoly", "mv", sparse=False, weight="k_A (dense)",
    regime="dense baseline [32], Chebyshev-stabilised",
    description="orthogonal-polynomial codes",
)(orthopoly_mv)

register_scheme(
    "rkrp", "mv", sparse=False, weight="k_A (dense)",
    regime="dense random baseline [33]",
    description="random Khatri-Rao-product codes",
)(rkrp_mv)

register_scheme(
    "scs36", "mv", sparse=True,
    weight="min(s+1, Delta) over Delta = lcm(n, k_A) partitions",
    regime="sparse baseline [36], Delta-partition",
    description="SCS-optimal scheme; decodes Delta x Delta systems",
)(scs_mv)

register_scheme(
    "class29", "mv", sparse=True,
    weight="class-dependent, <= 2(s+1), Delta partitions",
    regime="sparse baseline [29], partial-straggler classes",
    description="class-based scheme over Delta = lcm(n, k_A) partitions",
)(class_based_mv)

register_scheme(
    "repetition", "mv", sparse=True, straggler_resilient=False,
    weight="1 (uncoded)",
    regime="repetition baseline; threshold-suboptimal",
    description="worker i stores block i mod k_A; NOT resilient to "
                "arbitrary s-straggler patterns",
)(repetition_mv)

register_scheme(
    "proposed", "mm", sparse=True,
    weight="omega_A * omega_B >= ceil(k(s+1)/n)  (Prop. 1, Alg. 2 choice)",
    regime="weight-optimal (Alg. 2)",
    description="the paper's matrix-matrix scheme",
)(proposed_mm)

register_scheme(
    "cyclic31", "mm", sparse=True,
    weight=">= s+1 factored into omega_A * omega_B",
    regime="sparse baseline [31]",
    description="cyclic supports over both A and B",
)(cyclic31_mm)

register_scheme(
    "poly", "mm", sparse=False, weight="k_A * k_B (dense)",
    regime="dense MDS baseline [25]",
    description="polynomial codes, degree-jump B encoding",
)(poly_mm)

register_scheme(
    "orthopoly", "mm", sparse=False, weight="k_A * k_B (dense)",
    regime="dense baseline [32], Chebyshev-stabilised",
    description="orthogonal-polynomial codes, strided B basis",
)(orthopoly_mm)

register_scheme(
    "rkrp", "mm", sparse=False, weight="k_A * k_B (dense)",
    regime="dense random baseline [33]",
    description="random Khatri-Rao-product codes",
)(rkrp_mm)
