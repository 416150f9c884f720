"""repro_torch: the PyTorch / CUDA port of ``repro``.

Sparsity-preserving straggler-optimal coded matrix computation on an
NVIDIA Hopper card.  The layout mirrors the JAX package
(``repro_torch.<pkg>.<module>`` is the counterpart of
``repro.<pkg>.<module>``); the three Pallas TPU kernels are hand-written
CUDA kernels in ``repro_torch.kernels``.

    import repro_torch

    plan = repro_torch.compile_plan(A, scheme="proposed", n=16, s=2)
    y = plan.matvec(x, done=mask)

Entry points run on the card unless the caller asks for the CPU (a CPU
tensor, or ``device="cpu"``).  This package never imports JAX or the
JAX package.  Exports are lazy, so ``import repro_torch`` stays cheap.
"""

from __future__ import annotations

_API = (
    "CodedFleet", "CodedFuture", "CodedPlan", "PlanHandle", "SchemeInfo",
    "block_zero_fraction", "choose_backend", "compile_plan", "list_schemes",
    "make_scheme", "register_scheme", "scheme_info", "scheme_names",
)

_CLUSTER = ("ClusterPlan", "ClusterReport", "dumps_plan", "loads_plan")

_SCALE = ("Autoscaler", "LocalPool", "RemotePool", "ReplicaPool")

__all__ = list(_API + _CLUSTER + _SCALE) + ["plan_from_reference_arrays"]


def __getattr__(name: str):
    if name in _API:
        from . import api

        return getattr(api, name)
    if name in _CLUSTER:
        from . import cluster

        return getattr(cluster, name)
    if name in _SCALE:
        from . import scale

        return getattr(scale, name)
    if name == "plan_from_reference_arrays":
        from .convert import plan_from_reference_arrays

        return plan_from_reference_arrays
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(__all__))
