"""Carry a compiled plan's state across from the JAX package.

A plan's "weights" are its compiled state: the system matrix G, the
coded shards, and for mm plans the B-side encoding tables.  The JAX
side exports them as numpy arrays, for example::

    meta = {"scheme": plan.scheme.name, "kind": plan.kind, "n": plan.n,
            "s": plan.s, "k_A": plan.scheme.k_A,
            "k_B": getattr(plan.scheme, "k_B", None), "seed": plan.seed,
            "r": plan.r, "backend": plan.backend}
    arrays = {"G": plan.G, "coded": np.asarray(plan.executor.coded)}
    # mm plans add "rb", "sup_b", "coef_b"

and ``plan_from_reference_arrays`` builds a port ``CodedPlan`` that
holds exactly those shards, without re-encoding.  This module imports
nothing of the JAX package: only numpy arrays cross.
"""

from __future__ import annotations

import numpy as np
import torch

from ._device import resolve_device
from .api.plan import CodedPlan
from .api.schemes import make_scheme
from .runtime import BACKENDS, CodedExecutor

# the reference's kernel backends map onto the port's
_BACKEND_NAMES = {"pallas": "cuda", "pallas-interpret": "cuda"}


def _tensor(arr, device) -> torch.Tensor:
    """A copy of a host array as a tensor; a bf16 array (``ml_dtypes``)
    keeps its bits."""
    arr = np.array(arr)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.as_tensor(arr, device=device)


def plan_from_reference_arrays(meta: dict, arrays: dict, *,
                               device=None) -> CodedPlan:
    """A port ``CodedPlan`` over the reference plan's exported state.

    ``meta``: scheme name, kind ("mv" | "mm"), n, s, k_A and k_B as
    passed to ``compile_plan``, seed, r,
    backend (a reference or port backend name).  ``arrays``: ``G``,
    ``coded (n, t, c)``, and for mm plans ``rb``, ``sup_b``, ``coef_b``.
    """
    dev = resolve_device(device)
    kind = meta["kind"]
    if kind == "mm":
        sch = make_scheme(meta["scheme"], n=meta["n"], k_A=meta["k_A"],
                          k_B=meta["k_B"], kind="mm")
    else:
        sch = make_scheme(meta["scheme"], n=meta["n"], k_A=meta["k_A"])
    backend = _BACKEND_NAMES.get(meta["backend"], meta["backend"])
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {meta['backend']!r}")
    G = np.asarray(arrays["G"])
    if G.shape != (len(sch.supports) if kind == "mv" else sch.n, sch.k):
        raise ValueError(f"G {G.shape} does not fit scheme {sch.name!r}")
    coded = _tensor(arrays["coded"], dev)
    plan = CodedPlan(scheme=sch, kind=kind, backend=backend,
                     seed=int(meta["seed"]), G=G, r=int(meta["r"]),
                     device=dev)
    plan.executor = CodedExecutor(coded, G, sch.k, plan.r, backend=backend,
                                  device=dev)
    if kind == "mm":
        plan._rb = np.asarray(arrays["rb"])
        if backend != "reference":
            plan._sup_b = torch.as_tensor(
                np.asarray(arrays["sup_b"], np.int32), device=dev)
            plan._coef_b = torch.as_tensor(
                np.asarray(arrays["coef_b"], np.float32), device=dev)
    return plan.prewarm()
