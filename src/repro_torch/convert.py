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
holds exactly those shards, without re-encoding.

A model's weights cross the same way.  The JAX ``TransformerLM``'s
params tree (``jax.tree.map(np.asarray, params)``) is::

    {"embed": (vocab, d),
     "groups": {"l{i}": {"norm1": (G, d), "norm2": (G, d),
                         "attn": {"wq": (G, d, H*hd), "wk": (G, d, KV*hd),
                                  "wv": (G, d, KV*hd), "wo": (G, H*hd, d),
                                  "q_norm": (G, hd), "k_norm": (G, hd)},
                         "mlp": {"w_gate": (G, d, f), "w_up": (G, d, f),
                                 "w_down": (G, f, d)}}},
     "final_norm": (d,),
     "head": (d, vocab)}            # untied heads only

with every ``groups`` leaf stacked over the G = ``n_groups`` repeats of
the layer pattern (``q_norm``/``k_norm`` with qk-norm only, no
``w_gate`` for a gelu FFN).  The port's state dict unstacks them: layer
``g * len(pattern) + i`` is ``groups/l{i}`` at index g, under the keys
``layers.{L}.norm1``, ``layers.{L}.attn.wq``, ``layers.{L}.mlp.w_up``
and so on; ``embed``, ``final_norm`` and ``head`` keep their names.
``model_params_from_reference`` and ``model_params_to_reference`` map
one onto the other; bf16 keeps its bits both ways.

This module imports nothing of the JAX package: only numpy arrays
cross.
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


def _groups_keys(cfg):
    """(layer index, pattern position, group) for every layer."""
    p = len(cfg.pattern)
    return [(g * p + i, i, g) for g in range(cfg.n_groups) for i in range(p)]


def _flatten(tree: dict, prefix: str = ""):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _flatten(val, f"{prefix}{key}.")
        else:
            yield f"{prefix}{key}", val


def model_params_from_reference(params: dict, cfg, *, device=None) -> dict:
    """The port's state dict for the JAX model params ``params`` (numpy
    arrays, in the layout of the module docstring), on ``device``."""
    dev = resolve_device(device)
    out = {"embed": _tensor(params["embed"], dev),
           "final_norm": _tensor(params["final_norm"], dev)}
    if "head" in params:
        out["head"] = _tensor(params["head"], dev)
    groups = params["groups"]
    for layer, i, g in _groups_keys(cfg):
        for name, arr in _flatten(groups[f"l{i}"]):
            out[f"layers.{layer}.{name}"] = _tensor(np.asarray(arr)[g], dev)
    return out


def _array(t: torch.Tensor) -> np.ndarray:
    """A tensor as a host array; bf16 becomes ``ml_dtypes.bfloat16`` (the
    dtype JAX gives a bf16 array) with the same bits."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes  # noqa: PLC0415 - only for bf16 weights

        return t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def model_params_to_reference(state_dict: dict, cfg) -> dict:
    """The JAX model params tree (numpy arrays) for the port's state
    dict: the inverse of ``model_params_from_reference``."""
    out = {"embed": _array(state_dict["embed"]),
           "final_norm": _array(state_dict["final_norm"])}
    if "head" in state_dict:
        out["head"] = _array(state_dict["head"])
    stacked: dict = {}
    for layer, i, _ in _groups_keys(cfg):
        prefix = f"layers.{layer}."
        for key, val in state_dict.items():
            if key.startswith(prefix):
                stacked.setdefault((i, key[len(prefix):]), []).append(
                    _array(val))
    groups: dict = {}
    for (i, name), arrs in stacked.items():
        node = groups.setdefault(f"l{i}", {})
        *path, leaf = name.split(".")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = np.stack(arrs)
    out["groups"] = groups
    return out
