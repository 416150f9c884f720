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
     "groups": {"l{i}": {...}},     # one entry per non-S pattern position
     "shared": {...},               # the hybrid's S block, unstacked
     "final_norm": (d,),
     "head": (d, vocab)}            # untied heads only

with every ``groups`` leaf stacked over the G = ``n_groups`` repeats of
the layer pattern.  An attention position (A/L/G) holds::

    {"norm1": (G, d), "norm2": (G, d),
     "attn": {"wq": (G, d, H*hd), "wk": (G, d, KV*hd), "wv": (G, d, KV*hd),
              "wo": (G, H*hd, d), "q_norm": (G, hd), "k_norm": (G, hd)},
     "mlp": {"w_gate": (G, d, f), "w_up": (G, d, f), "w_down": (G, f, d)}}

(``q_norm``/``k_norm`` with qk-norm only, no ``w_gate`` for a gelu FFN);
with MoE, ``"moe": {"router": (G, d, E) f32, "w_gate": (G, E, d, h),
"w_up", "w_down": (G, E, h, d), "shared": {"w_gate", "w_up",
"w_down"}}`` (``shared`` with shared experts only) in place of ``mlp``.
A mamba position (M) holds ``{"norm": (G, d), "mamba": {"w_in", "conv_w",
"conv_b", "A_log", "D", "dt_bias", "norm_w", "w_out"}}`` (``A_log``,
``D``, ``dt_bias`` f32).  The ``S`` block is an attention position's
dict without the G axis.  The port's state dict unstacks them: layer
``g * len(pattern) + i`` is ``groups/l{i}`` at index g, under the keys
``layers.{L}.norm1``, ``layers.{L}.attn.wq``, ``layers.{L}.moe.shared.
w_up``, ``layers.{L}.mamba.A_log`` and so on; the S block's keys are
``shared.*``; ``embed``, ``final_norm`` and ``head`` keep their names.

The JAX ``WhisperLM``'s tree is ``{"embed", "enc": {...}, "enc_norm",
"groups": {...}, "final_norm"}``, whose ``enc`` leaves are stacked over
the encoder's layers (``norm1``, ``norm2``, ``attn``, ``mlp``) and whose
``groups`` leaves over the decoder's (those and ``norm_x``, ``xattn``);
the port's keys are ``enc.{j}.*`` and ``layers.{L}.*``.

``model_params_from_reference`` and ``model_params_to_reference`` map
one onto the other; bf16 keeps its bits both ways.  The AdamW state
``{"step", "m", "v"}`` (``repro.optim.adamw``) mirrors the params, so
``opt_state_to_reference`` and ``opt_state_from_reference`` carry ``m``
and ``v`` through the same mapping and ``step`` as an int32 scalar; the
port's checkpoints are written in the reference's layout through them.

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
    """(layer index, pattern position, group) for every layer the
    reference stacks under ``groups/l{i}`` (an S position has none)."""
    p = len(cfg.pattern)
    return [(g * p + i, i, g) for g in range(cfg.n_groups) for i in range(p)
            if cfg.pattern[i] != "S"]


def _flatten(tree: dict, prefix: str = ""):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _flatten(val, f"{prefix}{key}.")
        else:
            yield f"{prefix}{key}", val


def _unstack(out: dict, tree: dict, prefix: str, index: int, dev) -> None:
    """``tree``'s leaves at ``index`` of their stacked axis, under
    ``prefix``."""
    for name, arr in _flatten(tree):
        out[f"{prefix}{name}"] = _tensor(np.asarray(arr)[index], dev)


def model_params_from_reference(params: dict, cfg, *, device=None) -> dict:
    """The port's state dict for the JAX model params ``params`` (numpy
    arrays, in the layout of the module docstring), on ``device``."""
    dev = resolve_device(device)
    out = {name: _tensor(params[name], dev)
           for name in ("embed", "final_norm", "enc_norm", "head")
           if name in params}
    groups = params["groups"]
    if cfg.family == "audio":
        for j in range(cfg.encoder.n_layers):
            _unstack(out, params["enc"], f"enc.{j}.", j, dev)
        for layer in range(cfg.n_layers):
            _unstack(out, groups, f"layers.{layer}.", layer, dev)
        return out
    for layer, i, g in _groups_keys(cfg):
        _unstack(out, groups[f"l{i}"], f"layers.{layer}.", g, dev)
    if "shared" in params:
        for name, arr in _flatten(params["shared"]):
            out[f"shared.{name}"] = _tensor(arr, dev)
    return out


def _array(t: torch.Tensor) -> np.ndarray:
    """A tensor as a host array; bf16 becomes ``ml_dtypes.bfloat16`` (the
    dtype JAX gives a bf16 array) with the same bits."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes  # noqa: PLC0415 - only for bf16 weights

        return t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _nest(flat: dict) -> dict:
    """{"a.b.c": leaf} -> {"a": {"b": {"c": leaf}}}."""
    tree: dict = {}
    for name, val in flat.items():
        node = tree
        *path, leaf = name.split(".")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = val
    return tree


def _stacked(state_dict: dict, prefixes: list[str]) -> dict:
    """The leaves under each of ``prefixes``, stacked in that order."""
    leaves: dict = {}
    for prefix in prefixes:
        for key, val in state_dict.items():
            if key.startswith(prefix):
                leaves.setdefault(key[len(prefix):], []).append(_array(val))
    return _nest({name: np.stack(arrs) for name, arrs in leaves.items()})


def model_params_to_reference(state_dict: dict, cfg) -> dict:
    """The JAX model params tree (numpy arrays) for the port's state
    dict: the inverse of ``model_params_from_reference``."""
    out = {name: _array(state_dict[name])
           for name in ("embed", "final_norm", "enc_norm", "head")
           if name in state_dict}
    if cfg.family == "audio":
        out["enc"] = _stacked(state_dict, [
            f"enc.{j}." for j in range(cfg.encoder.n_layers)])
        out["groups"] = _stacked(state_dict, [
            f"layers.{layer}." for layer in range(cfg.n_layers)])
        return out
    p = len(cfg.pattern)
    out["groups"] = {
        f"l{i}": _stacked(state_dict, [
            f"layers.{g * p + i}." for g in range(cfg.n_groups)])
        for i, kind in enumerate(cfg.pattern) if kind != "S"}
    if "S" in cfg.pattern:
        out["shared"] = _nest({key[len("shared."):]: _array(val)
                               for key, val in state_dict.items()
                               if key.startswith("shared.")})
    return out


def opt_state_to_reference(state: dict, cfg) -> dict:
    """The JAX AdamW state (numpy arrays) for the port's ``{"step", "m",
    "v"}``: ``m`` and ``v`` take the params' mapping, ``step`` is a 0-d
    int32 array."""
    return {"step": np.asarray(int(state["step"]), np.int32),
            "m": model_params_to_reference(state["m"], cfg),
            "v": model_params_to_reference(state["v"], cfg)}


def opt_state_from_reference(state: dict, cfg, *, device=None) -> dict:
    """The port's AdamW state for the JAX one (numpy arrays): the inverse
    of ``opt_state_to_reference``."""
    dev = resolve_device(device)
    return {"step": torch.tensor(int(np.asarray(state["step"])),
                                 dtype=torch.int32, device=dev),
            "m": model_params_from_reference(state["m"], cfg, device=dev),
            "v": model_params_from_reference(state["v"], cfg, device=dev)}
