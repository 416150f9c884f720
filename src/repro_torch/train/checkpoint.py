"""Fault-tolerant checkpointing: atomic writes, keep-last-k, restart.

The port of ``repro.train.checkpoint``, writing the same archive: a
flat ``.npz`` keyed by the reference's pytree key strings
(``jax.tree_util.keystr``, e.g. ``['params']['groups']['l0']['attn']
['wq']``), bf16 stored losslessly as f32, written atomically (tmp +
``os.replace``) so a preemption mid-save never corrupts the latest
checkpoint.  Restore is shape-checked leaf by leaf; ``latest_step``
scans the directory so a restarted job resumes from whatever survived.

``save`` / ``restore`` take any nested dict of tensors or arrays.  A
trainer's state goes through ``save_train_state`` /
``restore_train_state``, which write and read the JAX package's tree
(``{"params": ..., "opt": {"step", "m", "v"}}``, each ``groups`` leaf
stacked over the layer pattern's repeats) through
``repro_torch.convert``, so a checkpoint of either package restores into
the other.

``restore_resharded`` restores the host-complete archive onto any mesh:
each leaf placed with ``distribute_tensor`` by the given placements (the
elastic-rescale path).
"""

from __future__ import annotations

import os
import re
import tempfile
from pathlib import Path

import numpy as np
import torch

from ..convert import (
    model_params_from_reference,
    model_params_to_reference,
    opt_state_from_reference,
    opt_state_to_reference,
)

_KEY = re.compile(r"\['((?:[^'\\]|\\.)*)'\]")


def _keystr(path: tuple) -> str:
    """``jax.tree_util.keystr`` of a path of dict keys."""
    return "".join(f"[{key!r}]" for key in path)


def _host(leaf) -> np.ndarray:
    """A leaf as a host array; bf16 (a tensor or an ``ml_dtypes`` array)
    widened to f32, which keeps every value (npz has no bf16)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()
    arr = np.asarray(leaf)
    if arr.dtype.kind == "V" or arr.dtype.name == "bfloat16":
        arr = arr.astype(np.float32)
    return arr


def _flatten(tree: dict, path: tuple = ()) -> dict[str, np.ndarray]:
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(_flatten(val, path + (key,)))
        else:
            out[_keystr(path + (key,))] = _host(val)
    return out


def _nest(flat: dict[str, np.ndarray]) -> dict:
    """The archive's key strings back into a nested dict."""
    tree: dict = {}
    for key, arr in flat.items():
        parts = _KEY.findall(key)
        node = tree
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = arr
    return tree


def _place(arr: np.ndarray, like, key: str):
    """``arr`` checked against ``like``'s shape, in ``like``'s dtype (and,
    for a tensor, on its device)."""
    if tuple(arr.shape) != tuple(like.shape):
        raise ValueError(f"shape mismatch for {key}: "
                         f"ckpt {arr.shape} vs template {tuple(like.shape)}")
    if isinstance(like, torch.Tensor):
        return torch.from_numpy(np.ascontiguousarray(arr)).to(
            device=like.device, dtype=like.dtype)
    return np.asarray(arr).astype(like.dtype)


def _unflatten_into(template: dict, flat: dict, path: tuple = ()) -> dict:
    out = {}
    for key, leaf in template.items():
        if isinstance(leaf, dict):
            out[key] = _unflatten_into(leaf, flat, path + (key,))
            continue
        name = _keystr(path + (key,))
        if name not in flat:
            raise KeyError(f"checkpoint missing leaf {name}")
        out[key] = _place(flat[name], leaf, name)
    return out


def save(ckpt_dir: str | Path, step: int, state: dict,
         keep_last: int = 3) -> Path:
    """Atomically write ``state`` (a nested dict of tensors or arrays)
    for ``step``."""
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    flat = _flatten(state)
    final = ckpt_dir / f"ckpt_{step:08d}.npz"
    fd, tmp = tempfile.mkstemp(dir=ckpt_dir, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **flat)
        os.replace(tmp, final)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    _gc(ckpt_dir, keep_last)
    return final


def _gc(ckpt_dir: Path, keep_last: int):
    ckpts = sorted(ckpt_dir.glob("ckpt_*.npz"))
    for old in ckpts[:-keep_last]:
        old.unlink()


def latest_step(ckpt_dir: str | Path) -> int | None:
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = [int(m.group(1)) for p in ckpt_dir.glob("ckpt_*.npz")
             if (m := re.match(r"ckpt_(\d+)\.npz", p.name))]
    return max(steps) if steps else None


def load(ckpt_dir: str | Path, step: int) -> dict[str, np.ndarray]:
    """The archive of ``step``, flat: key string -> host array."""
    path = Path(ckpt_dir) / f"ckpt_{step:08d}.npz"
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def restore(ckpt_dir: str | Path, step: int, template: dict) -> dict:
    """Restore into the structure/shapes/dtypes (and devices) of
    ``template``, a nested dict of tensors or arrays."""
    return _unflatten_into(template, load(ckpt_dir, step))


# ---------------------------------------------------------------------------
# A trainer's state, in the JAX package's layout
# ---------------------------------------------------------------------------


def save_train_state(ckpt_dir: str | Path, step: int, params: dict,
                     opt_state: dict, cfg, keep_last: int = 3) -> Path:
    """Write a trainer's params and AdamW state as the JAX package's
    ``save(ckpt_dir, step, {"params": ..., "opt": ...})`` writes them:
    its tree, on the host, bf16 widened to f32."""
    def host(tensors: dict) -> dict:
        return {k: torch.from_numpy(_host(v)) for k, v in tensors.items()}

    tree = {"params": model_params_to_reference(host(params), cfg),
            "opt": opt_state_to_reference(
                {"step": opt_state["step"], "m": host(opt_state["m"]),
                 "v": host(opt_state["v"])}, cfg)}
    return save(ckpt_dir, step, tree, keep_last=keep_last)


def _checked(loaded: dict, template: dict, what: str) -> dict:
    """``loaded``'s tensors checked leaf by leaf against ``template``'s
    names and shapes, in its dtypes and on its devices."""
    out = {}
    for name, like in template.items():
        if name not in loaded:
            raise KeyError(f"checkpoint missing leaf {what}.{name}")
        out[name] = _place(loaded[name].numpy(), like, f"{what}.{name}")
    return out


def restore_train_state(ckpt_dir: str | Path, step: int, cfg,
                        params: dict, opt_state: dict
                        ) -> tuple[dict, dict]:
    """Read ``{"params", "opt"}`` of ``step`` (written by either package)
    back into the port's layout -> (params, opt_state) of the templates'
    shapes, dtypes and devices."""
    tree = _nest(load(ckpt_dir, step))
    for part in ("params", "opt"):
        if part not in tree:
            raise KeyError(f"checkpoint missing leaf ['{part}']")
    try:
        p = model_params_from_reference(tree["params"], cfg, device="cpu")
        o = opt_state_from_reference(tree["opt"], cfg, device="cpu")
    except IndexError as e:     # a stacked axis shorter than the model's
        raise ValueError(f"checkpoint does not fit {cfg.name}: {e}") from e
    step_t = opt_state["step"]
    return (_checked(p, params, "params"),
            {"step": torch.as_tensor(int(o["step"]), dtype=step_t.dtype,
                                     device=step_t.device),
             "m": _checked(o["m"], opt_state["m"], "opt.m"),
             "v": _checked(o["v"], opt_state["v"], "opt.v")})


def _distribute(tree, shardings, mesh):
    """Each leaf of ``tree`` placed on ``mesh`` by the placements at the
    same path of ``shardings``; a leaf whose placements are None (or
    missing) is left whole."""
    from torch.distributed.tensor import distribute_tensor  # noqa: PLC0415

    if isinstance(tree, dict):
        shardings = shardings or {}
        return {k: _distribute(v, shardings.get(k), mesh)
                for k, v in tree.items()}
    if shardings is None or not isinstance(tree, torch.Tensor):
        return tree
    return distribute_tensor(tree, mesh, list(shardings))


def restore_resharded(ckpt_dir: str | Path, step: int, template: dict,
                      shardings: dict, *, mesh, cfg=None) -> dict:
    """Restore and place each leaf on ``mesh`` with the placements of
    ``shardings`` (a tree like ``template``; None leaves a leaf whole)
    -- the elastic-rescale path (host-complete archive -> any mesh).

    Without ``cfg`` the template is the archive's own tree, as
    ``restore`` takes it.  With ``cfg`` the archive is a trainer's
    ``{"params", "opt"}`` in the JAX package's layout (written by either
    package), and ``template`` holds the port's layout of the parts to
    restore: ``"params"`` (a state dict) and/or ``"opt"`` (``{"step",
    "m", "v"}``)."""
    if cfg is None:
        host = restore(ckpt_dir, step, template)
    else:
        tree = _nest(load(ckpt_dir, step))
        host = {}
        for part in template:
            if part not in tree:
                raise KeyError(f"checkpoint missing leaf ['{part}']")
        try:
            if "params" in template:
                host["params"] = _checked(
                    model_params_from_reference(tree["params"], cfg,
                                                device="cpu"),
                    template["params"], "params")
            if "opt" in template:
                o = opt_state_from_reference(tree["opt"], cfg, device="cpu")
                like = template["opt"]
                host["opt"] = {
                    "step": torch.as_tensor(int(o["step"]),
                                            dtype=like["step"].dtype,
                                            device=like["step"].device),
                    "m": _checked(o["m"], like["m"], "opt.m"),
                    "v": _checked(o["v"], like["v"], "opt.v")}
        except IndexError as e:     # a stacked axis shorter than the model's
            raise ValueError(f"checkpoint does not fit {cfg.name}: {e}"
                             ) from e
    return _distribute(host, shardings, mesh)
