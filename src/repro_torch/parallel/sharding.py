"""Sharding rules: DP / TP / EP / ZeRO across the production mesh.

The counterpart of ``repro.parallel.sharding`` on ``torch.distributed``:
a mesh is a ``DeviceMesh`` with axes ('data', 'model') single-pod or
('pod', 'data', 'model') multi-pod ('pod' composes with 'data' as the
data-parallel dimension), and every rule gives a leaf a
``list[Placement]`` (one per mesh dimension) where the reference gives a
``PartitionSpec``.

Parameter placement policy (the reference's, rule for rule):

  * embeddings / lm head        : vocab dim over 'model'
  * attention qkv / o           : Megatron column/row parallel over
                                  'model'
  * dense FFN                   : column/row parallel over 'model'
  * MoE experts                 : expert axis over 'model' (EP) and the
                                  d_model axis over 'data' (fully-
                                  sharded params, FSDP-style)
  * mamba / conv / norms / scalars : replicated
  * optimizer moments (m, v)    : parameter spec + 'data' added on the
                                  largest evenly-divisible free dim
                                  (ZeRO-1)

The reference keys its rules on its pytree paths (``['embed']``,
``['groups']['l0']['moe']['w_down']``, ...), whose ``groups`` and
``enc`` leaves carry a leading stacked axis.  The port's parameters are
a flat ``nn.Module`` state dict, one module per layer
(``layers.{i}.attn.wq``); ``reference_key`` maps each port name onto
its reference path (the mapping of ``repro_torch.convert``), and each
port leaf gets exactly its reference leaf's spec without that stacked
axis.  ZeRO-1 may put 'data' on the stacked axis itself in the
reference (it is a candidate dim there); a port leaf then gets no
'data', so the rules take the model's ``cfg`` to know the axis' size.

A spec is written as the reference writes one: a tuple with one entry
per tensor dim, each None, an axis name or a tuple of axis names;
``placements`` turns it into DTensor placements and ``spec_of`` back.

Activation cut points (installed via ``repro_torch.parallel.ctx``):
  resid  : (batch over 'pod'+'data')
  logits : batch over DP axes, vocab over 'model'
  kv     : batch over DP axes when batch divides
"""

from __future__ import annotations

import torch

Spec = tuple


def _names(mesh) -> tuple[str, ...]:
    return tuple(mesh.mesh_dim_names)


def _sizes(mesh) -> dict[str, int]:
    return dict(zip(_names(mesh), tuple(mesh.shape)))


def dp_axes(mesh) -> tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in _names(mesh))


def _axis_size(mesh, axes) -> int:
    sizes = _sizes(mesh)
    size = 1
    for a in (axes if isinstance(axes, tuple) else (axes,)):
        size *= sizes[a]
    return size


def _divides(dim: int, mesh, axes) -> bool:
    return dim % _axis_size(mesh, axes) == 0


def placements(mesh, spec: Spec) -> list:
    """A spec (one entry per tensor dim: None, an axis or a tuple of
    axes) -> one placement per mesh dimension.  A tensor dim over
    several axes is sharded over them in mesh order, as JAX does."""
    from torch.distributed.tensor import Replicate, Shard  # noqa: PLC0415

    names = _names(mesh)
    out = [Replicate()] * len(names)
    for dim, axes in enumerate(spec):
        if axes is None:
            continue
        for a in (axes if isinstance(axes, tuple) else (axes,)):
            out[names.index(a)] = Shard(dim)
    return out


def spec_of(mesh, pls, ndim: int) -> Spec:
    """One placement per mesh dimension -> the spec (the inverse of
    ``placements``; trailing replicated dims written as None)."""
    from torch.distributed.tensor import Shard  # noqa: PLC0415

    dims: list = [[] for _ in range(ndim)]
    for name, pl in zip(_names(mesh), pls):
        if isinstance(pl, Shard):
            dims[pl.dim % ndim].append(name)
    return tuple(None if not d else d[0] if len(d) == 1 else tuple(d)
                 for d in dims)


# ---------------------------------------------------------------------------
# Port names -> the reference's paths
# ---------------------------------------------------------------------------


def reference_key(name: str, cfg) -> tuple[str, int | None]:
    """A port state-dict name -> (the reference's ``keystr`` of the same
    leaf, the size of its stacked axis or None).  ``layers.{L}.rest`` is
    ``['groups']['l{L % len(pattern)}'][rest]`` stacked over
    ``n_groups`` (whisper: ``['groups'][rest]`` over its decoder
    layers), ``enc.{j}.rest`` is ``['enc'][rest]`` over the encoder's
    layers, ``shared.rest`` is ``['shared'][rest]``, the rest keep their
    names."""
    parts = name.split(".")
    stack = None
    if parts[0] == "layers":
        layer, rest = int(parts[1]), parts[2:]
        if cfg.family == "audio":
            path, stack = ["groups"], cfg.n_layers
        else:
            path = ["groups", f"l{layer % len(cfg.pattern)}"]
            stack = cfg.n_groups
        path += rest
    elif parts[0] == "enc":
        path, stack = ["enc"] + parts[2:], cfg.encoder.n_layers
    else:
        path = parts
    return "".join(f"[{p!r}]" for p in path), stack


# ---------------------------------------------------------------------------
# Parameter rules
# ---------------------------------------------------------------------------


def _param_spec(mesh, path: str, shape: tuple[int, ...]) -> Spec:
    def ok(dim_idx, axes) -> bool:
        return _divides(shape[dim_idx], mesh, axes)

    # --- embeddings & head ---
    if path.endswith("['embed']"):
        return ("model", None) if ok(0, "model") else (None, None)
    if path.endswith("['head']"):
        return (None, "model") if ok(1, "model") else (None, None)

    # --- MoE experts: EP over 'model' + FSDP over 'data' ---
    # 'data' goes on the d_model dim: dim 1 for (E, d, h) up/gate
    # projections, dim 2 for (E, h, d) down projections -- the local_map
    # EP path's in-specs.
    if "['moe']" in path:
        if path.endswith("['router']"):
            return (None, None)
        if len(shape) == 3:  # (E, d_in, d_out)
            spec = ["model" if ok(0, "model") else None, None, None]
            fsdp_dim = 2 if path.endswith("['w_down']") else 1
            if spec[0] == "model" and ok(fsdp_dim, "data"):
                spec[fsdp_dim] = "data"
            return tuple(spec)
        if len(shape) == 2:  # shared expert
            return (None, "model") if ok(1, "model") else (None, None)

    # --- attention ---
    if "['attn']" in path or "['xattn']" in path:
        if path.endswith("['wo']"):
            return ("model", None) if ok(0, "model") else (None, None)
        if len(shape) == 2:  # wq / wk / wv
            return (None, "model") if ok(1, "model") else (None, None)
        return (None,)       # qk norm scales

    # --- dense FFN ---
    if "['mlp']" in path:
        if path.endswith("['w_down']"):
            return ("model", None) if ok(0, "model") else (None, None)
        return (None, "model") if ok(1, "model") else (None, None)

    # --- mamba & everything else: replicated ---
    return (None,) * len(shape)


def param_spec(mesh, name: str, shape, cfg) -> Spec:
    """The spec of one port leaf: its reference leaf's, stacked axis
    dropped."""
    key, _ = reference_key(name, cfg)
    return _param_spec(mesh, key, tuple(shape))


def zero1_spec(mesh, name: str, shape, cfg) -> Spec:
    """The ZeRO-1 spec of one port leaf: the reference's (param spec +
    'data' on the largest free dim that divides, the stacked axis a
    candidate), stacked axis dropped."""
    key, stack = reference_key(name, cfg)
    shape = tuple(shape)
    full = ((stack,) if stack is not None else ()) + shape
    base = ((None,) if stack is not None else ()) \
        + _param_spec(mesh, key, shape)
    base = list(base) + [None] * (len(full) - len(base))
    if "data" not in base:
        cands = [(full[i], i) for i in range(len(full))
                 if base[i] is None and _divides(full[i], mesh, "data")]
        if cands:
            _, i = max(cands)
            base[i] = "data"
    return tuple(base[1:] if stack is not None else base)


def param_shardings(mesh, params: dict, cfg) -> dict:
    """name -> placements for a state dict (of tensors, meta ones too)."""
    return {name: placements(mesh, param_spec(mesh, name, t.shape, cfg))
            for name, t in params.items()}


def zero1_shardings(mesh, params: dict, cfg) -> dict:
    """Optimizer-moment placement: param spec + 'data' on the largest
    free (unsharded) dim that divides evenly -- ZeRO-1."""
    return {name: placements(mesh, zero1_spec(mesh, name, t.shape, cfg))
            for name, t in params.items()}


# ---------------------------------------------------------------------------
# Activation / batch / cache rules
# ---------------------------------------------------------------------------


def _map(tree, fn, path=()):
    """``fn(path, leaf)`` over a nested dict / list, keeping its shape."""
    if isinstance(tree, dict):
        return {k: _map(v, fn, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def _ndim(leaf) -> int:
    return leaf.ndim if isinstance(leaf, torch.Tensor) else 0


def batch_shardings(mesh, batch_tree, global_batch: int):
    dp = dp_axes(mesh)
    bspec = dp if global_batch % _axis_size(mesh, tuple(dp)) == 0 else None

    def one(_, leaf):
        return placements(mesh, (bspec,) + (None,) * (_ndim(leaf) - 1))

    return _map(batch_tree, one)


def cache_shardings(mesh, cache_tree, batch: int):
    """KV caches: batch over DP if divisible, else context-parallel on
    the sequence dim ('data').  The port's layer caches are a list of
    per-layer dicts, unstacked, so the batch is dim 0 of every layer
    leaf (the reference's dim 1 after its stacked axis)."""
    dp = dp_axes(mesh)
    batch_ok = batch % _axis_size(mesh, tuple(dp)) == 0

    def one(path, leaf):
        ndim = _ndim(leaf)
        if ndim == 0:
            return placements(mesh, ())
        shape = tuple(leaf.shape)
        spec: list = [None] * ndim
        if batch_ok and shape[0] == batch:
            spec[0] = dp
        elif path[-1] in ("k", "v") and ndim > 1 \
                and _divides(shape[1], mesh, "data"):
            # context-parallel cache (batch too small to shard)
            spec[1] = "data"
        return placements(mesh, tuple(spec))

    return _map(cache_tree, one)


def make_activation_sharder(mesh, opts: frozenset[str] = frozenset()):
    """Installable hook for repro_torch.parallel.ctx.activation_sharding.

    ``opts`` enables the reference's optimisation variants:
      attn_batch_only   pin q/k/v (and decode caches) to batch-only
                        sharding -- attention computed model-replicated.
      moe_gather_weights  regather FSDP-sharded expert weights once per
                        layer (classic FSDP) instead of contracting over
                        the sharded d_model dim.
      seq_par           sequence-shard the residual stream over 'model'.

    A DTensor is redistributed to the name's placements; a plain tensor
    passes unchanged, as the reference's hook returns an array it
    cannot constrain.
    """
    from torch.distributed.tensor import DTensor  # noqa: PLC0415

    dp = dp_axes(mesh)
    n_model = _sizes(mesh)["model"]

    def batch_spec(x):
        if x.shape[0] % _axis_size(mesh, tuple(dp)) == 0:
            return (dp,) + (None,) * (x.ndim - 1)
        return None

    def sharder(name: str, x):
        if not isinstance(x, DTensor):
            return x
        spec = None
        if name == "resid" and x.ndim >= 2:
            spec = batch_spec(x)
            if spec is not None and "seq_par" in opts and x.ndim == 3 \
                    and x.shape[1] % n_model == 0:
                spec = (dp, "model", None)
        elif name == "logits" and x.ndim == 3:
            bspec = dp if x.shape[0] % _axis_size(mesh, tuple(dp)) == 0 \
                else None
            vspec = "model" if x.shape[-1] % n_model == 0 else None
            spec = (bspec, None, vspec)
        elif name == "kv" and x.ndim >= 2:
            spec = batch_spec(x)
        elif name in ("attn_q", "attn_kv") and \
                "attn_batch_only" in opts and x.ndim >= 2:
            spec = batch_spec(x)
        elif name == "moe_w" and "moe_gather_weights" in opts:
            # expert weights: keep EP over 'model', gather over 'data'
            spec = ("model",) + (None,) * (x.ndim - 1) \
                if x.shape[0] % n_model == 0 else (None,) * x.ndim
        elif name == "moe_xe" and "moe_gather_weights" in opts:
            spec = ("model",) + (None,) * (x.ndim - 1) \
                if x.shape[0] % n_model == 0 else None
        if spec is None:
            return x
        return x.redistribute(mesh, placements(mesh, spec))

    return sharder


def replicated(mesh, tree):
    return _map(tree, lambda _, leaf: placements(mesh, ()))
