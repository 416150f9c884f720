"""Activation-sharding context.

Model code stays mesh-agnostic: it calls ``shard(name, x)`` at canonical
cut points (residual stream, logits, kv-cache, moe buffers).  The
launcher installs a sharder that maps names to ``DTensor.redistribute``
placements for the active mesh; outside a mesh the hook is the
identity, so smoke tests and single-device runs are untouched.

The counterpart of ``repro.parallel.ctx``, on ``torch.distributed``:
``shard_map_compat`` wraps ``local_map`` (the counterpart of
``shard_map``); ``reshape`` and ``per_head`` are where the port does by
hand what XLA's partitioner does in the reference: a DTensor refuses a
view that cuts a shard in two (a head split over more ranks than the
heads divide is gathered first), and attention runs on each rank's
local batch rows and heads.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable

import torch

_state = threading.local()


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor  # noqa: PLC0415

    return isinstance(x, DTensor)


def shard_map_compat(f, *, mesh, in_specs, out_specs, in_grad_specs=None):
    """``f`` run on each rank's local shards, the counterpart of the
    reference's ``shard_map`` (``torch.distributed.tensor.experimental.
    local_map``).

    ``in_specs`` / ``out_specs``: one list of placements (one per mesh
    dimension) per tensor argument / output; ``in_grad_specs``: the
    placements of each input's gradient, where they differ from its own
    (a replicated input whose gradient each rank only holds a part of
    is ``Partial``).  A plain tensor argument is taken as the global
    value, the same on every rank, as the reference takes a global
    array: it enters as a replicated DTensor and is cut to its in-spec
    locally, without a copy or a collective.  When every tensor argument
    is plain, the outputs come back plain (``full_tensor``); otherwise
    they are DTensors.  The reference's ``check_vma`` has no counterpart.
    """
    from torch.distributed.tensor import DTensor, Replicate  # noqa: PLC0415
    from torch.distributed.tensor.experimental import local_map  # noqa: PLC0415

    fn = local_map(f, out_placements=tuple(tuple(s) for s in out_specs),
                   in_placements=tuple(tuple(s) for s in in_specs),
                   in_grad_placements=(
                       None if in_grad_specs is None
                       else tuple(tuple(s) for s in in_grad_specs)),
                   device_mesh=mesh, redistribute_inputs=True)
    replicate = [Replicate()] * mesh.ndim

    def run(*args):
        plain = not any(_is_dtensor(a) for a in args)
        args = [DTensor.from_local(a, mesh, replicate, run_check=False)
                if isinstance(a, torch.Tensor) and not _is_dtensor(a) else a
                for a in args]
        out = fn(*args)
        if not plain:
            return out
        return tuple(o.full_tensor() if _is_dtensor(o) else o for o in out)

    return run


# --- collectives inside a local_map body ----------------------------------
# The counterparts of jax.lax.psum / pmean / all_gather in a shard_map
# body, on the functional collectives (which a dispatch mode sees and
# the fake process group traces).  Each differentiates as the local_map
# output placements say: a sum or mean whose result is replicated passes
# each rank's gradient straight back (scaled by 1/N for the mean), and a
# gather's gradient is summed and scattered back to the shards.  A
# one-rank group issues no collective and makes no copy.


def _wait(t: torch.Tensor) -> torch.Tensor:
    return t.wait() if hasattr(t, "wait") else t


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, scale):
        import torch.distributed._functional_collectives as funcol  # noqa: PLC0415

        ctx.scale = scale
        out = _wait(funcol.all_reduce(x, "sum", group))
        return out * scale if scale != 1.0 else out

    @staticmethod
    def backward(ctx, g):
        return (g * ctx.scale if ctx.scale != 1.0 else g), None, None


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group``'s ranks, replicated on each."""
    if group.size() == 1:
        return x
    return _AllReduce.apply(x, group, 1.0)


def pmean(x: torch.Tensor, groups) -> torch.Tensor:
    """The mean of ``x`` over every rank of ``groups``, replicated."""
    for group in groups:
        if group.size() > 1:
            x = _AllReduce.apply(x, group, 1.0 / group.size())
    return x


def all_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """``group``'s shards of ``x`` concatenated along ``dim`` (the
    reference's ``all_gather(..., tiled=True)``)."""
    if group.size() == 1:
        return x
    import torch.distributed._functional_collectives as funcol  # noqa: PLC0415

    gather = getattr(funcol, "all_gather_single_autograd", None) \
        or funcol.all_gather_tensor_autograd      # the older name
    return _wait(gather(x, dim, group))


def reshape(t: torch.Tensor, *shape: int) -> torch.Tensor:
    """``t.reshape(*shape)`` for the attention's head splits and merges.

    On a mesh, a shard of a dimension that the reshape splits or merges
    stays only where DTensor can keep it: on the first dimension after
    the unchanged leading ones, when the new size there divides.  Any
    other is gathered first (whisper-tiny's 6 heads over 8 ranks, or 40
    query heads over 8 grouped into 10 KV groups): DTensor refuses a
    view that cuts a shard, where the reference's XLA reshards by
    itself.  A plain tensor is reshaped as is."""
    if not _is_dtensor(t):
        return t.reshape(*shape)
    from torch.distributed.tensor import Replicate, Shard  # noqa: PLC0415

    if -1 in shape:
        known = 1
        for n in shape:
            known *= n if n != -1 else 1
        shape = tuple(t.numel() // known if n == -1 else n for n in shape)
    keep = 0
    while keep < min(t.ndim, len(shape)) and t.shape[keep] == shape[keep]:
        keep += 1
    mesh = t.device_mesh
    placements = list(t.placements)
    for i, pl in enumerate(placements):
        if not isinstance(pl, Shard) or pl.dim % t.ndim < keep:
            continue
        if pl.dim % t.ndim > keep or shape[keep] % mesh.size(i):
            placements[i] = Replicate()
    if placements != list(t.placements):
        t = t.redistribute(mesh, placements)
    return t.reshape(*shape)


def _head_aligned(q, k, v):
    """q (B, S, H, D) and k/v (B, Sk, KV, D) DTensors redistributed so
    that each rank holds whole batch rows and whole GQA groups: a mesh
    dimension keeps q's batch shard (k and v follow it) and a head shard
    where both head counts divide it (k and v follow it too); every
    other shard or partial is gathered."""
    from torch.distributed.tensor import Replicate, Shard  # noqa: PLC0415

    mesh = q.device_mesh
    h, kv = q.shape[2], k.shape[2]
    qp, kp = [], []
    for i, pl in enumerate(q.placements):
        size = mesh.size(i)
        if isinstance(pl, Shard) and pl.dim == 0:
            qp.append(Shard(0))
            kp.append(Shard(0))
        elif isinstance(pl, Shard) and pl.dim == 2 and h % size == 0 \
                and kv % size == 0:
            qp.append(Shard(2))
            kp.append(Shard(2))
        else:
            qp.append(Replicate())
            kp.append(Replicate())

    def to(t, pls):
        return t if list(t.placements) == pls else t.redistribute(mesh, pls)

    return to(q, qp), to(k, kp), to(v, kp)


def per_head(fn):
    """Attention ``fn(q, k, v, *args)`` is independent per batch row and
    per GQA group: on DTensors it runs on each rank's local shards
    (``local_map``), after ``_head_aligned``, with no collective and
    without DTensor's op-by-op lowering, which cannot flatten a batch
    shard and a head shard together into one matmul batch.  The other
    arguments (positions, flags) must not carry a batch dimension.
    Plain tensors call ``fn`` as is."""
    import functools  # noqa: PLC0415

    @functools.wraps(fn)
    def run(q, k, v, *args, **kw):
        if not _is_dtensor(q):
            return fn(q, k, v, *args, **kw)
        from torch.distributed.tensor.experimental import local_map  # noqa: PLC0415

        q, k, v = _head_aligned(q, k, v)
        body = local_map(lambda q, k, v: fn(q, k, v, *args, **kw),
                         out_placements=(tuple(q.placements),),
                         in_placements=(tuple(q.placements),
                                        tuple(k.placements),
                                        tuple(v.placements)),
                         device_mesh=q.device_mesh)
        return body(q, k, v)

    return run


def _identity(name: str, x):
    return x


def shard(name: str, x):
    fn: Callable = getattr(_state, "sharder", _identity)
    return fn(name, x)


@contextlib.contextmanager
def activation_sharding(fn: Callable):
    prev = getattr(_state, "sharder", _identity)
    _state.sharder = fn
    try:
        yield
    finally:
        _state.sharder = prev


# --- expert-parallel execution context -------------------------------------
# When set, MoE layers run through the local_map EP path (local dispatch
# per data shard, expert weights gathered over 'data', one sum over
# 'model') instead of the DTensor-propagated path.


def ep_context():
    return getattr(_state, "ep", None)


@contextlib.contextmanager
def expert_parallel(mesh, dp_axes: tuple[str, ...], model_axis: str):
    prev = getattr(_state, "ep", None)
    _state.ep = (mesh, tuple(dp_axes), model_axis)
    try:
        yield
    finally:
        _state.ep = prev
