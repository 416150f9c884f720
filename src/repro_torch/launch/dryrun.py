"""Multi-pod dry run: trace every (arch x shape x mesh) cell on meta.

For each cell this builds the REAL step -- the full train step (loss +
grad + the AdamW update with ZeRO-1 moments) for train shapes,
``prefill`` / one-token ``decode_step`` for serving shapes -- with the
production shardings, and runs it once on ``meta`` DTensors over a
``fake`` process group of 256 (``32x8``) or 512 (``2x32x8``) ranks, all
in this one process:

    dist.init_process_group("fake", store=FakeStore(), world_size=256)
    mesh   = make_production_mesh(device_type="cpu")
    params = {name: distribute_tensor(meta leaf, mesh, placements)}
    with RankCounter(), CollectiveCounter(), implicit_replication():
        step(params, ...)

Nothing is allocated and nothing is computed: every op runs on meta
tensors, every collective on the fake group.  What the reference reads
from XLA's compiled program comes from the run itself:

  flops             PER RANK, as XLA's per-device cost analysis in the
                    reference: ``RankCounter`` sums
                    ``torch.utils.flop_counter``'s formulas over the
                    local ops one rank runs (DTensor lowers each op to
                    its local shards first; local_map bodies are local)
  collective_bytes  ``analysis.collectives.CollectiveCounter``: every
  collective_counts functional collective as dispatched, output bytes
  memory            per-rank bytes from the local shard sizes (see
                    ``memory_notes`` in each artifact)

One JSON artifact per cell (consumed by ``analysis.roofline``); a cell
that raises is written with ``status: error`` and its traceback's tail.

Usage:
    python -m repro_torch.launch.dryrun --arch qwen3-14b --shape train_4k
    python -m repro_torch.launch.dryrun --all --multi-pod both --out artifacts/
"""

from __future__ import annotations

import argparse
import contextlib
import json
import time
import traceback
import weakref
from pathlib import Path

import torch

from ..analysis.collectives import CollectiveCounter
from ..configs import ARCH_IDS, SHAPES, get_config, get_smoke_config
from ..models import (
    build_model,
    decode_specs,
    prefill_specs,
    supports_shape,
    train_batch_specs,
)
from ..optim.adamw import AdamWConfig, apply_updates
from ..parallel.ctx import activation_sharding, expert_parallel
from ..parallel.sharding import (
    batch_shardings,
    cache_shardings,
    dp_axes,
    make_activation_sharder,
    param_shardings,
    zero1_shardings,
)
from .mesh import make_production_mesh, mesh_name


def _place(tree, shardings, mesh):
    """Each tensor leaf of ``tree`` as a DTensor placed on ``mesh`` by the
    same path of ``shardings`` (host ints stay as they are)."""
    from torch.distributed.tensor import distribute_tensor  # noqa: PLC0415

    if isinstance(tree, dict):
        return {k: _place(v, shardings[k], mesh) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_place(v, s, mesh) for v, s in zip(tree, shardings)]
    if not isinstance(tree, torch.Tensor):
        return tree
    return distribute_tensor(tree, mesh, shardings)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


def _local_bytes(tree) -> int:
    """The bytes one rank holds of ``tree``'s tensors (a DTensor's local
    shard)."""
    from torch.distributed.tensor import DTensor  # noqa: PLC0415

    total = 0
    for t in _leaves(tree):
        loc = t.to_local() if isinstance(t, DTensor) else t
        total += loc.numel() * loc.element_size()
    return total


class RankCounter(torch.utils._python_dispatch.TorchDispatchMode):
    """What one rank does: the FLOPs of its local ops (by
    ``torch.utils.flop_counter``'s formulas) and the bytes of its op
    outputs alive at once.

    DTensor ops are let through (``NotImplemented``) so that their local
    ops, and the collectives of their redistributions, come back here;
    the fake-tensor runs DTensor makes to infer a global output shape are
    neither computed nor allocated by any rank and are not counted.
    Views and in-place ops allocate nothing.  An output counts from the
    op that makes it until its last Python reference goes; autograd's
    saved tensors are held by a pass-through ``saved_tensors_hooks``, so
    they count while the graph keeps them.  ``peak`` is an estimate: the
    allocator's caching and fragmentation and the collectives' buffers
    are not modelled."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.live = 0
        self.peak = 0
        self._hooks = torch.autograd.graph.saved_tensors_hooks(
            lambda t: t, lambda t: t)

    def __enter__(self):
        self._hooks.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        out = super().__exit__(*exc)
        self._hooks.__exit__(*exc)
        return out

    def _free(self, nbytes: int) -> None:
        self.live -= nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor  # noqa: PLC0415
        from torch.distributed.tensor import DTensor  # noqa: PLC0415
        from torch.utils.flop_counter import flop_registry  # noqa: PLC0415

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if any(issubclass(t, FakeTensor) for t in types) \
                or isinstance(out, FakeTensor):
            return out
        count = flop_registry.get(func._overloadpacket)
        if count is not None:
            self.flops += count(*args, **kwargs, out_val=out)
        if any(r.alias_info is not None for r in func._schema.returns):
            return out
        for t in _leaves(out):
            nbytes = t.numel() * t.element_size()
            self.live += nbytes
            weakref.finalize(t, self._free, nbytes)
        self.peak = max(self.peak, self.live)
        return out


def _microbatches(batch: dict, micro: int) -> list[dict]:
    """The global batch cut into ``micro`` microbatches per data shard:
    each rank splits its local rows (the reference reshapes the global
    batch; the shapes and the work per rank are the same)."""
    from torch.distributed.tensor import DTensor  # noqa: PLC0415

    out = [{} for _ in range(micro)]
    for name, t in batch.items():
        loc = t.to_local()
        rows = loc.shape[0] // micro
        for i in range(micro):
            out[i][name] = DTensor.from_local(
                loc[i * rows:(i + 1) * rows], t.device_mesh, t.placements,
                run_check=False)
    return out


def build_cell(arch: str, shape_name: str, mesh, dtype=torch.bfloat16,
               microbatches: int = 4, cfg=None,
               opts: frozenset = frozenset()):
    """-> (step, args): ``step(*args)`` runs the cell once; ``args`` are
    meta DTensors placed by the sharding rules."""
    cfg = cfg or get_config(arch)
    if "remat_dots" in opts:
        cfg = cfg.with_(remat="dots")
    shape = SHAPES[shape_name]
    model = build_model(cfg, dtype, device="meta")
    pspecs = model.state_dict()
    params = _place(pspecs, param_shardings(mesh, pspecs, cfg), mesh)
    model.load_state_dict(params, assign=True)
    sharder = make_activation_sharder(mesh, opts)

    def env():
        st = contextlib.ExitStack()
        st.enter_context(activation_sharding(sharder))
        if "moe_ep" in opts:
            st.enter_context(expert_parallel(mesh, dp_axes(mesh), "model"))
        return st

    if shape.kind == "train":
        opt_cfg = AdamWConfig(moment_dtype="bfloat16")
        moment = {k: torch.empty(v.shape, dtype=torch.bfloat16,
                                 device="meta") for k, v in pspecs.items()}
        zshard = zero1_shardings(mesh, moment, cfg)
        opt_state = {"step": torch.zeros((), dtype=torch.int32),
                     "m": _place(moment, zshard, mesh),
                     "v": _place(moment, zshard, mesh)}
        bspecs = train_batch_specs(cfg, shape, dtype)
        batch = _place(bspecs, batch_shardings(mesh, bspecs,
                                               shape.global_batch), mesh)
        model.requires_grad_(True)

        def train_step(model, opt_state, batch):
            params = dict(model.named_parameters())
            with env():
                losses = []
                for mb in _microbatches(batch, microbatches):
                    loss = model.train_loss(mb) / microbatches
                    loss.backward()
                    losses.append(loss.detach())
            grads = {k: p.grad for k, p in params.items()}
            _, opt_state, _ = apply_updates(opt_cfg, params, grads,
                                            opt_state)
            return sum(losses), opt_state

        return train_step, (model, opt_state, batch)

    if shape.kind == "prefill":
        bspecs = prefill_specs(cfg, shape, dtype)
        batch = _place(bspecs, batch_shardings(mesh, bspecs,
                                               shape.global_batch), mesh)

        def prefill_step(model, batch):
            with env(), torch.no_grad():
                return model.prefill(batch["tokens"], max_len=shape.seq_len,
                                     **{k: v for k, v in batch.items()
                                        if k != "tokens"})

        return prefill_step, (model, batch)

    dspecs = decode_specs(cfg, shape, dtype)
    cache = _place(dspecs["cache"], cache_shardings(
        mesh, dspecs["cache"], shape.global_batch), mesh)
    tokens = _place(dspecs["tokens"], batch_shardings(
        mesh, dspecs["tokens"], shape.global_batch), mesh)

    def decode_step(model, cache, tokens):
        with env(), torch.no_grad():
            return model.decode_step(cache, tokens)

    return decode_step, (model, cache, tokens)


def _memory(args, out, live: RankCounter) -> tuple[dict, dict]:
    arg_bytes = _local_bytes(args[0].state_dict()) + _local_bytes(args[1:])
    out_bytes = _local_bytes(out)
    mem = {"argument_size_in_bytes": arg_bytes,
           "output_size_in_bytes": out_bytes,
           "temp_size_in_bytes": live.peak,
           "peak_memory_in_bytes": arg_bytes + live.peak}
    notes = {
        "argument_size_in_bytes": "per rank: the local shards of the "
        "parameters, optimizer state, batch and cache the step takes",
        "output_size_in_bytes": "per rank: the local shards of what the "
        "step returns (train: the loss and the updated optimizer state, "
        "whose buffers are the arguments', updated in place)",
        "temp_size_in_bytes": "per rank: the most op-output bytes alive "
        "at once while the step ran (RankCounter: local tensors, views "
        "free, saved-for-backward tensors held by the graph)",
        "peak_memory_in_bytes": "estimate: argument bytes + "
        "temp_size_in_bytes (no allocator caching, fragmentation or "
        "collective buffers)"}
    return mem, notes


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             out_dir: Path | None = None, verbose: bool = True,
             opts: frozenset = frozenset(),
             microbatches: int = 4, smoke: bool = False) -> dict:
    """One cell on a fake process group of the production mesh's size,
    set up and torn down here.  ``smoke``: the arch's smoke config at
    the cell's shape (the port's own, for tests and rehearsals)."""
    import torch.distributed as dist  # noqa: PLC0415
    from torch.distributed.tensor.experimental import implicit_replication  # noqa: PLC0415
    from torch.testing._internal.distributed.fake_pg import FakeStore  # noqa: PLC0415

    cfg = (get_smoke_config if smoke else get_config)(arch)
    shape = SHAPES[shape_name]
    ok, reason = supports_shape(cfg, shape)
    name = mesh_name(multi_pod)
    result = {"arch": arch, "shape": shape_name, "mesh": name,
              "opts": sorted(opts), "microbatches": microbatches,
              "status": "skipped", "reason": reason}
    if smoke:
        result["smoke"] = True
    if not ok:
        if verbose:
            print(f"[skip] {arch} x {shape_name} ({name}): {reason}")
        _write(out_dir, result, opts, microbatches)
        return result

    world = 512 if multi_pod else 256
    t0 = time.perf_counter()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        step, args = build_cell(arch, shape_name, mesh, cfg=cfg,
                                microbatches=microbatches, opts=opts)
        counter = CollectiveCounter()
        rank = RankCounter()
        with implicit_replication(), counter, rank:
            out = step(*args)
        mem, notes = _memory(args, out, rank)
        coll = counter.result()
        result.update({
            "status": "ok",
            "devices": world,
            "compile_s": round(time.perf_counter() - t0, 2),
            "flops": float(rank.flops),
            "flops_scope": "per rank (RankCounter: the local ops of one "
                           "rank, flop_counter's formulas)",
            "memory": mem,
            "memory_notes": notes,
            "collective_bytes": {k: v for k, v in coll.items()
                                 if k != "counts"},
            "collective_counts": coll["counts"],
            "model_params": cfg.param_count(),
            "active_params": cfg.active_param_count(),
        })
        if verbose:
            print(f"[ok]   {arch} x {shape_name} ({name}): "
                  f"traced {result['compile_s']}s  "
                  f"flops/rank {result['flops']:.3e}")
            print(f"       memory: {result['memory']}")
            print(f"       collectives: "
                  f"{ {k: f'{v:.2e}' for k, v in result['collective_bytes'].items() if v} }")
    except Exception as e:  # noqa: BLE001 - a cell's failure is its artifact
        result.update({"status": "error", "error": f"{type(e).__name__}: {e}",
                       "traceback": traceback.format_exc()[-2000:]})
        if verbose:
            print(f"[FAIL] {arch} x {shape_name} ({name}): {e}")
    finally:
        dist.destroy_process_group()
    _write(out_dir, result, opts, microbatches)
    return result


def _write(out_dir: Path | None, result: dict, opts, microbatches: int
           ) -> None:
    """The cell's artifact (skipped cells too), named as the
    reference's."""
    if out_dir is None:
        return
    out_dir.mkdir(parents=True, exist_ok=True)
    suffix = ("__" + "+".join(sorted(opts))) if opts else ""
    if microbatches != 4:
        suffix += f"__mb{microbatches}"
    if result.get("smoke"):
        suffix += "__smoke"
    fname = (f"{result['arch']}__{result['shape']}__{result['mesh']}"
             f"{suffix}.json")
    (out_dir / fname).write_text(json.dumps(result, indent=2))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=tuple(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", choices=("off", "on", "both"),
                    default="off")
    ap.add_argument("--out", type=Path, default=Path("artifacts/dryrun"))
    ap.add_argument("--opts", default="",
                    help="comma list: attn_batch_only,moe_gather_weights,"
                         "seq_par,moe_ep,remat_dots")
    ap.add_argument("--microbatches", type=int, default=4)
    ap.add_argument("--smoke", action="store_true",
                    help="the arch's smoke config (tests, rehearsals)")
    args = ap.parse_args(argv)
    opts = frozenset(o for o in args.opts.split(",") if o)

    pods = {"off": [False], "on": [True], "both": [False, True]}[args.multi_pod]
    cells = []
    if args.all:
        archs = (args.arch,) if args.arch else ARCH_IDS
        for arch in archs:
            for shape in SHAPES:
                cells.append((arch, shape))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape required unless --all")
        cells = [(args.arch, args.shape)]

    failures = 0
    for arch, shape in cells:
        for mp in pods:
            r = run_cell(arch, shape, mp, out_dir=args.out, opts=opts,
                         microbatches=args.microbatches, smoke=args.smoke)
            failures += r["status"] == "error"
    print(f"\ndry-run complete: {len(cells) * len(pods)} cells, "
          f"{failures} failures")
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
