"""One rank of a CPU mesh test of the PyTorch port (run by
``tests/test_torch_mesh.py``, one process per rank).

    PYTHONPATH=src python tests/_torch_mesh_ranks.py CASE RANK WORLD DIR

Ranks meet through a ``FileStore`` under DIR (no port is opened), read
their inputs from DIR and write ``DIR/CASE_RANK.pt``.  Cases:

  ep       8 gloo ranks, a (2 data, 4 model) mesh: ``moe_block_ep``
           against ``moe_block``, values and gradients, plain and DTensor
           inputs, and E % model != 0
  sharded  6 gloo ranks, a (6,) 'model' mesh: ``CodedLinear.apply_sharded``
  restore  4 gloo ranks, a (2, 2) mesh: ``restore_resharded`` of a JAX
           trainer checkpoint by ``param_shardings`` / ``zero1_shardings``
  specs    one process, ``fake`` process groups of 256 and 8 ranks: every
           arch's parameter, ZeRO-1, batch and cache placements as specs
  models   4 gloo ranks, a (2 data, 2 model) mesh: the smoke configs of
           granite-moe (default MoE path), phi3-mini, gemma3 and mamba2
           in f32, placed by the sharding rules, against the same
           weights off the mesh: a prefill and 3 decode steps, and one
           ``train_loss`` backward's gradients
"""

from __future__ import annotations

import sys
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

TIMEOUT = timedelta(seconds=120)


def _mesh(shape, names):
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh("cpu", shape, mesh_dim_names=names)


def case_ep(rank: int, d: Path) -> dict:
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.configs.base import MoEConfig
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.moe import moe_block, moe_block_ep
    from repro_torch.parallel.sharding import placements

    mesh = make_test_mesh()                     # (2 data, 4 model)
    assert tuple(mesh.shape) == (2, 4)
    z = np.load(d / "ep_inputs.npz")
    moe = MoEConfig(n_experts=8, top_k=2, d_expert=16, capacity_factor=32.0)
    names = ("router", "w_gate", "w_up", "w_down")

    def leaves():
        p = {n: torch.tensor(z[n], requires_grad=True) for n in names}
        return p, torch.tensor(z["x"], requires_grad=True)

    cot = torch.tensor(z["cot"])

    def run(fn):
        p, x = leaves()
        y, aux = fn(p, x)
        (torch.sum(y * cot) + 0.5 * aux).backward()
        return {"y": y.detach(), "aux": aux.detach(),
                "grads": {**{n: p[n].grad for n in names}, "x": x.grad}}

    def ref(p, x):
        # moe_block's output; aux as the EP path defines it, the mean over
        # the data shards of each shard's own Switch aux
        y, _ = moe_block(p, x, moe)
        aux = torch.stack([moe_block(p, xs, moe)[1]
                           for xs in x.chunk(2)]).mean()
        return y, aux

    out = {"ep": run(lambda p, x: moe_block_ep(p, x, moe, mesh, ("data",),
                                                "model")),
           "ref": run(ref)}
    # DTensor inputs placed as the EP in-specs: the output is a DTensor
    specs = {"router": (None, None), "w_gate": ("model", "data", None),
             "w_up": ("model", "data", None), "w_down": ("model", None, "data")}
    p = {n: distribute_tensor(torch.tensor(z[n]), mesh,
                              placements(mesh, specs[n])) for n in names}
    x = distribute_tensor(torch.tensor(z["x"]), mesh,
                          placements(mesh, ("data", None, None)))
    y, aux = moe_block_ep(p, x, moe, mesh, ("data",), "model")
    out["dtensor"] = {"y": y.full_tensor(), "aux": aux.full_tensor(),
                      "y_local": y.to_local(),
                      "y_placements": [str(pl) for pl in y.placements]}
    # E % model != 0: moe_block, as the reference
    moe6 = MoEConfig(n_experts=6, top_k=2, d_expert=16, capacity_factor=32.0)
    p6 = {n: torch.tensor(z[n + "6"]) for n in names}
    x6 = torch.tensor(z["x"])
    out["nodiv"] = {"ep": moe_block_ep(p6, x6, moe6, mesh, ("data",),
                                       "model"),
                    "ref": moe_block(p6, x6, moe6)}
    return out


def case_sharded(rank: int, d: Path) -> dict:
    from repro_torch.parallel.coded_layer import CodedLinear

    mesh = _mesh((6,), ("model",))
    z = np.load(d / "sharded_inputs.npz")
    w, x = torch.tensor(z["w"]), torch.tensor(z["x"])
    layer = CodedLinear.build(w, n_workers=6, stragglers=2, seed=1,
                              device="cpu")
    done = np.ones(6, bool)
    done[[1, 4]] = False
    out = {"y": layer.apply_sharded(mesh, "model", x, done),
           "y_all": layer.apply_sharded(mesh, "model", x)}
    for n, s in ((5, 1), (8, 2)):      # an axis whose size is not n
        wrong = CodedLinear.build(w, n_workers=n, stragglers=s, seed=1,
                                  device="cpu")
        try:
            wrong.apply_sharded(mesh, "model", x, None)
            out[f"raised_n{n}"] = None
        except ValueError as e:
            out[f"raised_n{n}"] = str(e)
    return out


def case_restore(rank: int, d: Path) -> dict:
    from torch.distributed.tensor import DTensor

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.optim.adamw import init_state
    from repro_torch.parallel.sharding import (
        param_shardings,
        spec_of,
        zero1_shardings,
    )
    from repro_torch.train import checkpoint

    arch = (d / "restore_arch.txt").read_text().strip()
    cfg = get_smoke_config(arch)
    mesh = _mesh((2, 2), ("data", "model"))
    model = build_model(cfg, torch.float32, device="cpu")
    params = {k: v.detach() for k, v in model.state_dict().items()}
    opt = init_state(AdamWConfig(), params)
    template = {"params": params, "opt": opt}
    zs = zero1_shardings(mesh, params, cfg)
    shardings = {"params": param_shardings(mesh, params, cfg),
                 "opt": {"step": None, "m": zs, "v": zs}}
    step = checkpoint.latest_step(d / "ckpt")
    got = checkpoint.restore_resharded(d / "ckpt", step, template,
                                       shardings, mesh=mesh, cfg=cfg)
    out = {"coordinate": mesh.get_coordinate(), "step": int(got["opt"]["step"])}
    for part, tree in (("params", got["params"]), ("m", got["opt"]["m"]),
                       ("v", got["opt"]["v"])):
        out[part] = {}
        for name, t in tree.items():
            assert isinstance(t, DTensor), name
            out[part][name] = {"local": t.to_local(), "full": t.full_tensor(),
                               "spec": spec_of(mesh, t.placements, t.ndim)}
    return out


MODEL_ARCHS = ("granite-moe-1b-a400m", "phi3-mini-3.8b", "gemma3-12b",
               "mamba2-1.3b")


def case_models(rank: int, d: Path) -> dict:
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_model
    from repro_torch.parallel.ctx import activation_sharding
    from repro_torch.parallel.sharding import (
        batch_shardings,
        make_activation_sharder,
        param_shardings,
    )

    mesh = _mesh((2, 2), ("data", "model"))
    z = np.load(d / "models_inputs.npz")
    out = {}
    for i, arch in enumerate(MODEL_ARCHS):
        cfg = get_smoke_config(arch)
        plain = build_model(cfg, torch.float32, device="cpu")
        sd = plain.init(torch.Generator().manual_seed(i))
        placed = build_model(cfg, torch.float32, device="cpu")
        shardings = param_shardings(mesh, sd, cfg)
        placed.load_state_dict(
            {k: distribute_tensor(v.clone(), mesh, shardings[k])
             for k, v in sd.items()}, assign=True)
        batch = {k: torch.tensor(z[k]) for k in ("prompt", "steps", "tokens",
                                                 "labels")}
        pls = batch_shardings(mesh, batch, batch["prompt"].shape[0])
        dist_batch = {k: distribute_tensor(v, mesh, pls[k])
                      for k, v in batch.items()}

        def serve(model, b):
            with torch.no_grad():
                logits, cache = model.prefill(b["prompt"], max_len=16)
                got = [logits]
                for j in range(b["steps"].shape[1]):
                    logits, cache = model.decode_step(
                        cache, b["steps"][:, j:j + 1])
                    got.append(logits)
            return got

        def grads(model, b):
            model.requires_grad_(True)
            model.train_loss({"tokens": b["tokens"],
                              "labels": b["labels"]}).backward()
            return {k: p.grad for k, p in model.named_parameters()}

        want = serve(plain, batch)
        want_grads = grads(plain, batch)
        with implicit_replication(), \
                activation_sharding(make_activation_sharder(mesh)):
            got = serve(placed, dist_batch)
            got_grads = grads(placed, dist_batch)
        out[arch] = {"want": want, "got": [g.full_tensor() for g in got],
                     "want_grads": want_grads,
                     "got_grads": {k: g.full_tensor()
                                   for k, g in got_grads.items()},
                     "embed": str(placed.embed.placements)}
    return out


def case_specs(d: Path) -> dict:
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro.configs import ARCH_IDS
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.models import (
        build_model,
        decode_specs,
        prefill_specs,
        train_batch_specs,
    )
    from repro_torch.parallel import sharding as sh

    def specs(tree, pls):
        if isinstance(tree, dict):
            return {k: specs(v, pls[k]) for k, v in tree.items()}
        if isinstance(tree, list):
            return [specs(v, p) for v, p in zip(tree, pls)]
        nd = tree.ndim if isinstance(tree, torch.Tensor) else 0
        return sh.spec_of(mesh, pls, nd)

    out = {}
    for shape in ((32, 8), (2, 4)):
        world = shape[0] * shape[1]
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=world)
        mesh = _mesh(shape, ("data", "model"))
        key = "x".join(map(str, shape))
        out[key] = {"param": {}, "zero1": {}, "batch": {}, "cache": {}}
        for arch in ARCH_IDS:
            cfg = get_config(arch)
            sd = build_model(cfg, torch.bfloat16, device="meta").state_dict()
            out[key]["param"][arch] = specs(
                sd, sh.param_shardings(mesh, sd, cfg))
            out[key]["zero1"][arch] = specs(
                sd, sh.zero1_shardings(mesh, sd, cfg))
        for arch in ("phi3-mini-3.8b", "whisper-tiny"):
            cfg = get_config(arch)
            for name in ("train_4k", "prefill_32k", "decode_32k"):
                s = SHAPES[name]
                batch = (train_batch_specs(cfg, s) if s.kind == "train"
                         else prefill_specs(cfg, s) if s.kind == "prefill"
                         else decode_specs(cfg, s)["tokens"])
                out[key]["batch"][f"{arch}/{name}"] = specs(
                    batch, sh.batch_shardings(mesh, batch, s.global_batch))
                if s.kind == "decode":
                    cache = decode_specs(cfg, s)["cache"]
                    out[key]["cache"][f"{arch}/{name}"] = specs(
                        cache, sh.cache_shardings(mesh, cache,
                                                  s.global_batch))
        dist.destroy_process_group()
    return out


def main() -> None:
    case, rank, world, d = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), \
        Path(sys.argv[4])
    if case == "specs":
        torch.save(case_specs(d), d / "specs_0.pt")
        return
    store = dist.FileStore(str(d / f"{case}.store"), world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world,
                            timeout=TIMEOUT)
    try:
        out = {"ep": case_ep, "sharded": case_sharded,
               "restore": case_restore, "models": case_models}[case](rank, d)
        torch.save(out, d / f"{case}_{rank}.pt")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
