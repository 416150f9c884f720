"""The port's mesh layer against the JAX package's, on the CPU.

The JAX side runs in subprocesses with forced host devices
(``--xla_force_host_platform_device_count``, as ``test_multidevice.py``
does); the port side runs as spawned gloo groups (one process per rank,
``tests/_torch_mesh_ranks.py``) that meet through a ``FileStore`` under
the module's temporary directory, each with its own 120 s timeout, and
the ``fake`` process-group checks run in a subprocess.  All of them run
once per module (a module fixture); each case below reads their
results.  Inputs are made from numpy seeds and handed to both sides.

  * sharding rules: every arch's parameter and ZeRO-1 specs equal the
    reference's (stacked group axis dropped) on (2, 4) and (32, 8), and
    divide; batch and cache specs of a dense arch and whisper;
  * ctx: the hook is the identity outside a mesh, and every smoke arch's
    forward is bitwise with an installed identity sharder;
  * EP: ``moe_block_ep`` on a (2, 4) gloo mesh against ``moe_block``
    (values and gradients) and the JAX ``moe_block_ep`` on 8 devices;
  * ``CodedLinear.apply_sharded`` on 6 gloo ranks against ``x @ w`` and
    the JAX ``apply_sharded`` on 6 devices;
  * ``restore_resharded`` of a JAX trainer checkpoint onto a (2, 2) gloo
    mesh, each rank's shard bitwise its slice of the archive;
  * the smoke configs of granite-moe (its default MoE path), phi3-mini,
    gemma3 and mamba2 placed on a (2 data, 2 model) gloo mesh by the
    sharding rules: a prefill, 3 decode steps and one ``train_loss``
    backward's gradients against the same weights off the mesh.
"""

import json
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCH_IDS, get_smoke_config
from repro_torch.configs import get_config as port_config
from repro_torch.convert import model_params_from_reference
from repro_torch.models import build_model
from repro_torch.models import moe as port_moe
from repro_torch.parallel.ctx import activation_sharding, shard
from repro_torch.parallel.sharding import reference_key
from repro_torch.train import checkpoint

ROOT = Path(__file__).resolve().parent.parent
RANKS = ROOT / "tests" / "_torch_mesh_ranks.py"
GROUP_TIMEOUT_S = 150       # a rank's own limit (its process group: 120 s)
RESTORE_ARCH = "kimi-k2-1t-a32b"
ENV = {"PYTHONPATH": "src", "PATH": "/usr/bin:/bin", "HOME": "/root",
       "JAX_PLATFORMS": "cpu"}


def _jax_proc(code: str, devices: int, out: Path) -> subprocess.Popen:
    prog = (f"import os\nos.environ['XLA_FLAGS'] = "
            f"'--xla_force_host_platform_device_count={devices}'\n"
            + textwrap.dedent(code))
    return subprocess.Popen([sys.executable, "-c", prog, str(out)],
                            cwd=ROOT, env=ENV, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _group(case: str, world: int, d: Path) -> list:
    return [subprocess.Popen([sys.executable, str(RANKS), case, str(r),
                              str(world), str(d)], cwd=ROOT, env=ENV,
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                             text=True) for r in range(world)]


def _wait(procs: list, what: str) -> None:
    errs = []
    for p in procs:
        try:
            _, err = p.communicate(timeout=GROUP_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            p.kill()
            _, err = p.communicate()
            errs.append(f"timed out: {err[-2000:]}")
            continue
        if p.returncode != 0:
            errs.append(err[-3000:])
    assert not errs, f"{what}: {errs[0]}"


JAX_EP = """
    import sys
    import jax, jax.numpy as jnp, numpy as np
    from pathlib import Path
    from repro.configs.base import MoEConfig
    from repro.models.moe import moe_block, moe_block_ep
    from repro.parallel.coded_layer import CodedLinear

    d = Path(sys.argv[1])
    z = np.load(d / "ep_inputs.npz")
    p = {n: jnp.asarray(z[n]) for n in ("router", "w_gate", "w_up", "w_down")}
    x = jnp.asarray(z["x"])
    moe = MoEConfig(n_experts=8, top_k=2, d_expert=16, capacity_factor=32.0)
    mesh = jax.make_mesh((2, 4), ("data", "model"))
    with mesh:
        y_ep, aux_ep = moe_block_ep(p, x, moe, mesh, ("data",), "model")
    y_ref, aux_ref = moe_block(p, x, moe)

    s = np.load(d / "sharded_inputs.npz")
    mesh6 = jax.sharding.Mesh(np.array(jax.devices()[:6]), ("model",))
    layer = CodedLinear.build(jnp.asarray(s["w"]), n_workers=6,
                              stragglers=2, seed=1)
    done = np.ones(6, bool); done[[1, 4]] = False
    y_sh = layer.apply_sharded(mesh6, "model", jnp.asarray(s["x"]),
                               jnp.asarray(done))
    np.savez(d / "jax_ep.npz", y_ep=np.asarray(y_ep),
             aux_ep=np.asarray(aux_ep), y_ref=np.asarray(y_ref),
             aux_ref=np.asarray(aux_ref), y_sharded=np.asarray(y_sh))

    # a checkpoint written by the JAX trainer: 2 steps of the smoke config
    from repro.configs import get_smoke_config
    from repro.data.pipeline import DataConfig, make_pipeline
    from repro.models import build_model
    from repro.optim.adamw import AdamWConfig
    from repro.train.trainer import TrainConfig, Trainer

    cfg = get_smoke_config((d / "restore_arch.txt").read_text().strip())
    tr = Trainer(build_model(cfg, jnp.float32),
                 AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=2),
                 TrainConfig(steps=2, ckpt_every=2, log_every=100,
                             ckpt_dir=str(d / "ckpt")))
    tr.fit(lambda start: make_pipeline(
        DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=4), start))
    print("JAX_EP_OK")
"""

JAX_SPECS = """
    import json, sys
    import jax, jax.numpy as jnp
    from repro.configs import ARCH_IDS, SHAPES, get_config
    from repro.models import (build_model, decode_specs, prefill_specs,
                              train_batch_specs)
    from repro.parallel.sharding import (batch_shardings, cache_shardings,
                                         param_shardings, zero1_shardings)

    def spec(sh):
        return [list(a) if isinstance(a, tuple) else a for a in sh.spec]

    def flat(tree):
        return {jax.tree_util.keystr(k): spec(v) for k, v in
                jax.tree_util.tree_flatten_with_path(tree)[0]}

    out = {}
    for shape in ((32, 8), (2, 4)):
        mesh = jax.sharding.Mesh(
            __import__("numpy").array(jax.devices()[:shape[0] * shape[1]])
            .reshape(shape), ("data", "model"))
        key = "x".join(map(str, shape))
        out[key] = {"param": {}, "zero1": {}, "batch": {}, "cache": {}}
        for arch in ARCH_IDS:
            model = build_model(get_config(arch), jnp.bfloat16)
            specs = jax.eval_shape(model.init, jax.random.key(0))
            out[key]["param"][arch] = flat(param_shardings(mesh, specs))
            out[key]["zero1"][arch] = flat(zero1_shardings(mesh, specs))
        for arch in ("phi3-mini-3.8b", "whisper-tiny"):
            cfg = get_config(arch)
            for name in ("train_4k", "prefill_32k", "decode_32k"):
                s = SHAPES[name]
                if s.kind == "decode":
                    dspec = decode_specs(cfg, s)
                    batch = dspec["tokens"]
                    out[key]["cache"][f"{arch}/{name}"] = flat(
                        cache_shardings(mesh, dspec["cache"], s.global_batch))
                else:
                    batch = (train_batch_specs(cfg, s) if s.kind == "train"
                             else prefill_specs(cfg, s))
                out[key]["batch"][f"{arch}/{name}"] = flat(
                    batch_shardings(mesh, batch, s.global_batch))
    with open(sys.argv[1], "w") as f:
        json.dump(out, f)
    print("JAX_SPECS_OK")
"""


def _ep_inputs(d: Path) -> None:
    rng = np.random.default_rng(0)
    dm, h = 32, 16

    def params(e):
        return {"router": rng.standard_normal((dm, e)) * dm ** -0.5,
                "w_gate": rng.standard_normal((e, dm, h)) * dm ** -0.5,
                "w_up": rng.standard_normal((e, dm, h)) * dm ** -0.5,
                "w_down": rng.standard_normal((e, h, dm)) * h ** -0.5}

    arrays = params(8)
    arrays.update({k + "6": v for k, v in params(6).items()})
    arrays["x"] = rng.standard_normal((4, 16, dm))
    arrays["cot"] = rng.standard_normal((4, 16, dm))
    np.savez(d / "ep_inputs.npz",
             **{k: v.astype(np.float32) for k, v in arrays.items()})
    # the reference test's inputs
    rng = np.random.default_rng(0)
    w = rng.standard_normal((16, 24)).astype(np.float32)
    x = rng.standard_normal((3, 16)).astype(np.float32)
    np.savez(d / "sharded_inputs.npz", w=w, x=x)
    (d / "restore_arch.txt").write_text(RESTORE_ARCH)
    # the models case: a 12-token prompt (past gemma3's smoke window of
    # 8), 3 decode tokens, and a training batch; batch 4 over 'data'
    rng = np.random.default_rng(5)
    np.savez(d / "models_inputs.npz",
             prompt=rng.integers(0, 256, (4, 12)),
             steps=rng.integers(0, 256, (4, 3)),
             tokens=rng.integers(0, 256, (4, 16)),
             labels=rng.integers(0, 256, (4, 16)))


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh")
    _ep_inputs(d)
    jax_ep = _jax_proc(JAX_EP, 8, d)
    jax_specs = _jax_proc(JAX_SPECS, 256, d / "jax_specs.json")
    specs = subprocess.Popen([sys.executable, str(RANKS), "specs", "0", "1",
                              str(d)], cwd=ROOT, env=ENV,
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                             text=True)
    models = _group("models", 4, d)
    _wait(_group("ep", 8, d), "moe_block_ep on 8 gloo ranks")
    _wait(_group("sharded", 6, d), "apply_sharded on 6 gloo ranks")
    _wait([jax_ep], "the JAX side (EP, apply_sharded, trainer checkpoint)")
    _wait(_group("restore", 4, d), "restore_resharded on 4 gloo ranks")
    _wait([jax_specs, specs], "the sharding specs")
    _wait(models, "the smoke models on 4 gloo ranks")

    def load(case, world):
        return [torch.load(d / f"{case}_{r}.pt", weights_only=False)
                for r in range(world)]

    return {"dir": d, "ep": load("ep", 8), "sharded": load("sharded", 6),
            "restore": load("restore", 4), "specs": load("specs", 1)[0],
            "models": load("models", 4),
            "jax": dict(np.load(d / "jax_ep.npz")),
            "jax_specs": json.loads((d / "jax_specs.json").read_text())}


# ---------------------------------------------------------------------------
# Sharding rules
# ---------------------------------------------------------------------------


def _norm(spec, ndim: int) -> list:
    """A spec as a list of ndim entries, each None or a list of axes."""
    spec = list(spec) + [None] * (ndim - len(spec))
    return [None if a is None else list(a) if isinstance(a, (list, tuple))
            else [a] for a in spec]


MESHES = ("2x4", "32x8")


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("kind", ("param", "zero1"))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_leaf_specs_equal_the_reference(mesh_runs, arch, kind, mesh):
    """Each port leaf gets its reference leaf's spec, the stacked group
    axis dropped, and every sharded dim divides."""
    cfg = port_config(arch)
    sd = build_model(cfg, torch.bfloat16, device="meta").state_dict()
    got = mesh_runs["specs"][mesh][kind][arch]
    want = mesh_runs["jax_specs"][mesh][kind][arch]
    sizes = dict(zip(("data", "model"), map(int, mesh.split("x"))))
    assert set(got) == set(sd)
    for name, t in sd.items():
        key, stack = reference_key(name, cfg)
        ref = want[key]
        ref = _norm(ref, t.ndim + (stack is not None))
        if stack is not None:
            ref = ref[1:]
        assert _norm(got[name], t.ndim) == ref, (name, key)
        for dim, axes in enumerate(_norm(got[name], t.ndim)):
            size = int(np.prod([sizes[a] for a in axes or []]))
            assert t.shape[dim] % size == 0, (name, t.shape, axes)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("cell", [f"{a}/{s}" for a in ("phi3-mini-3.8b",
                                                        "whisper-tiny")
                                  for s in ("train_4k", "prefill_32k",
                                            "decode_32k")])
def test_batch_and_cache_specs_equal_the_reference(mesh_runs, cell, mesh):
    got = mesh_runs["specs"][mesh]
    want = mesh_runs["jax_specs"][mesh]
    batch = got["batch"][cell]
    if isinstance(batch, dict):
        for name, spec in batch.items():
            ref = want["batch"][cell][f"['{name}']"]
            assert _norm(spec, len(spec)) == _norm(ref, len(spec)), name
    else:      # decode: the token array itself
        ref = want["batch"][cell][""]
        assert _norm(batch, 2) == _norm(ref, 2)
    if cell not in got["cache"]:
        return
    cache, ref = got["cache"][cell], want["cache"][cell]
    arch = cell.split("/")[0]
    cfg = port_config(arch)
    p = len(cfg.pattern)
    assert _norm(cache["step"], 0) == _norm(ref["['step']"], 0)
    for layer, c in enumerate(cache["layers"]):
        for leaf, spec in c.items():
            if cfg.family == "audio":
                key = f"['layers']['{leaf}']"
            else:
                key = f"['layers']['l{layer % p}']['{leaf}']"
            r = _norm(ref[key], len(ref[key]))[1:]     # stacked axis dropped
            assert _norm(spec, len(r)) == r, (layer, leaf)


# ---------------------------------------------------------------------------
# The activation-sharding hook
# ---------------------------------------------------------------------------


def test_shard_hook_is_the_identity_outside_a_mesh():
    x = torch.randn(2, 3, 4)
    for name in ("resid", "logits", "kv", "attn_q", "attn_kv", "moe_xe",
                 "moe_w"):
        assert shard(name, x) is x
    seen = []
    with activation_sharding(lambda name, t: seen.append(name) or t):
        assert shard("resid", x) is x
    assert seen == ["resid"] and shard("resid", x) is x


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_forward_bitwise_with_an_identity_sharder(arch):
    """Every smoke arch's forward (and, but for audio, a prefill and one
    decode step) is bitwise with and without an installed sharder that
    returns what it gets; the sharder sees the reference's cut points."""
    cfg = get_smoke_config(arch)
    model = build_model(cfg, torch.float32, device="cpu")
    model.init(torch.Generator().manual_seed(3))
    rng = np.random.default_rng(3)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (2, 8)))
    kw = {}
    if cfg.family == "audio":
        kw["frames"] = torch.as_tensor(rng.standard_normal(
            (2, cfg.encoder.n_frames, cfg.d_model)), dtype=torch.float32)

    def run():
        with torch.no_grad():
            logits, aux = model(toks, **kw)
            last, cache = model.prefill(toks, max_len=16, **kw)
            step, _ = model.decode_step(cache, toks[:, :1])
        return logits, aux, last, step

    plain = run()
    seen = set()
    with activation_sharding(lambda name, t: seen.add(name) or t):
        hooked = run()
    for a, b in zip(plain, hooked):
        assert torch.equal(a, b)
    assert {"resid", "logits"} <= seen
    if cfg.family != "ssm":
        assert {"attn_q", "attn_kv"} <= seen
    if cfg.moe is not None:
        assert {"moe_xe", "moe_w"} <= seen


MODEL_ARCHS = ("granite-moe-1b-a400m", "phi3-mini-3.8b", "gemma3-12b",
               "mamba2-1.3b")


@pytest.mark.parametrize("arch", MODEL_ARCHS)
def test_models_on_a_mesh_match_the_same_weights_off_it(mesh_runs, arch):
    """On every rank, the prefill's and each decode step's logits on the
    mesh are within 1e-4 of the same f32 model off it (vocab-parallel
    embedding, tensor-parallel attention and FFN or MoE, mamba's scan on
    each rank's rows, the cache laid out by its cut point), and so is
    every gradient of one ``train_loss`` backward, the embedding's
    included."""
    for rank in mesh_runs["models"]:
        r = rank[arch]
        assert r["embed"] == "(Replicate(), Shard(dim=0))"
        assert len(r["got"]) == len(r["want"]) == 4
        for got, want in zip(r["got"], r["want"]):
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                                       atol=1e-4)
        assert "embed" in r["want_grads"]
        assert set(r["got_grads"]) == set(r["want_grads"])
        for name, want in r["want_grads"].items():
            np.testing.assert_allclose(r["got_grads"][name].numpy(),
                                       want.numpy(), rtol=1e-4, atol=1e-4,
                                       err_msg=name)


# ---------------------------------------------------------------------------
# Expert-parallel MoE
# ---------------------------------------------------------------------------


def test_ep_matches_moe_block_and_the_reference(mesh_runs):
    r = mesh_runs["ep"][0]
    j = mesh_runs["jax"]
    y = r["ep"]["y"].numpy()
    np.testing.assert_allclose(y, r["ref"]["y"].numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(y, j["y_ep"], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(y, j["y_ref"], rtol=1e-4, atol=1e-4)
    # aux: the mean over the data shards of each shard's Switch aux, as
    # the reference's pmean
    np.testing.assert_allclose(float(r["ep"]["aux"]), float(j["aux_ep"]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(r["ep"]["aux"]), float(r["ref"]["aux"]),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("leaf", ("router", "w_gate", "w_up", "w_down", "x"))
def test_ep_gradients_match_moe_block(mesh_runs, leaf):
    """The gradient of sum(y * cot) + aux / 2 through the EP path, on
    every rank, within 1e-4 of ``moe_block``'s (with the shard-mean
    aux): the reference's own EP gradient test fails, so the
    single-device block is the yardstick."""
    want = mesh_runs["ep"][0]["ref"]["grads"][leaf].numpy()
    for r in mesh_runs["ep"]:
        np.testing.assert_allclose(r["ep"]["grads"][leaf].numpy(), want,
                                   rtol=1e-4, atol=1e-4)


def test_ep_with_dtensor_inputs_keeps_the_batch_sharded(mesh_runs):
    r = mesh_runs["ep"][0]
    assert r["dtensor"]["y_placements"] == ["S(0)", "R"]
    assert tuple(r["dtensor"]["y_local"].shape) == (2, 16, 32)
    np.testing.assert_allclose(r["dtensor"]["y"].numpy(),
                               r["ref"]["y"].numpy(), rtol=1e-4, atol=1e-4)
    assert torch.equal(r["dtensor"]["aux"], r["ep"]["aux"])


def test_ep_takes_moe_block_when_experts_do_not_divide(mesh_runs):
    for r in mesh_runs["ep"]:
        (y, aux), (y_ref, aux_ref) = r["nodiv"]["ep"], r["nodiv"]["ref"]
        assert torch.equal(y, y_ref) and torch.equal(aux, aux_ref)


def _route_with_bincount(router, tokens, moe, cap):
    """``_route_tokens`` as it was before the meta-safe count, with
    ``torch.bincount``."""
    t = tokens.shape[0]
    e, k = moe.n_experts, moe.top_k
    logits = torch.einsum("td,de->te", tokens.float(), router.float())
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.topk(probs, k, dim=-1)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    frac_tokens = torch.nn.functional.one_hot(top_e[:, 0], e).float() \
        .mean(dim=0)
    aux = e * torch.sum(frac_tokens * probs.mean(dim=0))
    fe = top_e.reshape(-1)
    fp = top_p.reshape(-1)
    tok_id = torch.arange(t).repeat_interleave(k)
    order = torch.argsort(fe, stable=True)
    counts = torch.bincount(fe, minlength=e)
    starts = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)[:-1]])
    ranks = torch.arange(t * k) - starts[fe[order]]
    pos = torch.zeros(t * k, dtype=torch.long)
    pos[order] = ranks
    keep = pos < cap
    dest = torch.where(keep, fe * cap + pos, e * cap)
    return aux, fp, tok_id, keep, dest


@pytest.mark.parametrize("capacity", (1.25, 8.0))
def test_moe_block_bitwise_with_the_bincount_count(monkeypatch, capacity):
    """The meta-safe count (a scatter-add) gives bincount's integers:
    the routing and ``moe_block`` are bitwise what they were."""
    rng = np.random.default_rng(7)
    moe = port_moe.MoEConfig(n_experts=8, top_k=2, d_expert=16,
                             capacity_factor=capacity)
    shapes = {"router": (32, 8), "w_gate": (8, 32, 16),
              "w_up": (8, 32, 16), "w_down": (8, 16, 32)}
    p = {n: torch.tensor(rng.standard_normal(s), dtype=torch.float32)
         for n, s in shapes.items()}
    x = torch.tensor(rng.standard_normal((4, 16, 32)), dtype=torch.float32)
    cap = port_moe._capacity(64, moe)
    for a, b in zip(port_moe._route_tokens(p["router"], x.reshape(64, 32),
                                           moe, cap),
                    _route_with_bincount(p["router"], x.reshape(64, 32),
                                         moe, cap)):
        assert torch.equal(a, b)
    y, aux = port_moe.moe_block(p, x, moe)
    monkeypatch.setattr(port_moe, "_route_tokens", _route_with_bincount)
    y_old, aux_old = port_moe.moe_block(p, x, moe)
    assert torch.equal(y, y_old) and torch.equal(aux, aux_old)


def test_route_tokens_runs_on_meta():
    moe = port_moe.MoEConfig(n_experts=384, top_k=8, d_expert=2048)
    router = torch.empty((7168, 384), device="meta")
    tokens = torch.empty((64, 7168), dtype=torch.bfloat16, device="meta")
    cap = port_moe._capacity(64, moe)
    aux, fp, tok_id, keep, dest = port_moe._route_tokens(router, tokens,
                                                         moe, cap)
    assert aux.shape == () and dest.shape == (64 * 8,)
    assert fp.device.type == keep.device.type == "meta"


# ---------------------------------------------------------------------------
# CodedLinear.apply_sharded
# ---------------------------------------------------------------------------


def test_apply_sharded_on_six_ranks(mesh_runs):
    s = np.load(mesh_runs["dir"] / "sharded_inputs.npz")
    want = s["x"] @ s["w"]
    for r in mesh_runs["sharded"]:
        y = r["y"].numpy()
        np.testing.assert_allclose(y, want, rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(y, mesh_runs["jax"]["y_sharded"],
                                   rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(r["y_all"].numpy(), want, rtol=2e-4,
                                   atol=2e-4)


@pytest.mark.parametrize("n", (5, 8))
def test_apply_sharded_raises_when_the_axis_is_not_n(mesh_runs, n):
    for r in mesh_runs["sharded"]:
        assert r[f"raised_n{n}"] == (f"mesh axis model has 6 devices, "
                                     f"scheme expects n={n}")


# ---------------------------------------------------------------------------
# restore_resharded
# ---------------------------------------------------------------------------


def _slice(arr: np.ndarray, spec, coordinate) -> np.ndarray:
    """This rank's block of ``arr`` under ``spec`` on a (data, model)
    mesh of sizes (2, 2): each sharded dim cut evenly, in mesh order."""
    sizes = {"data": 2, "model": 2}
    coord = dict(zip(("data", "model"), coordinate))
    out = arr
    for dim, axes in enumerate(_norm(spec, arr.ndim)):
        if not axes:
            continue
        parts, index = 1, 0
        for a in axes:
            index = index * sizes[a] + coord[a]
            parts *= sizes[a]
        n = arr.shape[dim] // parts
        out = np.take(out, range(index * n, (index + 1) * n), axis=dim)
    return out


@pytest.mark.parametrize("part", ("params", "m", "v"))
def test_restore_resharded_is_bitwise_per_rank(mesh_runs, part):
    cfg = get_smoke_config(RESTORE_ARCH)
    step = checkpoint.latest_step(mesh_runs["dir"] / "ckpt")
    tree = checkpoint._nest(checkpoint.load(mesh_runs["dir"] / "ckpt", step))
    src = tree["params"] if part == "params" else tree["opt"][part]
    want = model_params_from_reference(src, cfg, device="cpu")
    sharded = 0
    for r in mesh_runs["restore"]:
        assert r["step"] == step
        for name, got in r[part].items():
            full = want[name].numpy()
            assert torch.equal(got["full"], want[name]), name
            block = _slice(full, got["spec"], r["coordinate"])
            assert np.array_equal(got["local"].numpy(), block), name
            sharded += any(got["spec"])
    assert sharded > 0
