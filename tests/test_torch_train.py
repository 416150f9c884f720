"""The port's training substrate against the JAX package's
(``tests/test_substrate.py``): the data pipeline bitwise (seek, host
split, prefetch, error propagation); the lr schedule, ``apply_updates``
and bf16 moments on identical inputs; int8 and top-k compression
bitwise; checkpoints that cross-load both ways, bitwise, bf16 included;
keep-last and the shape check; the trainer on the phi3-mini smoke
config from converted JAX weights (loss history against the JAX
trainer's, resume, int8 compression, microbatches); the coded-plan
retune on a detached snapshot of the live weight; the launcher's lines.

f32 optimizer arithmetic is held to the reference's 2e-5
(``tests/test_kernels.py:27-28``), the trainers' loss histories to 1e-4
relative.  Parameters are not compared across the packages after
training: at step 1 AdamW's update is ~g/(|g|+eps), so grads that
differ in the last bit near eps move a weight by +lr or -lr.
"""

import contextlib
import io
import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
import repro.data as ref_data
import repro.launch.train as ref_launch
import repro.models as ref_models
import repro.optim as ref_optim
import repro.optim.adamw as ref_adamw
import repro.optim.compress as ref_compress
import repro.train as ref_train
import repro_torch.configs as port_configs
import repro_torch.launch.train as port_launch
from repro_torch.api import compile_plan
from repro_torch.convert import model_params_from_reference
from repro_torch.data import (
    DataConfig,
    PrefetchIterator,
    SyntheticTokens,
    make_pipeline,
)
from repro_torch.models import build_model
from repro_torch.optim import (
    AdamWConfig,
    CompressionConfig,
    apply_updates,
    compress_tree,
    init_residual,
    init_state,
    schedule,
)
from repro_torch.optim.adamw import global_norm
from repro_torch.optim.compress import (
    dequantize_int8,
    quantize_int8,
    topk_mask,
)
from repro_torch.train import TrainConfig, Trainer, checkpoint

CPU = torch.device("cpu")
TOL = dict(rtol=2e-5, atol=2e-5)
HIST_RTOL = 1e-4
ARCH = "phi3-mini-3.8b"


def np32(t):
    return t.detach().float().numpy()


# ---------------------------------------------------------------------------
# Data
# ---------------------------------------------------------------------------


def both_sources(**kw):
    base = dict(vocab=128, seq_len=32, global_batch=4, seed=5)
    base.update(kw)
    return (SyntheticTokens(DataConfig(**base)),
            ref_data.SyntheticTokens(ref_data.DataConfig(**base)))


@pytest.mark.parametrize("step", [0, 1, 7, 1000])
def test_batches_bitwise_at_any_step(step):
    port, ref = both_sources()
    got, want = port.batch_at(step), ref.batch_at(step)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype == np.int32
        np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_array_equal(got["tokens"][:, 1:],
                                  got["labels"][:, :-1])


@pytest.mark.parametrize("hosts", [2, 4])
def test_host_split_bitwise(hosts):
    parts = []
    for h in range(hosts):
        port, ref = both_sources(host_count=hosts, host_index=h, seq_len=16)
        got = port.batch_at(3)["tokens"]
        np.testing.assert_array_equal(got, ref.batch_at(3)["tokens"])
        parts.append(got)
    np.testing.assert_array_equal(np.concatenate(parts),
                                  both_sources(seq_len=16)[0]
                                  .batch_at(3)["tokens"])
    with pytest.raises(ValueError):
        SyntheticTokens(DataConfig(vocab=64, seq_len=8, global_batch=3,
                                   host_count=2))


def test_prefetch_replays_the_reference_stream_from_any_start():
    cfg = dict(vocab=64, seq_len=8, global_batch=2, seed=1)
    for start in (0, 5):
        it = make_pipeline(DataConfig(**cfg), start)
        ref = ref_data.make_pipeline(ref_data.DataConfig(**cfg), start)
        for _ in range(4):
            got, want = next(it), next(ref)
            for k in want:
                np.testing.assert_array_equal(got[k], want[k])
        assert it.step == ref.step == start + 4
        it.close()
        ref.close()


def test_prefetch_propagates_source_errors():
    class Failing(SyntheticTokens):
        def batch_at(self, step):
            if step == 2:
                raise RuntimeError("disk gone")
            return super().batch_at(step)

    it = PrefetchIterator(Failing(DataConfig(vocab=64, seq_len=8,
                                             global_batch=2)))
    next(it)
    next(it)
    with pytest.raises(RuntimeError, match="disk gone"):
        next(it)
    it.close()


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def test_schedule_matches_reference():
    for cfg in (AdamWConfig(warmup_steps=10, total_steps=100),
                AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=7,
                            min_lr_ratio=0.0),
                AdamWConfig(warmup_steps=2, total_steps=2)):
        rcfg = ref_optim.AdamWConfig(**vars(cfg))
        for step in (0, 1, 2, 5, 10, 11, 50, 99, 100, 150):
            got = schedule(cfg, torch.tensor(step, dtype=torch.int32))
            want = ref_optim.schedule(rcfg, jnp.asarray(step, jnp.int32))
            assert got.dtype == torch.float32
            np.testing.assert_allclose(float(got), float(want), **TOL)


def random_tree(rng, shapes, dtype=np.float32, scale=1.0):
    return {k: (rng.standard_normal(s) * scale).astype(dtype)
            for k, s in shapes.items()}


SHAPES = {"a": (7, 5), "b.c": (11,), "b.d": (3, 4, 2)}


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
@pytest.mark.parametrize("grad_scale", [1.0, 1e3])
def test_apply_updates_matches_reference(moments, grad_scale):
    """Three steps on identical params and grads: params, moments, the
    pre-clip norm and the lr (grad_scale 1e3 clips)."""
    rng = np.random.default_rng(0)
    kw = dict(lr=1e-2, warmup_steps=1, total_steps=5, weight_decay=0.1,
              moment_dtype=moments)
    cfg, rcfg = AdamWConfig(**kw), ref_optim.AdamWConfig(**kw)
    p0 = random_tree(rng, SHAPES)
    params = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    rparams = {k: jnp.asarray(v) for k, v in p0.items()}
    state, rstate = init_state(cfg, params), ref_optim.init_state(rcfg,
                                                                 rparams)
    want_dt = torch.bfloat16 if moments == "bfloat16" else torch.float32
    assert state["m"]["a"].dtype == want_dt
    assert state["step"].dtype == torch.int32
    for _ in range(3):
        g = random_tree(rng, SHAPES, scale=grad_scale)
        params, state, m = apply_updates(
            cfg, params, {k: torch.from_numpy(v) for k, v in g.items()},
            state)
        rparams, rstate, rm = ref_optim.apply_updates(
            rcfg, rparams, {k: jnp.asarray(v) for k, v in g.items()},
            rstate)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(rm["grad_norm"]), **TOL)
        np.testing.assert_allclose(float(m["lr"]), float(rm["lr"]), **TOL)
        assert int(state["step"]) == int(rstate["step"])
        for k in SHAPES:
            np.testing.assert_allclose(params[k].numpy(),
                                       np.asarray(rparams[k]), **TOL)
            for mom in ("m", "v"):
                got = state[mom][k]
                assert got.dtype == want_dt
                np.testing.assert_allclose(
                    np32(got), np.asarray(rstate[mom][k], np.float32),
                    **(TOL if moments == "float32"
                       else dict(rtol=2e-2, atol=2e-2)))


def test_apply_updates_bf16_params_and_clip_report():
    """bf16 params update in f32 and round once; the reported norm is
    the one before the clip (tests/test_substrate.py::test_clip)."""
    cfg = AdamWConfig(lr=1e-3, clip_norm=1.0, warmup_steps=0)
    rcfg = ref_optim.AdamWConfig(lr=1e-3, clip_norm=1.0, warmup_steps=0)
    w = np.linspace(-1, 1, 8).astype(np.float32)
    params = {"w": torch.from_numpy(w).to(torch.bfloat16)}
    rparams = {"w": jnp.asarray(w, jnp.bfloat16)}
    g = np.full(8, 1e6, np.float32)
    params, _, m = apply_updates(
        cfg, params, {"w": torch.from_numpy(g).to(torch.bfloat16)},
        init_state(cfg, params))
    rparams, _, rm = ref_optim.apply_updates(
        rcfg, rparams, {"w": jnp.asarray(g, jnp.bfloat16)},
        ref_optim.init_state(rcfg, rparams))
    assert float(m["grad_norm"]) > 1e5
    np.testing.assert_allclose(float(m["grad_norm"]),
                               float(rm["grad_norm"]), **TOL)
    assert params["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(np32(params["w"]),
                                  np.asarray(rparams["w"], np.float32))


def test_adamw_descends_quadratic():
    cfg = AdamWConfig(lr=0.1, warmup_steps=0, total_steps=100,
                      weight_decay=0.0)
    params = {"w": torch.ones(4) * 5.0}
    state = init_state(cfg, params)
    for _ in range(60):
        params, state, _ = apply_updates(cfg, params,
                                         {"w": 2 * params["w"]}, state)
    assert float(params["w"].abs().max()) < 1.0


def test_global_norm_matches_reference():
    rng = np.random.default_rng(4)
    tree = random_tree(rng, SHAPES)
    np.testing.assert_allclose(
        float(global_norm({k: torch.from_numpy(v) for k, v in tree.items()})),
        float(ref_adamw.global_norm(tree)), **TOL)


# ---------------------------------------------------------------------------
# Compression
# ---------------------------------------------------------------------------


def test_int8_round_trip_bitwise():
    rng = np.random.default_rng(2)
    g = rng.standard_normal((64, 33)).astype(np.float32)
    g[0, 0] = 0.5 * np.abs(g).max()         # exercise ties near .5 steps
    q, s = quantize_int8(torch.from_numpy(g))
    rq, rs = ref_compress.quantize_int8(jnp.asarray(g))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    assert s.item() == float(rs)
    np.testing.assert_array_equal(dequantize_int8(q, s).numpy(),
                                  np.asarray(ref_compress.dequantize_int8(
                                      rq, rs)))
    # half to even, as jnp.round
    half = torch.tensor([0.5, 1.5, 2.5, -0.5, -2.5])
    np.testing.assert_array_equal(torch.round(half).numpy(),
                                  np.asarray(jnp.round(half.numpy())))


@pytest.mark.parametrize("ratio", [0.01, 0.1, 0.5])
def test_topk_mask_equal(ratio):
    rng = np.random.default_rng(3)
    g = rng.standard_normal((40, 25)).astype(np.float32)
    g[1, :4] = g[0, 0]                      # ties at the threshold kept
    np.testing.assert_array_equal(
        topk_mask(torch.from_numpy(g), ratio).numpy(),
        np.asarray(ref_compress.topk_mask(jnp.asarray(g), ratio)))


@pytest.mark.parametrize("mode", ["int8", "topk"])
@pytest.mark.parametrize("feedback", [True, False])
def test_compress_tree_with_error_feedback_bitwise(mode, feedback):
    cfg = CompressionConfig(mode=mode, topk_ratio=0.1,
                            error_feedback=feedback)
    rcfg = ref_optim.CompressionConfig(mode=mode, topk_ratio=0.1,
                                       error_feedback=feedback)
    rng = np.random.default_rng(6)
    p = random_tree(rng, SHAPES)
    res = init_residual(cfg, {k: torch.from_numpy(v) for k, v in p.items()})
    rres = ref_optim.init_residual(rcfg, {k: jnp.asarray(v)
                                          for k, v in p.items()})
    assert (res is None) == (rres is None) == (not feedback)
    for _ in range(3):
        g = random_tree(rng, SHAPES)
        out, res = compress_tree(cfg, {k: torch.from_numpy(v)
                                       for k, v in g.items()}, res)
        rout, rres = ref_optim.compress_tree(
            rcfg, {k: jnp.asarray(v) for k, v in g.items()}, rres)
        for k in SHAPES:
            np.testing.assert_array_equal(out[k].numpy(),
                                          np.asarray(rout[k]))
            np.testing.assert_array_equal(res[k].numpy(),
                                          np.asarray(rres[k]))
        if not feedback:
            res = rres = None


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------


def jax_state(arch, dtype, moments="float32", seed=0, steps=1):
    """A JAX model's params and AdamW state after ``steps`` updates."""
    cfg = ref_configs.get_smoke_config(arch)
    model = ref_models.build_model(cfg, dtype=dtype)
    params = model.init(jax.random.key(seed))
    ocfg = ref_optim.AdamWConfig(moment_dtype=moments)
    opt = ref_optim.init_state(ocfg, params)
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        grads = jax.tree.map(lambda p: jnp.asarray(
            rng.standard_normal(p.shape), p.dtype), params)
        params, opt, _ = ref_optim.apply_updates(ocfg, params, grads, opt)
    return cfg, params, opt


def port_template(arch, dtype, moments):
    pcfg = port_configs.get_smoke_config(arch)
    model = build_model(pcfg, dtype, device=CPU)
    model.init(torch.Generator().manual_seed(9))
    params = {k: v.detach() for k, v in model.named_parameters()}
    return pcfg, params, init_state(AdamWConfig(moment_dtype=moments),
                                    params)


def equal_trees(port_params, port_opt, ref_params, ref_opt, pcfg):
    want_p = model_params_from_reference(jax.tree.map(np.asarray,
                                                      ref_params),
                                         pcfg, device=CPU)
    for name, t in port_params.items():
        assert t.dtype == want_p[name].dtype, name
        assert torch.equal(t, want_p[name]), name
    assert int(port_opt["step"]) == int(ref_opt["step"])
    for mom in ("m", "v"):
        want = model_params_from_reference(
            jax.tree.map(np.asarray, ref_opt[mom]), pcfg, device=CPU)
        for name, t in port_opt[mom].items():
            assert t.dtype == want[name].dtype
            assert torch.equal(t, want[name]), (mom, name)


CROSS = [(ARCH, "float32", "float32"), (ARCH, "bfloat16", "bfloat16"),
         ("zamba2-2.7b", "bfloat16", "float32"),
         ("whisper-tiny", "float32", "float32"),
         ("granite-moe-1b-a400m", "bfloat16", "bfloat16")]


@pytest.mark.parametrize("arch,dtype,moments", CROSS)
def test_jax_checkpoint_restores_bitwise_into_the_port(tmp_path, arch, dtype,
                                                        moments):
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    cfg, params, opt = jax_state(arch, jdt, moments, steps=2)
    ref_train.checkpoint.save(tmp_path, 2, {"params": params, "opt": opt})
    assert checkpoint.latest_step(tmp_path) == 2
    pcfg, tparams, topt = port_template(arch, getattr(torch, dtype), moments)
    got_p, got_o = checkpoint.restore_train_state(tmp_path, 2, pcfg,
                                                  tparams, topt)
    equal_trees(got_p, got_o, params, opt, pcfg)


@pytest.mark.parametrize("arch,dtype,moments", CROSS)
def test_port_checkpoint_restores_bitwise_into_jax(tmp_path, arch, dtype,
                                                    moments):
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    pcfg, params, opt = port_template(arch, getattr(torch, dtype), moments)
    # move the moments and the step off their zeros
    rng = np.random.default_rng(1)
    for mom in ("m", "v"):
        for t in opt[mom].values():
            t.copy_(torch.from_numpy(
                np.abs(rng.standard_normal(t.shape))).to(t.dtype))
    opt["step"] = torch.tensor(5, dtype=torch.int32)
    checkpoint.save_train_state(tmp_path, 5, params, opt, pcfg)
    _, tparams, topt = jax_state(arch, jdt, moments, seed=3, steps=0)
    got = ref_train.checkpoint.restore(tmp_path, 5,
                                       {"params": tparams, "opt": topt})
    assert got["opt"]["step"].dtype == np.int32
    equal_trees(params, opt, got["params"], got["opt"], pcfg)
    # and back into the port
    rp, ro = checkpoint.restore_train_state(tmp_path, 5, pcfg, params, opt)
    equal_trees(rp, ro, got["params"], got["opt"], pcfg)


def test_atomic_roundtrip_generic_tree(tmp_path):
    state = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
             "b": {"c": torch.ones(4, dtype=torch.bfloat16)}}
    checkpoint.save(tmp_path, 7, state)
    assert checkpoint.latest_step(tmp_path) == 7
    assert not list(tmp_path.glob("*.tmp"))
    out = checkpoint.restore(tmp_path, 7, state)
    assert torch.equal(out["a"], state["a"])
    assert out["b"]["c"].dtype == torch.bfloat16
    # the archive's keys are the JAX package's
    ref = ref_train.checkpoint.restore(
        tmp_path, 7, {"a": jnp.zeros((2, 3)),
                      "b": {"c": jnp.zeros((4,), jnp.bfloat16)}})
    np.testing.assert_array_equal(np.asarray(ref["a"]), state["a"].numpy())


def test_keep_last(tmp_path):
    state = {"x": torch.zeros(1)}
    for s in range(5):
        checkpoint.save(tmp_path, s, state, keep_last=2)
    steps = sorted(int(p.name[5:13]) for p in tmp_path.glob("ckpt_*.npz"))
    assert steps == [3, 4]
    assert checkpoint.latest_step(tmp_path / "none") is None


def test_shape_mismatch_raises(tmp_path):
    checkpoint.save(tmp_path, 0, {"x": torch.zeros(2)})
    with pytest.raises(ValueError):
        checkpoint.restore(tmp_path, 0, {"x": torch.zeros(3)})
    with pytest.raises(KeyError):
        checkpoint.restore(tmp_path, 0, {"y": torch.zeros(2)})
    # a model of another width
    pcfg, params, opt = port_template(ARCH, torch.float32, "float32")
    checkpoint.save_train_state(tmp_path / "m", 1, params, opt, pcfg)
    wide = pcfg.with_(d_model=2 * pcfg.d_model)
    model = build_model(wide, torch.float32, device=CPU)
    wp = {k: v.detach() for k, v in model.named_parameters()}
    with pytest.raises(ValueError, match="shape mismatch"):
        checkpoint.restore_train_state(tmp_path / "m", 1, wide, wp,
                                       init_state(AdamWConfig(), wp))


# ---------------------------------------------------------------------------
# The trainer against the JAX trainer
# ---------------------------------------------------------------------------


def setups(tmp_path, steps=6, schedule_total=None, ckpt=True, **tkw):
    """(jax trainer, port trainer, port model, data factories) on the
    same converted weights; the port model's ``init`` loads them."""
    cfg = ref_configs.get_smoke_config(ARCH)
    pcfg = port_configs.get_smoke_config(ARCH)
    jmodel = ref_models.build_model(cfg, dtype=jnp.float32)
    weights = model_params_from_reference(
        jax.tree.map(np.asarray, jmodel.init(jax.random.key(0))), pcfg,
        device=CPU)
    pmodel = build_model(pcfg, torch.float32, device=CPU)
    pmodel.init = lambda gen: pmodel.load_state_dict(weights)
    okw = dict(lr=1e-3, warmup_steps=2, total_steps=schedule_total or steps)
    rdir = str(tmp_path / "jax") if ckpt else None
    pdir = str(tmp_path / "port") if ckpt else None
    rcomp = tkw.pop("compression", None)
    jtr = ref_train.Trainer(jmodel, ref_optim.AdamWConfig(**okw),
                            ref_train.TrainConfig(
                                steps=steps, ckpt_every=3, log_every=100,
                                ckpt_dir=rdir,
                                compression=ref_optim.CompressionConfig(
                                    mode=rcomp or "none"), **tkw))
    ptr = Trainer(pmodel, AdamWConfig(**okw),
                  TrainConfig(steps=steps, ckpt_every=3, log_every=100,
                              ckpt_dir=pdir,
                              compression=CompressionConfig(
                                  mode=rcomp or "none"), **tkw))
    dkw = dict(vocab=cfg.vocab, seq_len=16, global_batch=4)
    return (jtr, ptr, pmodel,
            lambda s: ref_data.make_pipeline(ref_data.DataConfig(**dkw), s),
            lambda s: make_pipeline(DataConfig(**dkw), s))


def losses(hist):
    return np.array([h["loss"] for h in hist])


@pytest.mark.parametrize("variant", [{}, {"compression": "int8"},
                                     {"microbatches": 2}],
                         ids=["plain", "int8", "microbatches2"])
def test_trainer_follows_the_jax_trainers_loss_history(tmp_path, variant):
    jtr, ptr, _, jdata, pdata = setups(tmp_path, ckpt=False, **variant)
    _, _, jhist = jtr.fit(jdata, resume=False)
    _, _, phist = ptr.fit(pdata, resume=False)
    assert [h["step"] for h in phist] == [h["step"] for h in jhist]
    assert list(phist[0]) == list(jhist[0])     # the same keys, in order
    np.testing.assert_allclose(losses(phist), losses(jhist), rtol=HIST_RTOL)
    np.testing.assert_allclose([h["lr"] for h in phist],
                               [h["lr"] for h in jhist], **TOL)
    # the first step's grads are the same function of the same weights
    np.testing.assert_allclose(phist[0]["grad_norm"], jhist[0]["grad_norm"],
                               rtol=HIST_RTOL)
    assert len(ptr.step_times) == 6 and all(h["dt"] > 0 for h in phist)


def test_loss_decreases(tmp_path):
    _, ptr, _, _, pdata = setups(tmp_path, steps=20, ckpt=False)
    _, _, hist = ptr.fit(pdata, resume=False)
    assert np.mean(losses(hist)[-4:]) < np.mean(losses(hist)[:4])


def test_checkpoint_restart_exact(tmp_path):
    _, tr, _, _, data = setups(tmp_path, steps=6)
    p1, _, _ = tr.fit(data)
    p1 = {k: v.detach().clone() for k, v in p1.items()}
    _, tr2, _, _, data2 = setups(tmp_path, steps=6)
    p2, _, hist2 = tr2.fit(data2)
    assert hist2 == []                      # nothing left to do
    for k in p1:
        assert torch.equal(p1[k], p2[k])


def test_mid_run_resume_matches_uninterrupted(tmp_path):
    _, tra, _, _, data_a = setups(tmp_path / "a", steps=6)
    pa, _, _ = tra.fit(data_a)
    _, trb1, _, _, data_b = setups(tmp_path / "b", steps=3,
                                   schedule_total=6)
    trb1.fit(data_b)
    _, trb2, _, _, data_b2 = setups(tmp_path / "b", steps=6)
    pb, _, hist = trb2.fit(data_b2)
    assert hist[0]["step"] == 3
    for k in pa:
        np.testing.assert_allclose(pa[k].detach().numpy(),
                                   pb[k].detach().numpy(),
                                   rtol=1e-5, atol=1e-6)


def test_port_run_resumes_from_the_jax_trainers_checkpoint(tmp_path):
    """The JAX trainer runs 3 steps and checkpoints; the port resumes at
    step 3 from that archive and follows the JAX run's last 3 losses."""
    jtr, _, _, jdata, _ = setups(tmp_path, steps=6)
    _, _, jfull = jtr.fit(jdata, resume=False)
    jtr3, _, _, jdata3, _ = setups(tmp_path / "x", steps=3,
                                   schedule_total=6)
    jtr3.fit(jdata3)
    _, ptr, _, _, pdata = setups(tmp_path / "x", steps=6)
    ptr.cfg = TrainConfig(steps=6, ckpt_every=3, log_every=100,
                          ckpt_dir=str(tmp_path / "x" / "jax"))
    _, _, phist = ptr.fit(pdata)
    assert [h["step"] for h in phist] == [3, 4, 5]
    np.testing.assert_allclose(losses(phist), losses(jfull)[3:],
                               rtol=HIST_RTOL)


def test_compression_still_learns(tmp_path):
    _, ptr, _, _, pdata = setups(tmp_path, steps=16, ckpt=False,
                                 compression="int8")
    _, _, hist = ptr.fit(pdata, resume=False)
    assert np.mean(losses(hist)[-3:]) < np.mean(losses(hist)[:3])


def test_straggler_steps_are_flagged(tmp_path, monkeypatch):
    """A step over twice the median of the last 20 is flagged (after the
    first 5); the step clock is faked, so nothing is paced by load."""
    import repro_torch.train.trainer as trainer_module

    _, ptr, _, _, pdata = setups(tmp_path, steps=8, ckpt=False)
    clock = [0.0]
    monkeypatch.setattr(trainer_module.time, "perf_counter",
                        lambda: clock[0])
    real = ptr._step

    def timed(*args):
        out = real(*args)
        clock[0] += 10.0 if len(ptr.step_times) == 6 else 1.0
        return out

    ptr._step = timed
    ptr.fit(pdata, resume=False)
    assert ptr.step_times == [1.0] * 6 + [10.0, 1.0]
    assert ptr.stragglers == [6]


# ---------------------------------------------------------------------------
# Coded-plan retune on the live weights
# ---------------------------------------------------------------------------


def test_retune_encodes_a_snapshot_of_the_live_head(tmp_path, monkeypatch):
    """The parameters move in place, so the provider's tensor is the same
    object every step.  The trainer hands ``retune`` a detached copy:
    the plan re-encodes at each retune, holds that step's weights while
    training moves on, and a cluster serving it gets its shards
    re-shipped (bitwise the in-process plan)."""
    monkeypatch.setenv("REPRO_CODED_BACKEND", "packed")
    _, ptr, pmodel, _, pdata = setups(tmp_path, steps=4, ckpt=False)
    ptr.cfg = TrainConfig(steps=4, retune_every=2, log_every=100)
    plan = compile_plan(pmodel.head.detach().clone(), n=6, s=2, device="cpu")
    assert plan.backend == "packed"
    snapshots = []

    def provider(params):
        snapshots.append(params["head"].detach().clone())
        return params["head"]

    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((3, pmodel.cfg.d_model))
                         .astype(np.float32))
    done = np.ones(6, bool)
    done[[1, 4]] = False
    with plan.to_cluster(transport="memory") as cl:
        ptr.coded_plans = [(plan, provider, cl)]
        executors = []
        real = plan.retune

        def spy(A=None, **kw):
            out = real(A, **kw)
            executors.append(plan.executor)
            # the plan holds a snapshot, not the live parameter
            assert plan._A is not pmodel.head
            assert plan._A.data_ptr() != pmodel.head.data_ptr()
            return out

        plan.retune = spy
        params, _, _ = ptr.fit(pdata, resume=False)
        assert [r["step"] for r in ptr.retunes] == [1, 3]
        assert all(not r["changed"] and r["reshipped_bytes"] > 0
                   for r in ptr.retunes)
        assert len(set(map(id, executors))) == 2     # re-encoded each time
        # the last retune's operand is step 4's head, and it stays so
        assert torch.equal(plan._A, snapshots[-1])
        assert torch.equal(plan._A, params["head"].detach())
        got = plan.matvec(x, done)
        np.testing.assert_allclose(got.numpy(), (x @ snapshots[-1]).numpy(),
                                   rtol=2e-4, atol=2e-4)
        assert torch.equal(cl.matvec(x, done), got)
        # training on moves the live head, not the plan
        with torch.no_grad():
            pmodel.head.add_(1.0)
        assert torch.equal(plan.matvec(x, done), got)


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------


def run_main(main, argv, monkeypatch):
    monkeypatch.setattr("sys.argv", ["train"] + argv)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main()
    return buf.getvalue().splitlines()


def test_launcher_prints_the_reference_lines(monkeypatch):
    argv = ["--arch", ARCH, "--smoke", "--steps", "5", "--batch", "2",
            "--seq", "16", "--log-every", "2"]
    ref = run_main(ref_launch.main, argv, monkeypatch)
    got = run_main(lambda: port_launch.main(argv + ["--device", "cpu"]),
                   argv, monkeypatch)
    assert got[0] == ref[0]                 # arch, params, devices, backend
    step = re.compile(r"step +(\d+)  loss (\S+)  lr (\S+)  gnorm (\S+)  "
                      r"(\d+) ms$")
    rows = [step.match(line) for line in got[1:-1]]
    want = [step.match(line) for line in ref[1:-1]]
    assert all(rows) and all(want)
    assert [r.group(1) for r in rows] == [w.group(1) for w in want] \
        == ["0", "2", "4"]
    assert [r.group(3) for r in rows] == [w.group(3) for w in want]
    final = json.loads(got[-1])
    assert set(final) == set(json.loads(ref[-1])) == {"final_loss", "steps"}
    assert final["steps"] == 5 and np.isfinite(final["final_loss"])


def test_launcher_refuses_audio_and_defaults_to_the_card():
    with pytest.raises(SystemExit, match="enc-dec"):
        port_launch.build(port_launch.parse_args(
            ["--arch", "whisper-tiny", "--smoke", "--device", "cpu"]))
    args = port_launch.parse_args(["--arch", ARCH])
    assert args.device == "cuda" and args.coded_backend is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port_launch.build(port_launch.parse_args(["--arch", ARCH,
                                                      "--smoke"]))
