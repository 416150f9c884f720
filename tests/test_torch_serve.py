"""The port's serving path against the JAX package's: fault injection,
the ``ServeEngine`` (tokens, per-step logits, straggler masks, the coded
LM head) and the ``launch.serve`` CLI, on the same weights (converted
from JAX) and the same seeds."""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.cluster.faults as ref_faults
import repro.configs as ref_configs
import repro.launch.serve as ref_launch
import repro.models as ref_models
import repro.serve as ref_serve
import repro_torch.cluster as port_faults
import repro_torch.configs as port_configs
import repro_torch.launch.serve as port_launch
from repro.core.straggler import AdversarialSlow as RefSlow
from repro_torch.convert import model_params_from_reference
from repro_torch.core.straggler import AdversarialSlow
from repro_torch.models import build_model
from repro_torch.serve import Request, ServeEngine

TOL = dict(rtol=2e-5, atol=2e-5)
CPU = torch.device("cpu")


# ---------------------------------------------------------------------------
# Fault injection (repro.cluster.faults)
# ---------------------------------------------------------------------------


def injectors(f, straggler):
    """The same injectors built from module ``f`` (``straggler``: its
    AdversarialSlow)."""
    return [f.NoFaults(),
            f.StragglerFaults(time_scale=2e-3, seed=5),
            f.adversarial_faults([2], slowdown=7.0),
            f.StragglerFaults(model=straggler(stragglers=(1, 3),
                                              slowdown=4.0)),
            f.FailStop({1: 2}, base=f.StragglerFaults(seed=9)),
            f.Hang({0: 1}, base=f.StragglerFaults(seed=4)),
            f.ScriptedFaults(windows=[{"kind": "slow", "worker": 1,
                                       "t0": 0.0, "delay_s": 0.01}],
                             epoch=12.5, base=f.FailStop({3: 0}))]


def test_injectors_spec_and_behaviour_match():
    """Every injector's spec, delays, fail/hang predicates and masks, for
    the same seeds, equal the reference's."""
    for port, ref in zip(injectors(port_faults, AdversarialSlow),
                         injectors(ref_faults, RefSlow)):
        assert port.to_spec() == ref.to_spec()
        back = port_faults.from_spec(ref.to_spec())
        assert type(back).__name__ == type(ref).__name__
        assert back.to_spec() == ref.to_spec()
        for w in (0, 1, 2, 3, 0, 1):
            assert port.should_fail(w, 2) == ref.should_fail(w, 2)
            assert (getattr(port, "should_hang", lambda *a: False)(w, 1)
                    == getattr(ref, "should_hang", lambda *a: False)(w, 1))
            if not isinstance(port, port_faults.ScriptedFaults):
                assert port.delay(w, 0, 0.5) == ref.delay(w, 0, 0.5)
        if not isinstance(port, port_faults.ScriptedFaults):
            np.testing.assert_array_equal(port.mask(6, 2), ref.mask(6, 2))
    assert isinstance(port_faults.from_spec(None), port_faults.NoFaults)
    with pytest.raises(ValueError, match="unknown fault spec"):
        port_faults.from_spec({"kind": "nope"})


def test_scripted_windows():
    f = port_faults.ScriptedFaults(
        windows=[{"kind": "kill", "worker": 0, "t0": 0.0, "t1": 1e12},
                 {"kind": "hang", "worker": 1, "t0": 0.0},
                 {"kind": "partition", "worker": 2, "t0": 0.0, "t1": 1e12},
                 {"kind": "slow", "worker": 3, "t0": 0.0, "delay_s": 0.25},
                 {"kind": "kill", "worker": 4, "t0": 1e13}],
        epoch=0.0)
    assert f.should_fail(0, 0) and not f.should_fail(4, 0)
    assert f.should_hang(1, 0) and not f.should_hang(0, 0)
    assert f.should_mute(2) and not f.should_mute(3)
    assert f.delay(3, 0, 1.0) == 0.25
    assert f.delay(2, 0, 1.0) > 1e9          # held until the window heals
    np.testing.assert_array_equal(f.mask(5, 1), np.ones(5, bool))


@pytest.mark.parametrize("seed", range(4))
def test_straggler_mask_bitwise(seed):
    for model in (None, "adv"):
        pm = None if model is None else AdversarialSlow((1, 4), 50.0)
        rm = None if model is None else RefSlow((1, 4), 50.0)
        rng_p, rng_r = (np.random.default_rng(seed) for _ in range(2))
        for _ in range(5):
            port = port_faults.straggler_mask(6, 2, rng_p, pm)
            np.testing.assert_array_equal(
                port, ref_faults.straggler_mask(6, 2, rng_r, rm))
            assert port.sum() == 4


def test_faulty_decorator():
    class Task:
        task_row = 0

    class Result:
        work = 2.0

    served = []

    def serve(worker, task, tasks_done):
        served.append(worker)
        return Result()

    wrapped = port_faults.faulty(port_faults.FailStop(
        {0: 1}, base=port_faults.adversarial_faults([1], slowdown=2.0,
                                                    time_scale=1e-4)))(serve)
    assert isinstance(wrapped(0, Task(), 0), Result)
    with pytest.raises(port_faults.WorkerFailure):
        wrapped(0, Task(), 1)
    wrapped(1, Task(), 5)
    hang = port_faults.faulty(port_faults.Hang({2: 0}))(serve)
    with pytest.raises(port_faults.WorkerHang):
        hang(2, Task(), 0)
    assert served == [0, 1]


# ---------------------------------------------------------------------------
# The engine, on weights converted from the JAX package
# ---------------------------------------------------------------------------


def engines(arch, **kw):
    """(jax engine, port engine, jax params, port cfg) on the same weights."""
    cfg = ref_configs.get_smoke_config(arch)
    jm = ref_models.build_model(cfg, dtype=jnp.float32)
    jp = jm.init(jax.random.key(0))
    pcfg = port_configs.get_smoke_config(arch)
    pm = build_model(pcfg, torch.float32, device=CPU)
    sd = model_params_from_reference(jax.tree.map(np.asarray, jp), pcfg,
                                     device=CPU)
    ref_kw = {k: (ref_configs.base.CodedConfig(**v) if k == "coded" else v)
              for k, v in kw.items()}
    port_kw = {k: (port_configs.base.CodedConfig(**v) if k == "coded" else v)
               for k, v in kw.items()}
    return (ref_serve.ServeEngine(jm, jp, cfg, **ref_kw),
            ServeEngine(pm, sd, pcfg, **port_kw), jp, pcfg)


def record(engine, to_numpy):
    """Wrap an engine's prefill and decode to keep every step's logits."""
    seen = []
    prefill, decode = engine._prefill, engine._decode

    def rec_prefill(*a):
        out = prefill(*a)
        seen.append(to_numpy(out[0]))
        return out

    def rec_decode(*a):
        out = decode(*a)
        seen.append(to_numpy(out[0]))
        return out

    engine._prefill, engine._decode = rec_prefill, rec_decode
    return seen


def requests(cls):
    return [cls(prompt=[1, 5, 9], max_new=4), cls(prompt=[1, 7], max_new=4),
            cls(prompt=[1, 2, 3, 4], max_new=4)]


def test_batched_generation_matches():
    """``TestServeEngine.test_batched_generation``'s case: each step's
    logits within f32 tolerance, and the same greedy tokens wherever the
    top-2 margin leaves no near-tie."""
    ref, port, _, _ = engines("phi3-mini-3.8b", batch_size=2, max_len=64)
    ref_logits = record(ref, np.asarray)
    port_logits = record(port, lambda x: x.numpy())
    ref_out = ref.run(requests(ref_serve.Request))
    port_out = port.run(requests(Request))
    assert all(len(r.output) == 4 for r in port_out)
    assert len(port_logits) == len(ref_logits) == 8   # 2 waves x 4 steps
    for p, r in zip(port_logits, ref_logits):
        np.testing.assert_allclose(p, r, **TOL)
    margins = []
    for r in ref_logits:
        top2 = np.sort(r, axis=-1)[:, -2:]
        margins.append(top2[:, 1] - top2[:, 0])
    # the token a step samples is the argmax of that step's logits
    wave_steps = [(0, [0, 1]), (4, [2])]
    for start, rows in wave_steps:
        for step in range(4):
            for j, i in enumerate(rows):
                if margins[start + step][j] > 1e-4:
                    assert port_out[i].output[step] == ref_out[i].output[step]


def test_straggler_masks_bitwise():
    coded = dict(enabled=True, n_workers=6, stragglers=2)
    ref, port, _, _ = engines("qwen3-14b", batch_size=2, max_len=32,
                              coded=coded, rng_seed=3)
    for _ in range(8):
        np.testing.assert_array_equal(port._straggler_mask(),
                                      np.asarray(ref._straggler_mask()))


def test_sampling_shares_the_mask_rng():
    """Temperature sampling and the straggler mask draw from one
    generator, in the reference's order."""
    coded = dict(enabled=True, n_workers=6, stragglers=2)
    ref, port, _, _ = engines("phi3-mini-3.8b", batch_size=2, max_len=32,
                              coded=coded, rng_seed=1)
    for _ in range(3):
        logits = np.random.default_rng(0).standard_normal(
            (2, 256)).astype(np.float32)
        np.testing.assert_array_equal(
            port._sample(torch.as_tensor(logits), greedy=False),
            ref._sample(jnp.asarray(logits), greedy=False))
        np.testing.assert_array_equal(port._straggler_mask(),
                                      np.asarray(ref._straggler_mask()))


@pytest.mark.parametrize("arch", ["qwen3-14b", "gemma3-12b"])
def test_coded_logits_match(arch):
    """``test_coded_head_resilient``'s case (5 random masks against
    ``hidden @ head``), and against the JAX engine's coded head with the
    same plan seed and masks."""
    coded = dict(enabled=True, n_workers=6, stragglers=2, seed=2)
    ref, port, jp, cfg = engines(arch, batch_size=2, max_len=32, coded=coded)
    assert port.coded.seed == ref.coded.seed == 2
    np.testing.assert_array_equal(port.coded.G, np.asarray(ref.coded.G))
    rng = np.random.default_rng(0)
    hidden = rng.standard_normal((2, cfg.d_model)).astype(np.float32)
    head = jp["embed"].T if cfg.tie_embeddings else jp["head"]
    want = np.asarray(jnp.asarray(hidden) @ head)
    for _ in range(5):
        got = port.coded_logits(torch.as_tensor(hidden))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=5e-3, atol=5e-3)
        np.testing.assert_allclose(
            got.numpy(), np.asarray(ref.coded_logits(jnp.asarray(hidden))),
            **TOL)
    done = np.array([True, False, True, True, False, True])
    np.testing.assert_allclose(
        port.coded_logits(torch.as_tensor(hidden), done).numpy(),
        np.asarray(ref.coded_logits(jnp.asarray(hidden), jnp.asarray(done))),
        **TOL)


def test_engine_mask_routes_through_faults():
    coded = dict(enabled=True, n_workers=6, stragglers=2)
    _, port, _, cfg = engines("qwen3-14b", batch_size=2, max_len=32,
                              coded=coded)
    eng = ServeEngine(port.model, port.params, cfg, batch_size=2, max_len=32,
                      coded=port_configs.base.CodedConfig(**coded),
                      faults=port_faults.StragglerFaults(
                          model=AdversarialSlow(stragglers=(0, 1),
                                                slowdown=50.0)))
    mask = eng._straggler_mask()
    assert not mask[0] and not mask[1] and mask.sum() == 4
    with eng:
        hidden = torch.randn(2, cfg.d_model)
        torch.testing.assert_close(
            eng.coded_logits(hidden), hidden @ port.params["head"],
            rtol=5e-3, atol=5e-3)


# one case, the router mode: the name and the case id stay those of the
# test that expected this mode to raise, so its history stays one test
@pytest.mark.parametrize("mode", [dict(router=True)])
def test_unported_coded_modes_raise(mode):
    """The router mode raised ``NotImplementedError`` until
    ``serve/router.py`` was ported; no coded mode raises now.  It serves
    the head through a ``Router`` endpoint, bitwise the in-process
    engine under an explicit mask."""
    from repro_torch.serve import Router

    cfg = port_configs.get_smoke_config("phi3-mini-3.8b")
    model = build_model(cfg, torch.float32, device=CPU)
    params = model.init(torch.Generator().manual_seed(0))
    base = dict(enabled=True, n_workers=6, stragglers=2, backend="packed")
    local = ServeEngine(model, params, cfg,
                        coded=port_configs.base.CodedConfig(**base))
    with Router() as router:
        coded = port_configs.base.CodedConfig(
            **base, **{k: router for k in mode})
        with ServeEngine(model, params, cfg, coded=coded) as eng:
            assert router.endpoints() == ["lm-head"]
            done = np.ones(6, bool)
            done[[0, 3]] = False
            h = torch.randn(2, cfg.d_model)
            assert torch.equal(eng.coded_logits(h, done),
                               local.coded_logits(h, done))
        assert router.endpoints() == []


def test_non_resilient_scheme_rejected():
    cfg = port_configs.get_smoke_config("phi3-mini-3.8b")
    model = build_model(cfg, torch.float32, device=CPU)
    params = model.init(torch.Generator().manual_seed(0))
    coded = port_configs.base.CodedConfig(enabled=True, n_workers=6,
                                          stragglers=2, scheme="repetition")
    with pytest.raises(ValueError, match="not resilient"):
        ServeEngine(model, params, cfg, coded=coded)
    with pytest.raises(ValueError, match="without coded config"):
        ServeEngine(model, params, cfg).coded_logits(torch.ones(1, 64))


def test_eos_stops_a_slot():
    ref, port, _, _ = engines("phi3-mini-3.8b", batch_size=4, max_len=32)
    first = port.run([Request(prompt=[1, 5, 9], max_new=6)])[0].output
    eos = first[1]
    out = port.run([Request(prompt=[1, 5, 9], max_new=6, eos=eos),
                    Request(prompt=[1, 2], max_new=3)])
    assert out[0].output == first[:first.index(eos) + 1]
    assert len(out[1].output) == 3
    ref_out = ref.run([ref_serve.Request(prompt=[1, 5, 9], max_new=6,
                                         eos=eos),
                       ref_serve.Request(prompt=[1, 2], max_new=3)])
    assert [len(r.output) for r in ref_out] == [len(r.output) for r in out]


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------


def launcher_lines(main, argv, capsys, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    main()
    return capsys.readouterr().out.splitlines()


def test_launcher_prints_the_reference_lines(capsys, monkeypatch):
    argv = ["--arch", "phi3-mini-3.8b", "--smoke", "--coded",
            "--requests", "2", "--max-new", "4"]
    port = launcher_lines(port_launch.main, argv + ["--device", "cpu"],
                          capsys, monkeypatch)
    ref = launcher_lines(ref_launch.main, argv, capsys, monkeypatch)
    assert len(port) == len(ref) == 5
    prefixes = ("coded LM head plan: {'scheme': 'proposed', 'kind': 'mv'",
                "served 2 requests, 8 tokens in ", "  req 0: [1, ",
                "  req 1: [1, ", "coded head: 5 random straggler patterns, "
                "worst rel err ")
    for p, r, want in zip(port, ref, prefixes):
        assert p.startswith(want) and r.startswith(want), (p, r)
    # the same seed draws the same prompts in both launchers
    assert [p.split("...")[0] for p in port[2:4]] == \
        [r.split("...")[0] for r in ref[2:4]]
    assert port[4].endswith("(resilient to any 2/6 lost)")
    assert float(port[4].split("worst rel err ")[1].split()[0]) < 1e-4


def test_launcher_steps_drive_the_same_path(capsys):
    args = port_launch.parse_args(
        ["--arch", "gemma3-12b", "--smoke", "--device", "cpu", "--coded",
         "--requests", "3", "--batch", "2", "--max-new", "2",
         "--coded-backend", "packed"])
    cfg, model, params, engine = port_launch.build(args)
    assert engine.coded.backend == "packed" and engine.batch_size == 2
    rng = np.random.default_rng(args.seed)
    out = port_launch.serve(engine, port_launch.make_requests(args, cfg, rng))
    assert [len(r.output) for r in out] == [2, 2, 2]
    assert port_launch.check_coded_head(args, cfg, params, engine, rng) < 1e-4
    assert "served 3 requests, 6 tokens" in capsys.readouterr().out


def test_launcher_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = port_launch.parse_args(["--arch", "phi3-mini-3.8b", "--smoke"])
    assert args.device == "cuda" and args.workers == 6
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_launch.build(args)
