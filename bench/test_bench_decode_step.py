"""The decode-step cell on the CPU at a tiny size: resolution, the step
generator, the yardstick, the plain reference against its copy in the
tests, and the comparison that decides ``correct``.

    python -m pytest bench -q

The tiny cell is the port's ``kimi-k2-instruct`` smoke config (its
published keys shrunk with it) in f32, 4 sessions of 8-token prompts in
a cache of 16 positions; the traffic is the cell's own mix at that size.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import harness
from generators import steps

ROOT = Path(__file__).resolve().parents[1]
BENCHMARK = json.loads((ROOT / "BENCHMARK.json").read_text())
CELL = "kimi-k2-instruct.decode-2k"
SEED = 2**31 + 11
METRICS = {"mfu", "decode_step.roofline", "device.idle_share.model",
           "moe.tokens_per_held_expert"}


def entry(kind: str, name: str) -> dict:
    return next(e for e in BENCHMARK[kind] if e["name"] == name)


# the correction bias drawn wider than the cell's 0.01, so that at 16
# experts dropping it moves the answer past the limits
BIAS_STD = 0.05


def tiny_config() -> dict:
    """The cell's configuration file with the smoke config's widths."""
    from repro_torch.configs import get_smoke_config
    cfg = json.loads((ROOT / entry("configs", "kimi-k2-instruct")["file"])
                     .read_text())
    sm = get_smoke_config("kimi-k2-instruct")
    m, e = sm.mla, sm.moe
    cfg.update(hidden_size=sm.d_model, num_hidden_layers=sm.n_layers,
               vocab_size=sm.vocab, intermediate_size=sm.d_ff,
               num_attention_heads=m.n_heads, q_lora_rank=m.q_lora_rank,
               kv_lora_rank=m.kv_lora_rank,
               qk_nope_head_dim=m.qk_nope_head_dim,
               qk_rope_head_dim=m.qk_rope_head_dim, v_head_dim=m.v_head_dim,
               moe_intermediate_size=e.d_expert, num_experts_per_tok=e.top_k,
               n_routed_experts=e.held, torch_dtype="float32",
               correction_bias_std=BIAS_STD,
               port={"arch": "kimi-k2-instruct", "smoke": True})
    cfg["published"] = dict(cfg["published"], n_routed_experts=e.n_experts)
    return cfg


TINY_TRAFFIC = {"sessions": 4, "prompt": 8, "cache": 16, "prefill_group": 2,
                "warm_steps": 2, "check_steps": 3, "check_per_group": 1}


def tiny_root(root, **traffic_keys):
    """A checkout's files for the tiny cell under ``root``."""
    (root / "bench" / "configs").mkdir(parents=True)
    (root / "bench" / "traffic").mkdir(parents=True)
    (root / entry("configs", "kimi-k2-instruct")["file"]).write_text(
        json.dumps(tiny_config()))
    traffic = json.loads((ROOT / "bench" / "traffic" / "decode-2k.json")
                         .read_text())
    traffic.update(TINY_TRAFFIC, **traffic_keys)
    (root / "bench" / "traffic" / "decode-2k.json").write_text(
        json.dumps(traffic))
    return root


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("tiny"))


def run_tiny(root, seed=SEED, seconds=0.5, trace=False, keep=None):
    return harness.run_cell(CELL, seed, seconds, trace, root=root,
                            device="cpu", bench=BENCHMARK, keep=keep)


def over(res) -> list[str]:
    return [name for name, c in res["checks"].items()
            if "limit" in c and c["value"] > c["limit"]]


# -- the cell's files ---------------------------------------------------------


@pytest.mark.parametrize("trace", [False, True])
def test_the_cell_resolves_to_its_files(trace):
    spec = harness.resolve(BENCHMARK, CELL, trace)
    cfg = spec["config"]
    assert cfg["system"] == "decode_step"
    assert spec["traffic"]["generator"] == "steps"
    assert harness.load_module("systems", "decode_step").System
    names = {m["name"] for m in spec["metrics"]}
    if trace:
        assert METRICS | {"device.idle_share"} == names
    else:
        assert names == {"calls_per_s", "p50_ms", "p95_ms", "setup_s"}
    for name in names:
        assert callable(harness.load_reader(name))
    assert entry("workloads", CELL)["chips"] == 1
    assert set(cfg["correct"]) == {"logits_rel_err_median",
                                   "logits_rel_err_p90",
                                   "logits_rel_err_session_max"}


def test_the_configuration_keeps_every_published_number():
    """Every key of the published config.json (the head cell's file holds
    it whole) is here at its value, but the two cut, which the file
    states beside the published counts."""
    cfg = json.loads((ROOT / "bench/configs/kimi-k2-instruct.json")
                     .read_text())
    head = json.loads((ROOT / "bench/configs/kimi-k2-instruct-head.json")
                      .read_text())
    skip = {"system", "published", "deployment", "coded", "hidden_pool",
            "assumed", "guarantees", "correct"}
    cut = set(entry("configs", "kimi-k2-instruct")["reduced"])
    for key, value in head.items():
        if key in skip or key == "num_hidden_layers":
            continue
        if key in cut:
            continue
        assert cfg[key] == value, key
    assert (cfg["num_hidden_layers"], cfg["n_routed_experts"]) == (5, 8)
    assert cfg["published"] == {"num_hidden_layers": 61,
                                "n_routed_experts": 384}
    assert set(cfg["reduced"]) == cut
    mc = harness.load_module("systems", "decode_step").model_config(cfg)
    assert (mc.n_layers, mc.moe.n_experts, mc.moe.held, mc.moe.held_from) \
        == (5, 384, 8, 0)


# -- the generator ------------------------------------------------------------


def test_steps_are_fixed_by_the_seed():
    t = dict(TINY_TRAFFIC)

    class Sys:
        vocab, dev = 97, torch.device("cpu")

    def take(seed, n=40):
        it = steps.items(Sys, t, seed)
        return [next(it) for _ in range(n)]

    a, b, c = take(5), take(5), take(6)
    for x, y in zip(a, b):
        assert x["pos"] == y["pos"] and torch.equal(x["ids"], y["ids"])
        assert np.array_equal(x["rows"], y["rows"])
        assert np.array_equal(x["history"](), y["history"]())
    assert any(not torch.equal(x["ids"], y["ids"]) for x, y in zip(a, c))
    assert np.array_equal(steps.prompts(t, 97, 5), steps.prompts(t, 97, 5))
    # positions 8..15, then the rewind to 8; the history restarts there
    assert [x["pos"] for x in a[:18]] == list(range(8, 16)) * 2 + [8, 9]
    assert a[7]["history"]().shape == (2, 8)
    assert a[9]["history"]().shape == (2, 2)
    first = a[9]["history"]()
    assert np.array_equal(first[:, 0], a[8]["ids"][a[9]["rows"], 0].numpy())
    assert np.array_equal(first[:, 1], a[9]["ids"][a[9]["rows"], 0].numpy())
    # the checked sessions: one of each prefill group of 2, the same at
    # every step of a run
    for x in a:
        assert np.array_equal(x["rows"], a[0]["rows"])
    assert a[0]["rows"][0] in (0, 1) and a[0]["rows"][1] in (2, 3)
    assert any(not np.array_equal(take(s, 1)[0]["rows"], a[0]["rows"])
               for s in range(7, 17))
    # a large seed draws as well
    assert take(2**31 + 99, 2)[0]["ids"].shape == (4, 1)


# -- the yardstick ------------------------------------------------------------


def test_step_counts_by_hand():
    sysmod = harness.load_module("systems", "decode_step")
    cfg = json.loads((ROOT / "bench/configs/kimi-k2-instruct.json")
                     .read_text())
    got = sysmod.step_counts(cfg, 1024, 2500)
    # bytes: the weights (4.847e9 parameters but the embedding's table,
    # bf16; the routers and biases f32), 1024 rows of the table, the
    # latent cache (5 x 1024 x 2500 x 576 x 2), the logits (f32)
    params = 4_847_329_792 - 163840 * 7168
    router = 4 * (7168 * 384 + 384)
    want = ((params - router) * 2 + router * 4 + 1024 * 7168 * 2
            + 5 * 1024 * 2500 * 576 * 2 + 1024 * 163840 * 4)
    assert got["step_bytes"] == pytest.approx(want, rel=1e-9)
    assert 6e-3 < got["step_least_s"] < 8e-3
    assert got["flops"] == pytest.approx(6.6e12, rel=0.1)


def test_metric_readers_on_a_synthetic_run():
    class Rec:
        completed_in_window = 10

    work = {"flops": 10 * 6e12, "step_least_s": 10 * 7e-3}
    trace = {"busy_s": 0.5, "window_s": 1.0,
             "gaps": [("moe.experts", 0.05), ("mla.decode", 0.01),
                      ("bench.call", 0.2), ("plan.matvec", 0.1)]}
    run = harness.Run(work=work, record=Rec(), trace=trace,
                      before={"moe": {"held_tokens": 0, "held_experts": 32}},
                      after={"moe": {"held_tokens": 6720,
                                     "held_experts": 32}})
    read = {m: harness.load_reader(m) for m in METRICS}
    assert read["mfu"](run) == pytest.approx(
        100 * 6e13 / 989e12)
    assert read["decode_step.roofline"](run) == pytest.approx(14.0)
    assert read["device.idle_share.model"](run) == pytest.approx(6.0)
    assert read["moe.tokens_per_held_expert"](run) == pytest.approx(21.0)
    empty = harness.Run(work={}, record=Rec(), trace=None, before={},
                        after={})
    assert all(read[m](empty) is None for m in METRICS)


# -- the reference ------------------------------------------------------------


def test_the_benchmarks_reference_is_the_tests_reference():
    """``reference/kimi_k2.py`` is ``tests/_plain_kimi_k2.py``: the same
    file, and the same logits on the tiny config."""
    here = ROOT / "bench" / "reference" / "kimi_k2.py"
    there = ROOT / "tests" / "_plain_kimi_k2.py"
    assert here.read_text() == there.read_text()
    spec = importlib.util.spec_from_file_location("_plain_kimi_k2", there)
    plain = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(plain)
    from reference import kimi_k2
    sysmod = harness.load_module("systems", "decode_step")
    cfg = tiny_config()
    system = sysmod.System(cfg, SEED, torch.device("cpu"))
    weights = sysmod.draw_weights(cfg, SEED, torch.device("cpu"))
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg["vocab_size"], (2, 9)))
    a = kimi_k2.forward(weights, cfg, toks)
    b = plain.forward(weights, cfg, toks)
    assert torch.equal(a, b)
    assert torch.equal(kimi_k2.forward(weights, cfg, toks,
                                       positions=[3, 8]), a[:, [3, 8]])
    with torch.inference_mode():
        got, _ = system.model(toks)
    torch.testing.assert_close(got, a, rtol=1e-4, atol=1e-4)


def test_the_program_runs_the_weights_the_benchmark_draws():
    """The model holds exactly what ``draw_weights`` drew, by every name
    the reference reads, and a second draw from the seed is the same:
    the program's own ``init`` plays no part."""
    sysmod = harness.load_module("systems", "decode_step")
    cfg = tiny_config()
    system = sysmod.System(cfg, SEED, torch.device("cpu"))
    weights = sysmod.draw_weights(cfg, SEED, torch.device("cpu"))
    held = system.model.state_dict()
    assert set(held) == set(weights)
    for name, t in weights.items():
        assert torch.equal(held[name].to(t.dtype), t), name
    bias = weights["layers.1.moe.bias"]
    assert bias.dtype == torch.float32 and 0.03 < float(bias.std()) < 0.07
    assert torch.equal(weights["layers.0.norm1"],
                       torch.ones_like(weights["layers.0.norm1"]))
    other = sysmod.draw_weights(cfg, SEED + 1, torch.device("cpu"))
    assert not torch.equal(other["head"], weights["head"])


# -- correct ------------------------------------------------------------------


def test_sound_run_is_correct_and_reports_every_metric(tiny):
    keep: dict = {}
    res = run_tiny(tiny, keep=keep)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["metrics"]) == {"calls_per_s", "p50_ms", "p95_ms",
                                   "setup_s"}
    assert res["checks"]["checked_calls"]["value"] == 3
    assert len(keep["found"]["per_call"]) == 3 * 2
    assert keep["found"]["logits_rel_err_max"] < 1e-4
    # traced on the CPU: the counter's reader reads, the device's stay
    # silent
    res = run_tiny(tiny, trace=True)
    assert res["correct"]
    assert set(res["metrics"]) == {"moe.tokens_per_held_expert"}
    per = res["metrics"]["moe.tokens_per_held_expert"]["value"]
    assert 0 < per <= 4 * 4


def _patch_call(monkeypatch, answer):
    System = harness.load_module("systems", "decode_step").System
    call = System.call
    monkeypatch.setattr(System, "call",
                        lambda self, item: answer(self, item, call))


def test_fp8_control_in_the_timed_path_is_not_correct(tiny, monkeypatch):
    def control(self, item, call):
        out = call(self, item).clone()
        out[torch.as_tensor(item["rows"])] = self.control([item])[0]
        return out
    _patch_call(monkeypatch, control)
    res = run_tiny(tiny)
    assert not res["correct"]
    assert {"logits_rel_err_median", "logits_rel_err_p90"} <= set(over(res))


def test_correction_bias_dropped_in_the_program_is_not_correct(
        tiny, monkeypatch):
    import repro_torch.models.moe as moe
    route = moe.route_sigmoid
    monkeypatch.setattr(moe, "route_sigmoid", lambda router, bias, *a:
                        route(router, torch.zeros_like(bias), *a))
    res = run_tiny(tiny)
    assert not res["correct"]
    assert over(res)


def test_latent_cache_kept_in_fp8_reads_as_the_cache_control(
        tiny, monkeypatch):
    """A program that kept its ``{c, kr}`` cache in fp8 e4m3 (each
    position rounded once, before a step first reads it: the prompt's
    with one scale, each later one with its own) reads what the
    reference's latent-cache control reads, far from the sound
    program's: the control, whose chip readings the cell's limits
    refuse, stands for that fault."""
    import repro_torch.models.transformer as tf
    from reference.kimi_k2 import to_fp8
    sound = run_tiny(tiny)["checks"]["logits_rel_err_median"]["value"]
    decode = tf.mla_decode
    done: dict = {}

    def rounded(p, h, cache, step, *a, **kw):
        for name in ("c", "kr"):
            t = cache[name]
            at = min(done.get(id(t), 0), step)
            if at < step:
                t[:, at:step] = to_fp8(t[:, at:step])
            done[id(t)] = step
        return decode(p, h, cache, step, *a, **kw)
    monkeypatch.setattr(tf, "mla_decode", rounded)
    keep: dict = {}
    run_tiny(tiny, keep=keep)
    system, items = keep["system"], [item for item, _ in keep["samples"]]
    control = system.check(list(zip(items, system.cache_control(items))))
    fault = keep["found"]
    for name in ("logits_rel_err_median", "logits_rel_err_p90"):
        assert fault[name] > 50 * sound and control[name] > 50 * sound
        assert 0.5 < fault[name] / control[name] < 2.0, name


def test_a_fault_in_one_prefill_group_is_not_correct(tmp_path,
                                                     monkeypatch):
    """One group's joined cache one position off, in 12 groups: a twelfth
    of the checked rows, which neither the median nor the 90th
    percentile sees, and the worst session's median does."""
    import repro_torch.models as models
    join = models.join_caches

    def shifted(parts, max_len):
        out = join(parts, max_len)
        step = out["step"]
        for layer in out["layers"]:
            for t in layer.values():
                t[2:4, 1:step] = t[2:4, :step - 1].clone()
        return out
    monkeypatch.setattr(models, "join_caches", shifted)
    res = run_tiny(tiny_root(tmp_path, sessions=24))
    assert not res["correct"]
    assert over(res) == ["logits_rel_err_session_max"]


def test_cache_rewound_one_position_off_is_not_correct(tiny, monkeypatch):
    _patch_call(monkeypatch, lambda self, item, call:
                call(self, dict(item, pos=item["pos"] - 1)))
    res = run_tiny(tiny)
    assert not res["correct"]
    assert over(res)


def test_the_parent_program_fails_the_cell_at_once(tiny, monkeypatch):
    """A program without the arch (as the parent commit's) raises while
    the system builds, before any set-up."""
    import repro_torch.configs.registry as registry
    monkeypatch.delitem(registry._MODULES, "kimi-k2-instruct")
    with pytest.raises(KeyError):
        run_tiny(tiny)
