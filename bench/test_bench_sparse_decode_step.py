"""The sparse decode-step cell on the CPU at a tiny size: resolution, the
``long_steps`` generator, the yardstick, the plain reference against its
copy in the tests, the in-place prefill, and the comparison that
decides ``correct`` with its three controls.

    python -m pytest bench -q

The tiny cell is the port's ``deepseek-v3.2`` smoke config (its
published keys shrunk with it: an indexer of 16 heads that selects 8
positions, 16 experts in 4 groups of which 2 are chosen from, 8 held) in
f32, 4 sessions of 24-token prompts in a cache of 32 positions, so that
the prefill and every step select.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest
import torch

import harness

ROOT = Path(__file__).resolve().parents[1]
BENCHMARK = json.loads((ROOT / "BENCHMARK.json").read_text())
CELL = "deepseek-v3.2.decode-32k"
CONFIG = "deepseek-v3.2"
SEED = 2**31 + 23
METRICS = {"mfu", "decode_step.roofline", "device.idle_share.model",
           "moe.tokens_per_held_expert", "dsa.attended_share"}
# the correction bias drawn wider than the cell's 0.01, so that at 16
# experts dropping it moves the answer past the limits
BIAS_STD = 0.05
TINY_TRAFFIC = {"sessions": 4, "prompt": 24, "cache": 32, "prefill_group": 2,
                "warm_steps": 2, "check_steps": 3, "check_sessions": 2}


def entry(kind: str, name: str) -> dict:
    return next(e for e in BENCHMARK[kind] if e["name"] == name)


def system_module():
    return harness.load_module("systems", "sparse_decode_step")


def generator():
    return harness.load_module("generators", "long_steps")


def tiny_config() -> dict:
    """The cell's configuration file with the smoke config's widths."""
    from repro_torch.configs import get_smoke_config
    cfg = json.loads((ROOT / entry("configs", CONFIG)["file"]).read_text())
    sm = get_smoke_config(CONFIG)
    m, e, ix = sm.mla, sm.moe, sm.indexer
    cfg.update(hidden_size=sm.d_model, num_hidden_layers=sm.n_layers,
               vocab_size=sm.vocab, intermediate_size=sm.d_ff,
               num_attention_heads=m.n_heads, q_lora_rank=m.q_lora_rank,
               kv_lora_rank=m.kv_lora_rank,
               qk_nope_head_dim=m.qk_nope_head_dim,
               qk_rope_head_dim=m.qk_rope_head_dim, v_head_dim=m.v_head_dim,
               moe_intermediate_size=e.d_expert, num_experts_per_tok=e.top_k,
               n_routed_experts=e.held, n_group=e.n_group,
               topk_group=e.topk_group, index_n_heads=ix.n_heads,
               index_head_dim=ix.head_dim, index_topk=ix.topk,
               torch_dtype="float32", correction_bias_std=BIAS_STD,
               port={"arch": CONFIG, "smoke": True})
    cfg["published"] = dict(cfg["published"], n_routed_experts=e.n_experts)
    # the cell's logits limits are set for bf16 at published widths,
    # where the indexer's selection flips dominate; the tiny f32 program
    # selects as the reference does and is held to the Kimi-K2 cell's
    # tighter ones, and to the cell's own of layer 0
    cfg["correct"] = dict(cfg["correct"], logits_rel_err_median=0.04,
                          logits_rel_err_p90=0.05,
                          logits_rel_err_session_max=0.045)
    return cfg


def tiny_root(root, **traffic_keys):
    """A checkout's files for the tiny cell under ``root``."""
    (root / "bench" / "configs").mkdir(parents=True)
    (root / "bench" / "traffic").mkdir(parents=True)
    (root / entry("configs", CONFIG)["file"]).write_text(
        json.dumps(tiny_config()))
    traffic = json.loads((ROOT / "bench" / "traffic" / "decode-32k.json")
                         .read_text())
    traffic.update(TINY_TRAFFIC, **traffic_keys)
    (root / "bench" / "traffic" / "decode-32k.json").write_text(
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
    assert cfg["system"] == "sparse_decode_step"
    assert spec["traffic"]["generator"] == "long_steps"
    assert system_module().System and generator().items
    names = {m["name"] for m in spec["metrics"]}
    if trace:
        assert METRICS | {"device.idle_share"} == names
    else:
        assert names == {"calls_per_s", "p50_ms", "p95_ms", "setup_s"}
    for name in names:
        assert callable(harness.load_reader(name))
    assert entry("workloads", CELL)["chips"] == 1


def test_the_configuration_states_its_cuts():
    """The four keys cut are the entry's ``reduced``, each with its
    published value beside it; the model that builds is the file's."""
    cfg = json.loads((ROOT / entry("configs", CONFIG)["file"]).read_text())
    cut = entry("configs", CONFIG)["reduced"]
    assert set(cfg["reduced"]) == set(cut) == set(cfg["published"])
    assert cfg["published"] == {"num_hidden_layers": 61,
                                "first_k_dense_replace": 3,
                                "n_routed_experts": 256,
                                "num_nextn_predict_layers": 1}
    assert [cfg[k] for k in ("num_hidden_layers", "first_k_dense_replace",
                             "n_routed_experts",
                             "num_nextn_predict_layers")] == [5, 1, 8, 0]
    from repro_torch.configs import get_config
    full = get_config(CONFIG)
    mc = system_module().model_config(cfg)
    assert (mc.n_layers, mc.first_dense, mc.moe.n_experts, mc.moe.held,
            mc.moe.n_group, mc.moe.topk_group) == (5, 1, 256, 8, 8, 4)
    assert mc.mla == full.mla and mc.indexer == full.indexer
    assert mc.param_count() == pytest.approx(4.848e9, rel=1e-3)


def test_a_file_that_disagrees_with_the_model_is_refused():
    cfg = json.loads((ROOT / entry("configs", CONFIG)["file"]).read_text())
    for key, value in (("index_topk", 1024), ("n_group", 4)):
        with pytest.raises(ValueError, match=key):
            system_module().model_config(dict(cfg, **{key: value}))
    rs = dict(cfg["rope_scaling"], beta_fast=1)
    with pytest.raises(ValueError, match="beta_fast"):
        system_module().model_config(dict(cfg, rope_scaling=rs))


# -- the generator ------------------------------------------------------------


def test_long_steps_check_sessions_drawn_from_every_session():
    gen = generator()
    t = dict(TINY_TRAFFIC, sessions=64, check_sessions=8)

    class Sys:
        vocab, dev = 97, torch.device("cpu")

    a = [next(gen.items(Sys, t, s)) for s in range(12)]
    for item in a:
        rows = item["rows"]
        assert len(rows) == 8 and list(rows) == sorted(set(rows))
        assert 0 <= rows[0] and rows[-1] < 64
    # not one of each prefill group of 2: any sessions, seed by seed
    assert any(np.any(np.diff(x["rows"] // 2) == 0) for x in a)
    assert len({tuple(x["rows"]) for x in a}) == 12
    again = next(gen.items(Sys, t, 5))
    assert np.array_equal(again["rows"], a[5]["rows"])
    assert torch.equal(again["ids"], a[5]["ids"])
    # the positions, the ids and the history are steps'
    it = gen.items(Sys, t, 2**31 + 99)
    xs = [next(it) for _ in range(10)]
    assert [x["pos"] for x in xs] == list(range(24, 32)) + [24, 25]
    assert xs[9]["history"]().shape == (8, 2)


# -- the yardstick ------------------------------------------------------------


def test_step_counts_by_hand():
    sysmod = system_module()
    cfg = json.loads((ROOT / entry("configs", CONFIG)["file"]).read_text())
    got = sysmod.step_counts(cfg, 128, 33280)
    # bytes: the weights but the embedding's table (bf16; the routers and
    # biases f32), 128 rows of the table, per layer the indexer's keys to
    # 33280 and 2048 selected rows of [c | kr], the logits (f32)
    params = 4_847_920_384 - 129280 * 7168
    router = 4 * (7168 * 256 + 256)
    want = ((params - router) * 2 + router * 4 + 128 * 7168 * 2
            + 5 * 128 * 33280 * 128 * 2 + 5 * 128 * 2048 * 576 * 2
            + 128 * 129280 * 4)
    assert got["step_bytes"] == pytest.approx(want, rel=1e-9)
    assert got["step_bytes"] == pytest.approx(14.9e9, rel=0.01)
    assert 4.3e-3 < got["step_least_s"] < 4.6e-3
    # operations: the dense count of the base at 2048 positions plus the
    # indexer's scores of every position (2 x 64 x 128 a head-key pair)
    base = harness.load_module("systems", "decode_step")
    flops = base.step_counts(cfg, 128, 2048)["flops"]
    scores = 5 * 2 * 128 * 33280 * 64 * (128 + 1)
    ix_w = 5 * 2 * 128 * (1536 * 64 * 128 + 7168 * 128 + 7168 * 64)
    assert got["flops"] == pytest.approx(flops + scores + ix_w, rel=1e-9)
    # before the indexer selects, every position is attended
    early = sysmod.step_counts(cfg, 128, 1000)
    assert early["step_bytes"] == pytest.approx(
        base.step_counts(cfg, 128, 1000)["step_bytes"]
        + 5 * (1536 * 64 * 128 + 7168 * 128 + 7168 * 64 + 256) * 2
        + 5 * 128 * 1000 * 128 * 2, rel=1e-9)


def test_the_attended_share_reader():
    read = harness.load_reader("dsa.attended_share")
    run = harness.Run(before={"dsa": {"attended": 10, "cached": 100}},
                      after={"dsa": {"attended": 10 + 5 * 2048 * 128,
                                     "cached": 100 + 5 * 33280 * 128}})
    assert read(run) == pytest.approx(100 * 2048 / 33280)
    assert read(harness.Run(before={}, after={})) is None


# -- the reference ------------------------------------------------------------


def test_the_benchmarks_reference_is_the_tests_reference():
    """``reference/deepseek_v32.py`` is ``tests/_plain_deepseek_v32.py``,
    and the program on the tiny config agrees with it, selection
    included (the sequence is longer than ``index_topk``)."""
    here = ROOT / "bench" / "reference" / "deepseek_v32.py"
    there = ROOT / "tests" / "_plain_deepseek_v32.py"
    assert here.read_text() == there.read_text()
    from reference import deepseek_v32
    sysmod = system_module()
    cfg = tiny_config()
    system = sysmod.System(cfg, SEED, torch.device("cpu"))
    weights = sysmod.draw_weights(cfg, SEED, torch.device("cpu"))
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg["vocab_size"], (2, 30)))
    want = deepseek_v32.forward(weights, cfg, toks)
    # the last layer computes only the rows asked for
    torch.testing.assert_close(deepseek_v32.forward(
        weights, cfg, toks, positions=[3, 29]), want[:, [3, 29]],
        rtol=1e-6, atol=1e-6)
    with torch.inference_mode():
        got, _ = system.model(toks)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    dense = deepseek_v32.forward(weights, cfg, toks, dense=True)
    assert (dense - want).abs().max() > 100 * 1e-4 * want.abs().max()


def test_the_program_runs_the_weights_the_benchmark_draws():
    sysmod = system_module()
    cfg = tiny_config()
    system = sysmod.System(cfg, SEED, torch.device("cpu"))
    weights = sysmod.draw_weights(cfg, SEED, torch.device("cpu"))
    held = system.model.state_dict()
    assert set(held) == set(weights)
    for name, t in weights.items():
        assert torch.equal(held[name].to(t.dtype), t), name
    assert not weights["layers.1.attn.indexer.k_bias"].any()
    assert weights["layers.1.attn.indexer.wq_b"].std() > 0.01


def test_prefill_in_place_is_the_prefill_of_every_session(tiny):
    """Groups of 2 written into one cache give every layer's ``c``, ``kr``
    and ``ik`` of one prefill of all 4 sessions, zeros past the prompt."""
    sysmod = system_module()
    cfg = tiny_config()
    system = sysmod.System(cfg, SEED, torch.device("cpu"))
    prompts = np.random.default_rng(1).integers(0, cfg["vocab_size"],
                                                (4, 24))
    system.prefill(prompts, 32, 2)
    with torch.inference_mode():
        _, whole = system.model.prefill(torch.as_tensor(prompts), 32)
    assert system.cache["step"] == whole["step"] == 24
    for a, b in zip(system.cache["layers"], whole["layers"]):
        assert set(a) == set(b) == {"c", "kr", "ik"}
        for name in a:
            torch.testing.assert_close(a[name], b[name], rtol=1e-5,
                                       atol=1e-5)
            assert not a[name][:, 24:].any()


# -- correct ------------------------------------------------------------------


def test_sound_run_is_correct_and_reports_every_metric(tiny):
    keep: dict = {}
    res = run_tiny(tiny, keep=keep)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["metrics"]) == {"calls_per_s", "p50_ms", "p95_ms",
                                   "setup_s"}
    # every completed step up to 3 is sampled (a loaded machine may
    # complete fewer in the window)
    checked = res["checks"]["checked_calls"]["value"]
    assert checked == min(3, res["attempted"])
    assert len(keep["found"]["per_call"]) == checked * 2
    assert keep["found"]["logits_rel_err_max"] < 1e-4
    # traced on the CPU: the counters' readers read, the device's stay
    # silent; every step attends 8 of its 25-31 positions
    res = run_tiny(tiny, trace=True)
    assert res["correct"]
    assert set(res["metrics"]) == {"moe.tokens_per_held_expert",
                                   "dsa.attended_share"}
    share = res["metrics"]["dsa.attended_share"]["value"]
    assert 100 * 8 / 32 <= share <= 100 * 8 / 25


def _patch_call(monkeypatch, answer):
    System = system_module().System
    call = System.call
    monkeypatch.setattr(System, "call",
                        lambda self, item: answer(self, item, call))


@pytest.mark.parametrize("control", ["control", "dense_control"])
def test_each_control_in_the_timed_path_is_not_correct(tiny, monkeypatch,
                                                       control):
    """The sampled rows replaced by a control's answer: fp8 weights and
    activations, or every position attended."""
    def answer(self, item, call):
        out = call(self, item).clone()
        out[torch.as_tensor(item["rows"])] = getattr(self, control)(
            [item])[0]["logits"]
        return out
    _patch_call(monkeypatch, answer)
    res = run_tiny(tiny)
    assert not res["correct"]
    assert {"logits_rel_err_median", "logits_rel_err_p90"} <= set(over(res))


def test_the_latent_cache_control_reads_far_from_the_program(tiny):
    """The latent-cache control (c and k_pe through fp8 e4m3) reads far
    above the sound program on the same sampled steps, and its layer 0's
    cached rows over the cell's limit; its selection in layer 0, which
    reads no latent, is the reference's."""
    keep: dict = {}
    res = run_tiny(tiny, keep=keep)
    system, items = keep["system"], [item for item, _ in keep["samples"]]
    control = system.check(list(zip(items, system.cache_control(items))))
    for name in ("logits_rel_err_median", "logits_rel_err_p90",
                 "cache_rel_err_max"):
        assert control[name] > 50 * keep["found"][name], name
    assert control["cache_rel_err_max"] > \
        res["checks"]["cache_rel_err_max"]["limit"]
    assert control["select_outside_max"] == 0.0


def test_a_sampled_step_keeps_layer_0s_rows_and_choice(tiny):
    """Of each checked session: its logits, the 8 positions its layer 0
    attended, and that layer's cache rows at 16 prompt positions and the
    step's own, equal to the cache the program holds."""
    keep: dict = {}
    run_tiny(tiny, keep=keep)
    system = keep["system"]
    item, got = keep["samples"][0]
    assert got["logits"].shape == (2, system.vocab)
    assert got["chosen"].shape == (2, 8)
    assert int(got["chosen"].max()) <= item["pos"]
    at = system.cache_positions(item["pos"])
    assert len(at) == 17 and at[0] == 0 and at[-2] == 23
    assert at[-1] == item["pos"]
    for name, t in got["cache"].items():
        assert t.shape[:2] == (2, 17) and t.abs().amax(-1).min() > 0, name
    assert keep["found"]["select_outside_max"] == 0.0
    assert keep["found"]["cache_rel_err_max"] < 1e-4


def test_a_program_that_caches_in_fp8_is_not_correct(tiny, monkeypatch):
    """The program's latent cache stored through fp8 e4m3 after its
    prefill and at every step: layer 0's rows leave the reference's."""
    from reference import deepseek_v32
    System = system_module().System
    call = System.call

    def rounded(self, item):
        out = call(self, item)
        with torch.inference_mode():
            for layer in self.cache["layers"]:
                for name in ("c", "kr"):
                    layer[name].copy_(deepseek_v32.to_fp8(layer[name]))
        return out
    monkeypatch.setattr(System, "call", rounded)
    res = run_tiny(tiny)
    assert not res["correct"]
    assert "cache_rel_err_max" in over(res)


@pytest.mark.parametrize("fault", ["dense", "last"])
def test_a_program_that_selects_otherwise_is_not_correct(tiny, monkeypatch,
                                                         fault):
    """The indexer's choice replaced in the program, in prefill and in
    every step: every position attended, or the last ``index_topk``."""
    import dataclasses

    import repro_torch.models.dsa as dsa
    import repro_torch.models.transformer as tf
    if fault == "dense":
        prefill, decode = tf.dsa_prefill, tf.dsa_decode

        def wide(ix):
            return dataclasses.replace(ix, topk=10**9)
        monkeypatch.setattr(tf, "dsa_prefill", lambda p, h, m, ix, **kw:
                            prefill(p, h, m, wide(ix), **kw))
        monkeypatch.setattr(tf, "dsa_decode", lambda p, h, c, s, m, ix, **kw:
                            decode(p, h, c, s, m, wide(ix), **kw))
    else:
        def last(p, qr, h, keys, first, m, ix):
            b, n, _ = h.shape
            end = torch.arange(first, first + n)[:, None] + 1
            return (end - ix.topk + torch.arange(ix.topk)).expand(b, n, -1)
        monkeypatch.setattr(dsa, "index_topk", last)
    res = run_tiny(tiny)
    assert not res["correct"]
    assert "select_outside_max" in over(res)


def test_correction_bias_dropped_in_the_program_is_not_correct(
        tiny, monkeypatch):
    import repro_torch.models.moe as moe
    route = moe.route_sigmoid
    monkeypatch.setattr(moe, "route_sigmoid", lambda router, bias, *a:
                        route(router, torch.zeros_like(bias), *a))
    res = run_tiny(tiny)
    assert not res["correct"]


def test_the_parent_program_fails_the_cell_at_once(tiny, monkeypatch):
    """A program without the arch (as the parent commit's) stops the run
    with the harness's error (exit 2) while the system builds."""
    import repro_torch.configs.registry as registry
    monkeypatch.delitem(registry._MODULES, CONFIG)
    with pytest.raises(harness.BenchError, match="no arch"):
        run_tiny(tiny)
