"""The port's ``deepseek-v3.2`` (latent attention made sparse by DeepSeek
Sparse Attention's lightning indexer, group-limited sigmoid routing over
held experts, a shared expert, a dense first layer) against the plain
reference ``tests/_plain_deepseek_v32.py``, on its smoke config in f32.

The smoke indexer selects 8 positions, so every prompt and step here
longer than 8 tokens selects.  Tolerances as in
``test_torch_kimi_k2.py``: the port and the reference compute in f32
from the same weights in other orders (the absorbed form over gathered
rows against expanded scores under a mask), so a logit differs by
rounding alone, 1e-4 of the largest, as long as both select the same
positions; the smoke indexer has 16 heads, so that no two positions tie
at an index of exactly 0 (every head's ReLU zero).
"""

import dataclasses
import math
from pathlib import Path

import numpy as np
import pytest
import torch

import _plain_deepseek_v32 as plain
import repro_torch.models.dsa as dsa
import repro_torch.models.transformer as tf
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import build_model, join_caches
from repro_torch.models.mla import (
    mla_decode,
    rope_amplitude,
    softmax_scale,
    yarn_freqs,
)
from repro_torch.models.moe import _full_f32, moe_block_held, route_sigmoid

ARCH = "deepseek-v3.2"
CPU = torch.device("cpu")
TOL = dict(rtol=1e-4, atol=1e-4)
ROOT = Path(__file__).resolve().parents[1]


def published(cfg) -> dict:
    """The config as the published ``config.json`` names it (the
    reference's input); ``experts_held_from`` beside it."""
    m, e, ix = cfg.mla, cfg.moe, cfg.indexer
    return {
        "hidden_size": cfg.d_model, "num_hidden_layers": cfg.n_layers,
        "num_attention_heads": m.n_heads, "q_lora_rank": m.q_lora_rank,
        "kv_lora_rank": m.kv_lora_rank,
        "qk_nope_head_dim": m.qk_nope_head_dim,
        "qk_rope_head_dim": m.qk_rope_head_dim, "v_head_dim": m.v_head_dim,
        "rope_theta": m.rope_theta,
        "rope_scaling": {"factor": m.rope_factor,
                         "original_max_position_embeddings":
                         m.rope_original_max, "beta_fast": m.beta_fast,
                         "beta_slow": m.beta_slow, "mscale": m.mscale,
                         "mscale_all_dim": m.mscale_all_dim, "type": "yarn"},
        "num_experts_per_tok": e.top_k, "n_routed_experts": e.held,
        "routed_scaling_factor": e.routed_scale, "norm_topk_prob": True,
        "n_shared_experts": e.n_shared_experts, "n_group": e.n_group,
        "topk_group": e.topk_group, "first_k_dense_replace": cfg.first_dense,
        "rms_norm_eps": cfg.norm_eps, "experts_held_from": e.held_from,
        "index_n_heads": ix.n_heads, "index_head_dim": ix.head_dim,
        "index_topk": ix.topk}


def smoke_model(seed=0, cfg=None):
    cfg = cfg or get_smoke_config(ARCH)
    model = build_model(cfg, torch.float32, device=CPU)
    sd = model.init(torch.Generator().manual_seed(seed))
    return cfg, model, sd


@pytest.fixture(scope="module")
def smoke():
    return smoke_model()


def tokens(cfg, b, s, seed=1):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.integers(0, cfg.vocab, (b, s)))


# ---------------------------------------------------------------------------
# The configuration
# ---------------------------------------------------------------------------


def test_config_is_the_published_one():
    cfg = get_config(ARCH)
    m, e, ix = cfg.mla, cfg.moe, cfg.indexer
    assert (cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.vocab) == \
        (61, 7168, 18432, 129280)
    assert (m.n_heads, m.q_lora_rank, m.kv_lora_rank, m.qk_nope_head_dim,
            m.qk_rope_head_dim, m.v_head_dim) == (128, 1536, 512, 128, 64,
                                                  128)
    assert (m.rope_theta, m.rope_factor, m.rope_original_max, m.beta_fast,
            m.beta_slow, m.mscale, m.mscale_all_dim) == \
        (10000.0, 40.0, 4096, 32.0, 1.0, 1.0, 1.0)
    assert (ix.n_heads, ix.head_dim, ix.topk) == (64, 128, 2048)
    assert (e.n_experts, e.top_k, e.d_expert, e.n_shared_experts,
            e.scoring, e.routed_scale, e.n_group, e.topk_group, e.held) == \
        (256, 8, 2048, 1, "sigmoid", 2.5, 8, 4, 256)
    assert cfg.first_dense == 3 and not cfg.tie_embeddings
    assert softmax_scale(m) == pytest.approx(
        192 ** -0.5 * (0.1 * math.log(40) + 1) ** 2)
    assert softmax_scale(m) == pytest.approx(0.1352, abs=1e-4)
    # Kimi-K2 keeps no indexer and one group
    kimi = get_config("kimi-k2-instruct")
    assert kimi.indexer is None and kimi.moe.n_group == 1


@pytest.mark.parametrize("smoke_cfg", [False, True])
def test_param_count_is_every_weight(smoke_cfg):
    cfg = get_smoke_config(ARCH) if smoke_cfg else get_config(ARCH)
    sd = build_model(cfg, torch.bfloat16, device="meta").state_dict()
    assert cfg.param_count() == sum(v.numel() for v in sd.values())
    assert any(".attn.indexer.w_proj" in k for k in sd)
    cut = cfg.with_(n_layers=5 if not smoke_cfg else 2, first_dense=1,
                    moe=dataclasses.replace(cfg.moe, n_held=8))
    sd = build_model(cut, torch.bfloat16, device="meta").state_dict()
    assert cut.param_count() == sum(v.numel() for v in sd.values())
    if not smoke_cfg:
        # the cell's cut: 9.70 GB in bf16
        assert cut.param_count() == pytest.approx(4.848e9, rel=1e-3)
        assert cfg.param_count() == pytest.approx(671.9e9, rel=1e-3)


def test_yarn_frequencies_are_pinned():
    """theta_j = 10000^(-2j/64); the ramp of beta 32/1 runs from j = 10
    (floor 10.47) to j = 23 (ceil 22.54): j <= 10 keep theta_j, j >= 23
    take it / 40, and between them a linear mix."""
    m = get_config(ARCH).mla
    theta = 10000.0 ** (-np.arange(32) * 2 / 64)
    ramp = np.clip((np.arange(32) - 10) / (23 - 10), 0, 1)
    want = theta / 40 * ramp + theta * (1 - ramp)
    np.testing.assert_allclose(yarn_freqs(m).numpy(), want, rtol=1e-6)
    ref = plain.rope_frequencies(published(get_config(ARCH)))
    np.testing.assert_allclose(yarn_freqs(m).numpy(), ref.numpy(), rtol=1e-6)


@pytest.mark.parametrize("mscale_all_dim", [1.0, 0.0])
def test_the_indexer_turns_halves_as_the_reference(mscale_all_dim):
    """The first qk_rope_head_dim dims turned in halves (x_j, x_j+4 at
    the smoke width), the rest as they are, against the reference."""
    cfg = get_smoke_config(ARCH)
    cfg = cfg.with_(mla=dataclasses.replace(cfg.mla,
                                            mscale_all_dim=mscale_all_dim))
    x = torch.randn(2, 5, 3, cfg.indexer.head_dim,
                    generator=torch.Generator().manual_seed(6))
    pos = torch.arange(40, 45)
    got = dsa.rope_halves(x, pos[:, None], cfg.mla)
    want = plain.rotate_halves(x, pos, published(cfg))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    r = cfg.mla.qk_rope_head_dim
    assert torch.equal(got[..., r:], x[..., r:])
    # a pair's two halves keep their norm, times YaRN's amplitude
    amp = rope_amplitude(cfg.mla)
    torch.testing.assert_close(got[..., :r // 2] ** 2 + got[..., r // 2:r]
                               ** 2, amp ** 2 * (x[..., :r // 2] ** 2
                                                 + x[..., r // 2:r] ** 2),
                               rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# The model against the reference
# ---------------------------------------------------------------------------


@pytest.fixture(params=["decode", "prompt"])
def held_path(request, monkeypatch):
    """The held experts' two arms, forced whatever the input's shape (as
    ``test_torch_kimi_k2.held_path``)."""
    import repro_torch.models.moe as moe
    decode = request.param == "decode"
    monkeypatch.setattr(moe, "_decoding", lambda x: decode)
    return request.param


def test_forward_matches_the_reference(smoke, held_path):
    cfg, model, sd = smoke
    toks = tokens(cfg, 2, 40)
    with torch.inference_mode():
        got, _ = model(toks)
    want = plain.forward(sd, published(cfg), toks)
    torch.testing.assert_close(got, want, **TOL)


def test_a_nonzero_key_norm_bias_is_applied():
    """The indexer key's LayerNorm weight and bias, drawn away from 1 and
    0, move the port and the reference alike."""
    cfg, model, sd = smoke_model(seed=2)
    gen = torch.Generator().manual_seed(9)
    with torch.no_grad():
        for blk in model.layers:
            ix = blk.attn["indexer"]
            ix["k_norm"].copy_(1 + 0.5 * torch.randn(
                ix["k_norm"].shape, generator=gen))
            ix["k_bias"].copy_(0.5 * torch.randn(ix["k_bias"].shape,
                                                 generator=gen))
    sd = model.state_dict()
    toks = tokens(cfg, 2, 30, seed=4)
    with torch.inference_mode():
        got, _ = model(toks)
    want = plain.forward(sd, published(cfg), toks)
    torch.testing.assert_close(got, want, **TOL)


def test_prefill_then_decode_past_index_topk_matches_the_reference(smoke):
    """A 20-token prompt (queries 8-19 select 8 of their positions) and 6
    decode steps through the cache ``{c, kr, ik}``: every logit, the
    prefill's included, is the reference's full forward's."""
    cfg, model, sd = smoke
    toks = tokens(cfg, 2, 26, seed=3)
    with torch.inference_mode():
        lp, cache = model.prefill(toks[:, :20], max_len=32)
        assert set(cache["layers"][0]) == {"c", "kr", "ik"}
        assert cache["layers"][0]["ik"].shape == (2, 32,
                                                  cfg.indexer.head_dim)
        got = [lp]
        for i in range(20, 26):
            logits, cache = model.decode_step(cache, toks[:, i:i + 1])
            got.append(logits)
    want = plain.forward(sd, published(cfg), toks)
    for pos, logits in zip(range(19, 26), got):
        torch.testing.assert_close(logits, want[:, pos], **TOL)


def test_the_references_probe_is_the_programs_layer_0(smoke):
    """``probe`` holds layer 0's cache as the program's prefill and decode
    wrote it, and the positions each asked-for step attended there as
    the program's decode step chose them; under ``cache_fp8`` its cache
    is the rounded one, and under ``dense`` every position is chosen."""
    cfg, model, sd = smoke
    toks = tokens(cfg, 2, 24, seed=8)
    chosen = {}
    with torch.inference_mode():
        cache = model.prefill(toks[:, :20], max_len=24)[1]
        for i in range(20, 24):
            cache = model.decode_step(cache, toks[:, i:i + 1])[1]
            chosen[i] = model.layers[0].selected[:, 0]
    probe: dict = {}
    plain.forward(sd, published(cfg), toks, positions=[21, 23],
                  probe=probe)
    for name in ("c", "kr", "ik"):
        torch.testing.assert_close(cache["layers"][0][name], probe[name],
                                   **TOL)
    assert probe["chosen"].shape == (2, 2, 24)
    for j, pos in enumerate((21, 23)):
        mine = torch.zeros(2, 24, dtype=torch.bool).scatter_(
            1, chosen[pos], True)
        assert torch.equal(mine, probe["chosen"][:, j])
    rounded: dict = {}
    plain.forward(sd, published(cfg), toks, positions=[23], probe=rounded,
                  cache_fp8=True)
    assert torch.equal(rounded["c"], plain.to_fp8(probe["c"]))
    torch.testing.assert_close(rounded["ik"], probe["ik"], **TOL)
    dense: dict = {}
    plain.forward(sd, published(cfg), toks, positions=[23], probe=dense,
                  dense=True)
    assert dense["chosen"].all()


def test_the_indexer_selects_the_references_positions(smoke):
    """Layer 1's indexer on a seeded input: the port's top-k of each query
    past ``index_topk`` is the reference's selection, position for
    position."""
    cfg, model, sd = smoke
    m, ix = cfg.mla, cfg.indexer
    p = model.layers[1].attn
    h = torch.randn(2, 30, cfg.d_model, generator=torch.Generator()
                    .manual_seed(11))
    pos = torch.arange(30)
    with torch.inference_mode():
        qr = dsa._q_latent(p, h, cfg.norm_eps)
        keys = dsa.index_keys(p["indexer"], h, pos, m)
        got = dsa.index_topk(p["indexer"], qr[:, 8:], h[:, 8:], keys, 8, m,
                             ix)
    ref = plain._group(sd, "layers.1.attn.")
    pub = published(cfg)
    ki = plain.index_keys(ref["indexer"], h, pos, pub, torch.Tensor.float)
    qi = plain.rotate_halves((qr @ ref["indexer"]["wq_b"]).view(
        2, 30, ix.n_heads, ix.head_dim), pos, pub)
    w = (h @ ref["indexer"]["w_proj"]) * (ix.n_heads * ix.head_dim) ** -0.5
    for b in range(2):
        keep = plain.selected(qi[b, 8:], w[b, 8:], ki[b], pos[8:], pub,
                              dense=False)
        mine = torch.zeros_like(keep).scatter_(1, got[b], True)
        assert torch.equal(mine, keep)
        assert (keep.sum(-1) == ix.topk).all()


def test_prefill_in_chunks_equals_one_chunk(smoke, monkeypatch):
    """Chunks of 1 and of 5 queries give the one chunk's output and
    cache (the chunk only bounds memory)."""
    cfg, model, _ = smoke
    p = model.layers[2].attn
    h = torch.randn(2, 29, cfg.d_model, generator=torch.Generator()
                    .manual_seed(12))
    with torch.inference_mode():
        want, cache = dsa.dsa_prefill(p, h, cfg.mla, cfg.indexer,
                                      eps=cfg.norm_eps)
        for rows in (1, 5):
            monkeypatch.setattr(dsa, "chunk_rows", lambda *a, r=rows: r)
            got, again = dsa.dsa_prefill(p, h, cfg.mla, cfg.indexer,
                                         eps=cfg.norm_eps)
            torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
            for name in cache:
                assert torch.equal(again[name], cache[name])


def test_chunk_rows_fit_the_budget():
    """At the cell's size (2 sessions of 32,768 tokens) a chunk holds 128
    queries: 2 x 128 x 64 x 32,768 index scores, 2^29."""
    cfg = get_config(ARCH)
    assert dsa.chunk_rows(2, 32768, cfg.mla, cfg.indexer) == 128
    assert dsa.chunk_rows(2, 4096, cfg.mla, cfg.indexer) == 227
    assert dsa.chunk_rows(10**9, 32768, cfg.mla, cfg.indexer) == 1


def test_decode_at_a_device_position_is_the_host_int_step(smoke):
    """``decode_step`` with the position a tensor (what a decode graph
    captures: the cache written by ``index_copy_``, every cached key
    scored and those past the step masked) gives the logits, cache and
    choice of the step at the host int, and counts nothing on the
    host."""
    cfg, model, _ = smoke
    toks = tokens(cfg, 2, 24, seed=9)
    with torch.inference_mode():
        mine = model.prefill(toks[:, :20], max_len=40)[1]
        theirs = model.prefill(toks[:, :20], max_len=40)[1]
        for i in range(20, 24):
            before = [blk.attended for blk in model.layers]
            got, _ = model.decode_step(dict(mine, step=torch.tensor([i])),
                                       toks[:, i:i + 1])
            assert [blk.attended for blk in model.layers] == before
            chose = [blk.selected.sort(-1).values for blk in model.layers]
            theirs["step"] = i
            want, theirs = model.decode_step(theirs, toks[:, i:i + 1])
            torch.testing.assert_close(got, want, **TOL)
            for blk, c in zip(model.layers, chose):
                assert torch.equal(c, blk.selected.sort(-1).values)
    for a, b in zip(mine["layers"], theirs["layers"]):
        for name in ("c", "kr", "ik"):
            torch.testing.assert_close(a[name], b[name], **TOL)


@pytest.mark.parametrize("arch", [ARCH, "kimi-k2-instruct"])
def test_a_decode_graph_wants_sparse_layers_on_a_card(arch):
    """Every layer sparse (a dense latent layer reads its length on the
    host), and a CUDA device."""
    from repro_torch.models.decode_graph import DecodeGraph

    cfg = get_smoke_config(arch)
    model = build_model(cfg, torch.float32, device=CPU)
    with torch.inference_mode():
        cache = model.init_cache(2, 16)
    match = "CUDA" if arch == ARCH else "SparseLatentBlock"
    with pytest.raises(ValueError, match=match):
        DecodeGraph(model, cache)


def test_decode_before_index_topk_is_dense_latent_attention(smoke):
    """While a step's positions are no more than ``index_topk``, the
    sparse step is the dense one: the same bits, the indexer's key
    written beside."""
    cfg, model, _ = smoke
    p = model.layers[1].attn
    gen = torch.Generator().manual_seed(13)
    h = torch.randn(3, 1, cfg.d_model, generator=gen)
    cache = {"c": torch.randn(3, 10, cfg.mla.kv_lora_rank, generator=gen),
             "kr": torch.randn(3, 10, cfg.mla.qk_rope_head_dim,
                               generator=gen),
             "ik": torch.zeros(3, 10, cfg.indexer.head_dim)}
    dense = {k: v.clone() for k, v in cache.items() if k != "ik"}
    with torch.inference_mode():
        got, chosen = dsa.dsa_decode(p, h, cache, 7, cfg.mla, cfg.indexer,
                                     eps=cfg.norm_eps)
        want = mla_decode(p, h, dense, 7, cfg.mla, eps=cfg.norm_eps)
    assert torch.equal(got, want) and chosen is None
    assert cache["ik"][:, 7].any() and not cache["ik"][:, 8:].any()
    with pytest.raises(ValueError):
        dsa.dsa_decode(p, h, cache, 10, cfg.mla, cfg.indexer,
                       eps=cfg.norm_eps)


def test_a_decode_step_counts_positions_attended_and_held(smoke):
    cfg, model, _ = smoke
    toks = tokens(cfg, 2, 14, seed=5)
    with torch.inference_mode():
        _, cache = model.prefill(toks[:, :5], max_len=16)
        for blk in model.layers:
            blk.attended = blk.cached = 0
        for i in range(5, 14):          # steps at positions 5 .. 13
            _, cache = model.decode_step(cache, toks[:, i:i + 1])
    lengths = range(6, 15)
    for blk in model.layers:
        assert blk.cached == 2 * sum(lengths)
        assert blk.attended == 2 * sum(min(n, 8) for n in lengths)


@pytest.mark.parametrize("fault", ["dense", "last"])
def test_a_program_that_selects_otherwise_fails_the_comparison(
        smoke, monkeypatch, fault):
    """The same prompt and steps with the program's selection replaced:
    every position attended, or each query's last ``index_topk``: its
    logits leave the reference by far more than the comparison's
    tolerance."""
    cfg, model, sd = smoke
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
    toks = tokens(cfg, 2, 26, seed=3)
    with torch.inference_mode():
        got = [model.prefill(toks[:, :20], max_len=32)[0]]
        cache = model.prefill(toks[:, :20], max_len=32)[1]
        for i in range(20, 26):
            logits, cache = model.decode_step(cache, toks[:, i:i + 1])
            got.append(logits)
    want = plain.forward(sd, published(cfg), toks)[:, 19:26]
    err = (torch.stack(got, 1) - want).abs().amax(-1) / want.abs().amax(-1)
    assert float(err.median()) > 100 * TOL["rtol"]


def test_the_dense_reference_is_far_from_the_sparse_one(smoke):
    cfg, _, sd = smoke
    toks = tokens(cfg, 2, 30, seed=6)
    want = plain.forward(sd, published(cfg), toks)
    dense = plain.forward(sd, published(cfg), toks, dense=True)
    # the first index_topk positions attend everything either way
    torch.testing.assert_close(dense[:, :8], want[:, :8], **TOL)
    err = (dense - want)[:, 8:].abs().amax(-1) / want[:, 8:].abs().amax(-1)
    assert float(err.median()) > 100 * TOL["rtol"]


def test_the_benchmarks_reference_is_this_one():
    assert (ROOT / "bench" / "reference" / "deepseek_v32.py").read_bytes() \
        == (ROOT / "tests" / "_plain_deepseek_v32.py").read_bytes()


# ---------------------------------------------------------------------------
# Group-limited routing
# ---------------------------------------------------------------------------


def _route_before_groups(router, bias, tokens, moe):
    """``route_sigmoid`` as it stood with one group: copied."""
    with _full_f32():
        logits = tokens.float() @ router.float()
    scores = torch.sigmoid(logits)
    top_e = torch.topk(scores + bias.float(), moe.top_k, dim=-1).indices
    w = scores.gather(1, top_e)
    w = w / (w.sum(-1, keepdim=True) + 1e-20) * moe.routed_scale
    return w, top_e


@pytest.mark.parametrize("arch", ["kimi-k2-instruct", ARCH])
def test_one_group_routing_is_bitwise_as_before(arch):
    cfg = get_smoke_config(arch)
    moe = dataclasses.replace(cfg.moe, n_group=1, topk_group=1)
    _, model, _ = smoke_model(cfg=cfg.with_(moe=moe))
    p = model.layers[1].moe
    x = torch.randn(64, cfg.d_model, generator=torch.Generator()
                    .manual_seed(7))
    for got, want in zip(route_sigmoid(p["router"], p["bias"], x, moe),
                         _route_before_groups(p["router"], p["bias"], x,
                                              moe)):
        assert torch.equal(got, want)


def test_group_limited_routing_equals_a_hand_written_one(smoke):
    """Per token, written out: each group's two best biased scores
    summed, the best ``topk_group`` groups kept, the top ``top_k`` biased
    scores among their experts, weights the unbiased scores there,
    normalised and scaled."""
    cfg, model, _ = smoke
    moe = cfg.moe
    p = model.layers[1].moe
    x = torch.randn(200, cfg.d_model, generator=torch.Generator()
                    .manual_seed(8))
    w, top = route_sigmoid(p["router"], p["bias"], x, moe)
    scores = torch.sigmoid(x.double() @ p["router"].double())
    biased = scores + p["bias"].double()
    size = moe.n_experts // moe.n_group
    flips = 0
    for t in range(len(x)):
        groups = sorted(range(moe.n_group), key=lambda g: -sum(sorted(
            biased[t, g * size:(g + 1) * size].tolist())[-2:]))
        allowed = [e for g in groups[:moe.topk_group]
                   for e in range(g * size, (g + 1) * size)]
        chosen = sorted(allowed, key=lambda e: -float(biased[t, e]))
        chosen = chosen[:moe.top_k]
        assert sorted(top[t].tolist()) == sorted(chosen)
        ww = scores[t, top[t]]
        torch.testing.assert_close(w[t].double(),
                                   ww / ww.sum() * moe.routed_scale,
                                   rtol=1e-6, atol=1e-6)
        # the group limit changed this token's choice
        flips += sorted(chosen) != sorted(
            torch.topk(biased[t], moe.top_k).indices.tolist())
    assert flips > 0
    assert float(((top // size)[:, :, None] == torch.arange(
        moe.n_group)).any(1).sum(-1).max()) <= moe.topk_group


@pytest.mark.parametrize("held_from", [0, 8])
def test_two_shares_of_experts_make_the_uncut_layer(held_from, held_path):
    """16 experts in 4 groups, all held, against two chips of 8 (groups
    0-1 and 2-3): each share's routed part, with the shared expert
    counted once, adds up to the uncut layer, and every slot lands on
    one share or the other."""
    base = get_smoke_config(ARCH)
    full_cfg = base.with_(moe=dataclasses.replace(base.moe, n_held=None))
    _, full, _ = smoke_model(seed=4, cfg=full_cfg)
    p = full.layers[1].moe
    x = torch.randn(2, 9, base.d_model, generator=torch.Generator()
                    .manual_seed(8))
    if held_path == "decode":
        x = x.reshape(-1, 1, base.d_model)
    want, _ = moe_block_held(p, x, full_cfg.moe)

    def share(e0, shared):
        moe = dataclasses.replace(base.moe, n_held=8, held_from=e0,
                                  n_shared_experts=1 if shared else 0)
        q = {"router": p["router"], "bias": p["bias"],
             "w_gate": p["w_gate"][e0:e0 + 8], "w_up": p["w_up"][e0:e0 + 8],
             "w_down": p["w_down"][e0:e0 + 8], "shared": p["shared"]}
        counts = torch.zeros(8, dtype=torch.long)
        out, _ = moe_block_held(q, x, moe, counts)
        return out, counts

    mine, n_mine = share(held_from, shared=True)
    other, n_other = share(8 - held_from, shared=False)
    torch.testing.assert_close(mine + other, want, **TOL)
    assert int(n_mine.sum() + n_other.sum()) == 18 * base.moe.top_k


# ---------------------------------------------------------------------------
# The cache across groups of sessions
# ---------------------------------------------------------------------------


def test_join_caches_carries_the_indexer_key(smoke):
    cfg, model, _ = smoke
    toks = tokens(cfg, 3, 12, seed=9)
    with torch.inference_mode():
        _, whole = model.prefill(toks, max_len=16)
        parts = [model.prefill(toks[:2], max_len=12)[1],
                 model.prefill(toks[2:], max_len=12)[1]]
        joined = join_caches(parts, max_len=16)
        for a, b in zip(joined["layers"], whole["layers"]):
            assert set(a) == set(b) == {"c", "kr", "ik"}
            for name in a:
                assert a[name].shape == b[name].shape
                torch.testing.assert_close(a[name], b[name], **TOL)
                assert not a[name][:, 12:].any()
        la, _ = model.decode_step(joined, toks[:, :1])
        lb, _ = model.decode_step(whole, toks[:, :1])
    torch.testing.assert_close(la, lb, **TOL)
    kimi_like = [{"layers": [{k: v for k, v in layer.items() if k != "ik"}
                             for layer in parts[0]["layers"]], "step": 12},
                 parts[1]]
    with pytest.raises(ValueError):
        join_caches(kimi_like, max_len=16)
