"""The port's ``kimi-k2-instruct`` (latent attention, sigmoid-routed held
experts, a shared expert, a dense first layer) against the plain
reference ``tests/_plain_kimi_k2.py``, on its smoke config in f32.

Tolerances: the port and the reference both compute in f32 from the
same weights, in other orders (SDPA against explicit scores, the
absorbed decode against expanded keys), so a logit differs by rounding
alone: 1e-4 of the largest.  The port's own cache against the full
forward is held to ``test_prefill_decode_consistency``'s 5e-3.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

import _plain_kimi_k2 as plain
import repro_torch.launch.serve as port_launch
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import build_model, join_caches
from repro_torch.models.mla import (
    mla_decode,
    mla_prefill,
    softmax_scale,
    yarn_freqs,
)
from repro_torch.models.moe import _decoding as picks_decode
from repro_torch.models.moe import moe_block_held, route_sigmoid

ARCH = "kimi-k2-instruct"
CPU = torch.device("cpu")
TOL = dict(rtol=1e-4, atol=1e-4)
SELF = dict(rtol=5e-3, atol=5e-3)


def published(cfg) -> dict:
    """The config as the published ``config.json`` names it (the
    reference's input); ``experts_held_from`` beside it."""
    m, e = cfg.mla, cfg.moe
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
        "n_shared_experts": e.n_shared_experts, "n_group": 1,
        "topk_group": 1, "first_k_dense_replace": cfg.first_dense,
        "rms_norm_eps": cfg.norm_eps, "experts_held_from": e.held_from}


@pytest.fixture(scope="module")
def smoke():
    cfg = get_smoke_config(ARCH)
    model = build_model(cfg, torch.float32, device=CPU)
    sd = model.init(torch.Generator().manual_seed(0))
    return cfg, model, sd


def tokens(cfg, b, s, seed=1):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.integers(0, cfg.vocab, (b, s)))


def test_config_is_the_published_one():
    cfg = get_config(ARCH)
    m, e = cfg.mla, cfg.moe
    assert (cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.vocab) == \
        (61, 7168, 18432, 163840)
    assert (m.n_heads, m.q_lora_rank, m.kv_lora_rank, m.qk_nope_head_dim,
            m.qk_rope_head_dim, m.v_head_dim) == (64, 1536, 512, 128, 64, 128)
    assert (e.n_experts, e.top_k, e.d_expert, e.n_shared_experts,
            e.scoring, e.routed_scale, e.held) == \
        (384, 8, 2048, 1, "sigmoid", 2.827, 384)
    assert cfg.first_dense == 1 and not cfg.tie_embeddings
    assert softmax_scale(m) == pytest.approx(
        192 ** -0.5 * (0.1 * math.log(32) + 1) ** 2)
    assert softmax_scale(m) == pytest.approx(0.13086, abs=1e-5)


@pytest.mark.parametrize("smoke_cfg", [False, True])
def test_param_count_is_every_weight(smoke_cfg):
    cfg = get_smoke_config(ARCH) if smoke_cfg else get_config(ARCH)
    sd = build_model(cfg, torch.bfloat16, device="meta").state_dict()
    assert cfg.param_count() == sum(v.numel() for v in sd.values())
    cut = cfg.with_(n_layers=5 if not smoke_cfg else 2,
                    moe=dataclasses.replace(cfg.moe, n_held=8))
    sd = build_model(cut, torch.bfloat16, device="meta").state_dict()
    assert cut.param_count() == sum(v.numel() for v in sd.values())
    if not smoke_cfg:
        assert cut.param_count() == pytest.approx(4.847e9, rel=1e-3)


def test_yarn_frequencies_are_pinned():
    """theta_j = 50000^(-2j/64); j <= 19 keep it, j >= 20 take it / 32
    (the ramp's low = floor(19.17) = 19, high = ceil(19.17) = 20)."""
    m = get_config(ARCH).mla
    theta = 50000.0 ** (-np.arange(32) * 2 / 64)
    want = np.where(np.arange(32) <= 19, theta, theta / 32)
    np.testing.assert_allclose(yarn_freqs(m).numpy(), want, rtol=1e-6)
    ref = plain.rope_frequencies(published(get_config(ARCH)))
    np.testing.assert_allclose(yarn_freqs(m).numpy(), ref.numpy(), rtol=1e-6)


@pytest.mark.parametrize("mscale_all_dim", [1.0, 0.0])
def test_rope_turns_pairs_as_the_reference(mscale_all_dim):
    """Adjacent pairs turned by position x frequency, times YaRN's
    amplitude mscale / mscale_all_dim (1 at Kimi-K2's 1/1, ~1.35 at
    1/0), against the reference's complex rotation."""
    from repro_torch.models.mla import rope_pairs
    cfg = get_smoke_config(ARCH)
    cfg = cfg.with_(mla=dataclasses.replace(cfg.mla,
                                            mscale_all_dim=mscale_all_dim))
    x = torch.randn(2, 5, 3, cfg.mla.qk_rope_head_dim,
                    generator=torch.Generator().manual_seed(6))
    pos = torch.arange(40, 45)
    got = rope_pairs(x, pos[:, None], cfg.mla)
    want = plain.rotate(x, pos, published(cfg))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_forward_matches_the_reference(smoke, held_path):
    cfg, model, sd = smoke
    toks = tokens(cfg, 2, 12)
    with torch.inference_mode():
        got, _ = model(toks)
    want = plain.forward(sd, published(cfg), toks)
    torch.testing.assert_close(got, want, **TOL)


def test_prefill_then_two_decode_steps_match_the_reference(smoke,
                                                           held_path):
    cfg, model, sd = smoke
    toks = tokens(cfg, 2, 10, seed=3)
    with torch.inference_mode():
        lp, cache = model.prefill(toks[:, :8], max_len=16)
        assert set(cache["layers"][0]) == {"c", "kr"}
        assert cache["layers"][0]["c"].shape == (2, 16, cfg.mla.kv_lora_rank)
        l1, cache = model.decode_step(cache, toks[:, 8:9])
        l2, cache = model.decode_step(cache, toks[:, 9:10])
    want = plain.forward(sd, published(cfg), toks)
    for got, pos in ((lp, 7), (l1, 8), (l2, 9)):
        torch.testing.assert_close(got, want[:, pos], **SELF)
        torch.testing.assert_close(got, want[:, pos], **TOL)


def test_absorbed_decode_equals_the_expanded_form(smoke):
    """The decode of the last position through the latent cache equals
    the expanded form's last position, layer 1's weights."""
    cfg, model, _ = smoke
    p = model.layers[1].attn
    h = torch.randn(3, 7, cfg.d_model, generator=torch.Generator()
                    .manual_seed(5))
    with torch.inference_mode():
        out, c, kr = mla_prefill(p, h, cfg.mla, eps=cfg.norm_eps)
        cache = {"c": torch.zeros(3, 9, cfg.mla.kv_lora_rank),
                 "kr": torch.zeros(3, 9, cfg.mla.qk_rope_head_dim)}
        cache["c"][:, :6] = c[:, :6]
        cache["kr"][:, :6] = kr[:, :6]
        got = mla_decode(p, h[:, 6:7], cache, 6, cfg.mla, eps=cfg.norm_eps)
        # the step wrote its own latent and key, and nothing past them
        torch.testing.assert_close(cache["c"][:, 6], c[:, 6], **TOL)
        assert not cache["c"][:, 7:].any()
        with pytest.raises(ValueError):
            mla_decode(p, h[:, :1], cache, 9, cfg.mla, eps=cfg.norm_eps)
    torch.testing.assert_close(got[:, 0], out[:, 6], **TOL)


def test_router_matches_the_reference_and_the_bias_moves_choices(smoke):
    cfg, model, _ = smoke
    p = model.layers[1].moe
    x = torch.randn(64, cfg.d_model, generator=torch.Generator()
                    .manual_seed(7))
    w, top = route_sigmoid(p["router"], p["bias"], x, cfg.moe)
    scores = torch.sigmoid(x.double() @ p["router"].double())
    want = torch.topk(scores + p["bias"].double(), cfg.moe.top_k).indices
    assert torch.equal(top, want)
    ww = scores.gather(1, want)
    ww = ww / ww.sum(-1, keepdim=True) * 2.827
    torch.testing.assert_close(w.double(), ww, rtol=1e-6, atol=1e-6)
    unbiased = torch.topk(scores, cfg.moe.top_k).indices
    assert not torch.equal(top.sort(-1).values, unbiased.sort(-1).values)


@pytest.fixture(params=["decode", "prompt"])
def held_path(request, monkeypatch):
    """The held experts' two arms, named by the input each serves: a
    decode step's (B, 1, d), slot lists built on the device and
    ``held_expert_ffn`` (its plain version here), or a prompt's (B, S, d),
    the chosen slots gathered after one host read.  The arm is forced
    whatever the input's shape, so a model's prompt and steps take it
    too; ``shaped`` gives a layer's input the arm's own shape."""
    import repro_torch.models.moe as moe
    decode = request.param == "decode"
    monkeypatch.setattr(moe, "_decoding", lambda x: decode)
    return request.param


def shaped(x, held_path):
    """``x`` (B, S, d) as the arm's input: one token a row for a decode
    step, as it is for a prompt; the shape alone picks that arm."""
    if held_path == "decode":
        x = x.reshape(-1, 1, x.shape[-1])
    assert picks_decode(x) == (held_path == "decode")
    return x


def test_the_held_paths_agree(held_path):
    """Each path against the other's arithmetic written out here: the
    held experts' SwiGLU on the tokens that chose them, weighted."""
    cfg = get_smoke_config(ARCH)
    model = build_model(cfg, torch.float32, device=CPU)
    model.init(torch.Generator().manual_seed(14))
    p, moe = model.layers[2].moe, cfg.moe
    x = shaped(torch.randn(3, 7, cfg.d_model, generator=torch.Generator()
                           .manual_seed(15)), held_path)
    got, _ = moe_block_held(p, x, moe)
    toks = x.reshape(-1, cfg.d_model)
    w, top = route_sigmoid(p["router"], p["bias"], toks, moe)
    want = torch.zeros_like(toks)
    for i in range(toks.shape[0]):
        for j in range(moe.top_k):
            e = int(top[i, j])
            if e < moe.held:
                h = torch.nn.functional.silu(toks[i] @ p["w_gate"][e]) \
                    * (toks[i] @ p["w_up"][e])
                want[i] += w[i, j] * (h @ p["w_down"][e])
    sp = p["shared"]
    want += (torch.nn.functional.silu(toks @ sp["w_gate"])
             * (toks @ sp["w_up"])) @ sp["w_down"]
    torch.testing.assert_close(got.reshape(-1, cfg.d_model), want, **TOL)


@pytest.mark.parametrize("held_from", [0, 8])
def test_two_shares_of_experts_make_the_uncut_layer(held_from, held_path):
    """16 experts all held, against two chips of 8: each share's routed
    part, plus the shared expert counted once, is the uncut layer."""
    base = get_smoke_config(ARCH)
    full_cfg = base.with_(moe=dataclasses.replace(base.moe, n_held=None))
    full = build_model(full_cfg, torch.float32, device=CPU)
    full.init(torch.Generator().manual_seed(4))
    p = full.layers[1].moe
    x = shaped(torch.randn(2, 9, base.d_model, generator=torch.Generator()
                           .manual_seed(8)), held_path)
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
    # every token's k slots land on one share or the other
    assert int(n_mine.sum() + n_other.sum()) == 18 * base.moe.top_k


def test_join_caches_along_the_batch(smoke):
    cfg, model, _ = smoke
    toks = tokens(cfg, 3, 6, seed=9)
    with torch.inference_mode():
        _, whole = model.prefill(toks, max_len=10)
        parts = [model.prefill(toks[:2], max_len=6)[1],
                 model.prefill(toks[2:], max_len=6)[1]]
        joined = join_caches(parts, max_len=10)
        assert joined["step"] == whole["step"] == 6
        for a, b in zip(joined["layers"], whole["layers"]):
            assert set(a) == set(b) == {"c", "kr"}
            for name in a:
                assert a[name].shape == b[name].shape
                torch.testing.assert_close(a[name], b[name], **TOL)
        la, _ = model.decode_step(joined, toks[:, :1])
        lb, _ = model.decode_step(whole, toks[:, :1])
    torch.testing.assert_close(la, lb, **TOL)
    with pytest.raises(ValueError):
        join_caches([parts[0], {"layers": parts[1]["layers"], "step": 5}],
                    max_len=10)


def test_launcher_serves_the_model_with_the_coded_head(capsys):
    args = port_launch.parse_args(
        ["--arch", ARCH, "--smoke", "--device", "cpu", "--coded",
         "--requests", "2", "--max-new", "3"])
    cfg, _, params, engine = port_launch.build(args)
    rng = np.random.default_rng(args.seed)
    out = port_launch.serve(engine, port_launch.make_requests(args, cfg, rng))
    assert [len(r.output) for r in out] == [3, 3]
    assert port_launch.check_coded_head(args, cfg, params, engine, rng) < 1e-4
    assert "served 2 requests, 6 tokens" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# The softmax path and CodedMoE, bitwise as before sigmoid routing came
# ---------------------------------------------------------------------------
# the pre-change formulas, copied here as they stood: routing, slotting,
# dispatch, the batched experts and the combine in slot order


def _old_route(router, tokens, moe, cap):
    import torch.nn.functional as F
    t = tokens.shape[0]
    e, k = moe.n_experts, moe.top_k
    dev = tokens.device
    logits = torch.einsum("td,de->te", tokens.float(), router.float())
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.topk(probs, k, dim=-1)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    frac_tokens = F.one_hot(top_e[:, 0], e).float().mean(dim=0)
    aux = e * torch.sum(frac_tokens * probs.mean(dim=0))
    fe = top_e.reshape(-1)
    fp = top_p.reshape(-1)
    tok_id = torch.arange(t, device=dev).repeat_interleave(k)
    order = torch.argsort(fe, stable=True)
    counts = torch.zeros(e, dtype=fe.dtype, device=dev).scatter_add(
        0, fe, torch.ones_like(fe))
    starts = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)[:-1]])
    ranks = torch.arange(t * k, device=dev) - starts[fe[order]]
    pos = torch.zeros(t * k, dtype=torch.long, device=dev)
    pos[order] = ranks
    keep = pos < cap
    dest = torch.where(keep, fe * cap + pos, e * cap)
    return aux, fp, tok_id, keep, dest


def _old_dispatch(tokens, tok_id, dest, e, cap):
    buf = tokens.new_zeros((e * cap + 1, tokens.shape[1]))
    buf[dest] = tokens[tok_id]
    return buf[: e * cap].reshape(e, cap, tokens.shape[1])


def _old_combine(ye, fp, tok_id, keep, dest, t, dtype):
    n_slots = ye.shape[0] * ye.shape[1]
    y_flat = ye.reshape(n_slots, -1)
    y_slot = torch.where(keep[:, None],
                         y_flat[torch.clamp(dest, max=n_slots - 1)],
                         torch.zeros((), dtype=y_flat.dtype))
    slots = (y_slot * fp[:, None].to(dtype)).reshape(t, -1, y_flat.shape[1])
    out = slots[:, 0]
    for j in range(1, slots.shape[1]):
        out = out + slots[:, j]
    return out


def _old_shared(sp, tokens):
    import torch.nn.functional as F
    gs = torch.einsum("td,dh->th", tokens, sp["w_gate"])
    us = torch.einsum("td,dh->th", tokens, sp["w_up"])
    return torch.einsum("th,hd->td", F.silu(gs) * us, sp["w_down"])


def _old_moe_block(p, x, moe):
    import torch.nn.functional as F
    from repro_torch.models.moe import _capacity
    b, s, d = x.shape
    t = b * s
    e = moe.n_experts
    cap = _capacity(t, moe)
    tokens = x.reshape(t, d)
    aux, fp, tok_id, keep, dest = _old_route(p["router"], tokens, moe, cap)
    xe = _old_dispatch(tokens, tok_id, dest, e, cap)
    g = torch.einsum("ecd,edh->ech", xe, p["w_gate"])
    u = torch.einsum("ecd,edh->ech", xe, p["w_up"])
    ye = torch.einsum("ech,ehd->ecd", F.silu(g) * u, p["w_down"])
    out = _old_combine(ye, fp, tok_id, keep, dest, t, x.dtype)
    if moe.n_shared_experts:
        out = out + _old_shared(p["shared"], tokens)
    return out.reshape(b, s, d), aux


def _softmax_layer(arch, shared, dtype):
    cfg = get_smoke_config(arch)
    if shared:
        cfg = cfg.with_(moe=dataclasses.replace(cfg.moe, n_shared_experts=1))
    model = build_model(cfg, dtype, device=CPU)
    model.init(torch.Generator().manual_seed(12))
    x = torch.randn(2, 16, cfg.d_model, generator=torch.Generator()
                    .manual_seed(13)).to(dtype)
    return cfg, model.layers[1].moe, x


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "kimi-k2-1t-a32b"])
def test_softmax_moe_block_is_bitwise_as_before(arch, shared, dtype):
    from repro_torch.models.moe import moe_apply, moe_block
    cfg, p, x = _softmax_layer(arch, shared, dtype)
    assert "bias" not in p and p["w_gate"].shape[0] == cfg.moe.n_experts
    want, want_aux = _old_moe_block(p, x, cfg.moe)
    for fn in (moe_block, moe_apply):
        got, aux = fn(p, x, cfg.moe)
        assert torch.equal(got, want) and torch.equal(aux, want_aux)


@pytest.mark.parametrize("shared", [False, True])
def test_coded_moe_is_bitwise_as_before(shared):
    """``CodedMoE`` on granite's smoke layer: the pre-change routing,
    dispatch and combine around the same plans give its output bit for
    bit, under no mask and under a straggler mask."""
    import torch.nn.functional as F
    from repro_torch.models.moe import CodedMoE, _capacity
    cfg, p, x = _softmax_layer("granite-moe-1b-a400m", shared, torch.float32)
    cm = CodedMoE(p, cfg.moe, n_workers=6, stragglers=2, backend="packed")
    moe = cfg.moe
    b, s, d = x.shape
    t = b * s
    cap = _capacity(t, moe)
    tokens = x.reshape(t, d)
    for done in (None, np.array([1, 0, 1, 1, 0, 1], bool)):
        aux, fp, tok_id, keep, dest = _old_route(p["router"], tokens, moe,
                                                 cap)
        xe = _old_dispatch(tokens, tok_id, dest, moe.n_experts, cap)
        outs = []
        for i in range(moe.n_experts):
            g = cm.gate[i].matvec(xe[i], done)
            u = cm.up[i].matvec(xe[i], done)
            outs.append(cm.down[i].matvec((F.silu(g) * u).to(xe.dtype),
                                          done))
        ye = torch.stack(outs).to(x.dtype)
        want = _old_combine(ye, fp, tok_id, keep, dest, t, x.dtype)
        if moe.n_shared_experts:
            want = want + _old_shared(p["shared"], tokens)
        got, got_aux = cm(x, done)
        assert torch.equal(got, want.reshape(b, s, d))
        assert torch.equal(got_aux, aux)
