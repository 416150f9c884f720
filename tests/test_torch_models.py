"""The port's dense model against the JAX package's: layers, the whole
``TransformerLM`` (forward, prefill with every cache tensor, decode
steps); every family's weight conversion both ways, parameter count and
decode specs (the families' numerics: ``tests/test_torch_families.py``).

Weights cross from JAX through ``model_params_from_reference`` as numpy
arrays; inputs come from a numpy seed.  f32 is held to the reference's
2e-5 (``tests/test_kernels.py:27-28``), bf16 to 2e-2.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
import repro.models as ref_models
import repro.models.layers as ref_layers
import repro_torch.configs as port_configs
import repro_torch.models.layers as port_layers
from repro_torch.convert import (
    model_params_from_reference,
    model_params_to_reference,
)
from repro_torch.models import (
    TransformerLM,
    build_model,
    decode_specs,
    prefill_specs,
    supports_shape,
    train_batch_specs,
)

TOL = dict(rtol=2e-5, atol=2e-5)
TOL_BF16 = dict(rtol=2e-2, atol=2e-2)
DENSE = ["phi3-mini-3.8b", "qwen3-14b", "gemma3-12b"]
CPU = torch.device("cpu")


def t(x):
    return torch.as_tensor(np.asarray(x))


def close(port, ref, tol=TOL):
    np.testing.assert_allclose(port.detach().float().numpy(),
                               np.asarray(ref, np.float32), **tol)


def pair(arch, dtype=jnp.float32, **overrides):
    """(jax model, jax params, port model) on the same weights."""
    cfg = ref_configs.get_smoke_config(arch).with_(**overrides)
    jm = ref_models.build_model(cfg, dtype=dtype)
    jp = jm.init(jax.random.key(0))
    pcfg = port_configs.get_smoke_config(arch).with_(**overrides)
    pm = build_model(pcfg, torch.float32 if dtype == jnp.float32
                     else torch.bfloat16, device=CPU)
    pm.load_state_dict(model_params_from_reference(
        jax.tree.map(np.asarray, jp), pcfg, device=CPU))
    return jm, jp, pm


# ---------------------------------------------------------------------------
# Configs are the same data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ref_configs.ARCH_IDS)
def test_configs_equal(arch):
    for get in ("get_config", "get_smoke_config"):
        ref = getattr(ref_configs, get)(arch)
        port = getattr(port_configs, get)(arch)
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert port.pattern == ref.pattern
        assert port.n_groups == ref.n_groups
        assert port.param_count() == ref.param_count()
        assert port.active_param_count() == ref.active_param_count()
    assert all(
        dataclasses.asdict(port_configs.SHAPES[k])
        == dataclasses.asdict(ref_configs.SHAPES[k])
        for k in ref_configs.SHAPES)


def test_pattern_rule_rejects_ragged_layers():
    cfg = port_configs.get_smoke_config("gemma3-12b").with_(n_layers=5)
    with pytest.raises(ValueError, match="not a multiple of pattern"):
        cfg.n_groups


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype,tol", [(np.float32, TOL),
                                       (jnp.bfloat16, TOL_BF16)])
def test_rms_norm_swiglu_gelu(dtype, tol):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 16)).astype(dtype)
    w = (1 + 0.1 * rng.standard_normal(16)).astype(dtype)
    # the model's init scales, so bf16 rounds values of the model's size
    wg, wu = ((rng.standard_normal((16, 24)) * 16 ** -0.5).astype(dtype)
              for _ in range(2))
    wd = (rng.standard_normal((24, 16)) * 24 ** -0.5).astype(dtype)
    tx, tw = (torch.from_numpy(np.asarray(a, np.float32)) for a in (x, w))
    if dtype != np.float32:
        tx, tw = tx.bfloat16(), tw.bfloat16()
    tg, tu, td = (torch.from_numpy(np.asarray(a, np.float32)).to(tx.dtype)
                  for a in (wg, wu, wd))
    close(port_layers.rms_norm(tx, tw, 1e-6),
          ref_layers.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6), tol)
    close(port_layers.swiglu(tx, tg, tu, td),
          ref_layers.swiglu(jnp.asarray(x), wg, wu, wd), tol)
    close(port_layers.gelu_mlp(tx, tu, td),
          ref_layers.gelu_mlp(jnp.asarray(x), wu, wd), tol)


def test_sinusoidal_positions_bitwise():
    np.testing.assert_array_equal(port_layers.sinusoidal_positions(17, 12),
                                  ref_layers.sinusoidal_positions(17, 12))


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_rope(theta):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 100, (2, 7))
    close(port_layers.rope(t(x), t(pos), theta),
          ref_layers.rope(jnp.asarray(x), jnp.asarray(pos), theta))


def qkv(rng, b, s, h, kv, d, dtype=np.float32):
    return [rng.standard_normal(shape).astype(dtype)
            for shape in ((b, s, h, d), (b, s, kv, d), (b, s, kv, d))]


@pytest.mark.parametrize("h,kv", [(4, 4), (4, 2), (6, 1)])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 3),
                                           (False, None)])
def test_attention_plain(h, kv, causal, window):
    rng = np.random.default_rng(h + kv)
    q, k, v = qkv(rng, 2, 9, h, kv, 8)
    pos = np.arange(9)
    close(port_layers.attention_plain(t(q), t(k), t(v), t(pos), t(pos),
                                      causal=causal, window=window),
          ref_layers.attention_plain(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), jnp.asarray(pos),
                                     jnp.asarray(pos), causal=causal,
                                     window=window))


def test_attention_plain_bf16_keeps_f32_scores():
    rng = np.random.default_rng(5)
    q, k, v = (jnp.asarray(a, jnp.bfloat16) for a in qkv(rng, 2, 9, 4, 2, 8))
    pos = np.arange(9)
    ref = ref_layers.attention_plain(q, k, v, jnp.asarray(pos),
                                     jnp.asarray(pos))
    port = port_layers.attention_plain(
        *(t(np.asarray(a, np.float32)).bfloat16() for a in (q, k, v)),
        t(pos), t(pos))
    assert port.dtype == torch.bfloat16
    close(port, np.asarray(ref, np.float32), TOL_BF16)


@pytest.mark.parametrize("s,chunk", [(16, 4), (12, 4), (8, 8)])
@pytest.mark.parametrize("window", [None, 5])
def test_attention_chunked(s, chunk, window):
    rng = np.random.default_rng(s + chunk)
    q, k, v = qkv(rng, 2, s, 4, 2, 8)
    close(port_layers.attention_chunked(t(q), t(k), t(v), window=window,
                                        chunk=chunk),
          ref_layers.attention_chunked(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), window=window,
                                       chunk=chunk))


@pytest.mark.parametrize("window", [None, 4])
def test_attention_decode_ring_wraps(window):
    """Ten decode steps into a cache of length 6 (window 4 wraps the ring
    twice over); every step's output and the cache after it."""
    a = port_configs.base.AttnConfig(n_heads=4, n_kv_heads=2, head_dim=8,
                                     qk_norm=True, window=window)
    ra = ref_configs.base.AttnConfig(n_heads=4, n_kv_heads=2, head_dim=8,
                                     qk_norm=True, window=window)
    rng = np.random.default_rng(7)
    shapes = port_layers.attn_param_shapes(16, a)
    p = {n: rng.standard_normal(sh).astype(np.float32) * 0.3
         for n, sh in shapes.items()}
    pp = {n: t(x) for n, x in p.items()}
    rc = ref_layers.init_kv_cache(2, 6, ra, window)
    pc = port_layers.init_kv_cache(2, 6, a, window)
    for step in range(10):
        x = rng.standard_normal((2, 1, 16)).astype(np.float32)
        ry, rc = ref_layers.attention_decode(p, jnp.asarray(x), rc,
                                             jnp.asarray(step), ra, eps=1e-6,
                                             window=window)
        py, pc = port_layers.attention_decode(pp, t(x), pc, step, a,
                                              eps=1e-6, window=window)
        close(py, ry)
        close(pc["k"], rc["k"])
        close(pc["v"], rc["v"])


def test_attention_block_matches():
    cfg = port_configs.get_smoke_config("qwen3-14b")
    rng = np.random.default_rng(3)
    shapes = port_layers.attn_param_shapes(cfg.d_model, cfg.attn)
    p = {n: rng.standard_normal(sh).astype(np.float32) * 0.2
         for n, sh in shapes.items()}
    x = rng.standard_normal((2, 8, cfg.d_model)).astype(np.float32)
    ref_cfg = ref_configs.get_smoke_config("qwen3-14b")
    for impl in ("auto", "chunked"):
        close(port_layers.attention_block(
            {n: t(v) for n, v in p.items()}, t(x), cfg.attn, eps=1e-6,
            impl=impl, chunk=4),
              ref_layers.attention_block(p, jnp.asarray(x), ref_cfg.attn,
                                         eps=1e-6, impl=impl, chunk=4))


# ---------------------------------------------------------------------------
# The whole model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", DENSE)
def test_forward_matches(arch):
    jm, jp, pm = pair(arch)
    toks = np.random.default_rng(0).integers(0, pm.cfg.vocab, (2, 12))
    rl, raux = jm.forward(jp, jnp.asarray(toks))
    pl, paux = pm(t(toks))
    assert pl.shape == (2, 12, pm.cfg.vocab) and pl.dtype == torch.float32
    close(pl, rl)
    close(paux, raux)


@pytest.mark.parametrize("arch", DENSE)
@pytest.mark.parametrize("impl", ["auto", "chunked"])
def test_prefill_and_decode_match(arch, impl):
    """Prefill logits and every cache tensor, then three decode steps.
    gemma3's window is 8 and the prompt 12 tokens long, so its local
    layers' ring is already wrapped at prefill."""
    jm, jp, pm = pair(arch, attn_impl=impl, attn_chunk=4)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, pm.cfg.vocab, (2, 12))
    rl, rc = jm.prefill(jp, jnp.asarray(toks), max_len=32)
    pl, pc = pm.prefill(t(toks), max_len=32)
    close(pl, rl)
    assert pc["step"] == int(rc["step"]) == 12
    p = len(pm.cfg.pattern)
    for layer, c in enumerate(pc["layers"]):
        g, i = divmod(layer, p)
        for name in ("k", "v"):
            ref = np.asarray(rc["layers"][f"l{i}"][name][g])
            assert tuple(c[name].shape) == ref.shape
            close(c[name], ref)
    for _ in range(3):
        nxt = rng.integers(0, pm.cfg.vocab, (2, 1))
        rl, rc = jm.decode_step(jp, rc, jnp.asarray(nxt))
        pl, pc = pm.decode_step(pc, t(nxt))
        close(pl, rl)
    assert pc["step"] == int(rc["step"]) == 15


def test_bf16_forward_matches():
    jm, jp, pm = pair("qwen3-14b", dtype=jnp.bfloat16)
    toks = np.random.default_rng(2).integers(0, pm.cfg.vocab, (2, 10))
    rl, _ = jm.forward(jp, jnp.asarray(toks))
    pl, _ = pm(t(toks))
    close(pl, rl, TOL_BF16)
    rl, _ = jm.prefill(jp, jnp.asarray(toks), max_len=16)
    pl, _ = pm.prefill(t(toks), max_len=16)
    close(pl, rl, TOL_BF16)


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_decode_consistent_with_forward(arch):
    """The port's own cache against its own forward (the reference's
    ``test_prefill_decode_consistency``)."""
    cfg = port_configs.get_smoke_config(arch)
    model = build_model(cfg, torch.float32, device=CPU)
    model.init(torch.Generator().manual_seed(0))
    toks = t(np.random.default_rng(2).integers(0, cfg.vocab, (2, 10)))
    lp, cache = model.prefill(toks[:, :8], max_len=32)
    l1, cache = model.decode_step(cache, toks[:, 8:9])
    l2, cache = model.decode_step(cache, toks[:, 9:10])
    full, _ = model(toks)
    for got, ref in ((lp, full[:, 7]), (l1, full[:, 8]), (l2, full[:, 9])):
        torch.testing.assert_close(got, ref, **TOL)


LM_ARCHS = [a for a in port_configs.ARCH_IDS
            if port_configs.get_smoke_config(a).family != "audio"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_init_cache_matches_what_prefill_builds(arch, dtype):
    """Each layer's empty cache has the keys, shapes and dtypes of the
    one its prefill builds (12 tokens: past the window of gemma3's ring
    layers), and a decode step runs from the empty cache at step 0."""
    cfg = port_configs.get_smoke_config(arch)
    model = build_model(cfg, dtype, device=CPU)
    model.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(3)
    img = (t(rng.standard_normal((2, cfg.vision_tokens, cfg.d_model)))
           if cfg.vision_tokens else None)
    toks = t(rng.integers(0, cfg.vocab, (2, 12)))
    with torch.no_grad():
        _, built = model.prefill(toks, max_len=24, image_embeds=img)
        empty = model.init_cache(2, 24)
        assert empty["step"] == 0
        assert len(empty["layers"]) == len(built["layers"]) == cfg.n_layers
        for i, (e, b) in enumerate(zip(empty["layers"], built["layers"])):
            assert set(e) == set(b), i
            for name in e:
                assert e[name].shape == b[name].shape, (i, name)
                assert e[name].dtype == b[name].dtype, (i, name)
                assert not e[name].any(), (i, name)
        logits, after = model.decode_step(empty, toks[:, :1])
    assert logits.shape == (2, cfg.vocab)
    assert torch.isfinite(logits).all() and after["step"] == 1


# ---------------------------------------------------------------------------
# Init, conversion, the API around the model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", DENSE)
def test_init_layout_and_scales(arch):
    """Same tree as the reference's init, the same dtypes, and the
    reference's scales; the same generator seed draws the same weights."""
    cfg = port_configs.get_smoke_config(arch)
    jp = ref_models.build_model(ref_configs.get_smoke_config(arch),
                                dtype=jnp.bfloat16).init(jax.random.key(0))
    model = build_model(cfg, torch.bfloat16, device=CPU)
    sd = model.init(torch.Generator().manual_seed(3))
    back = model_params_to_reference(sd, cfg)
    assert jax.tree.structure(back) == jax.tree.structure(jp)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        assert a.shape == b.shape and a.dtype == b.dtype
    assert torch.all(sd["final_norm"] == 1)
    emb = sd["embed"].float()
    assert abs(float(emb.std()) - 0.02) < 2e-3
    wq = sd["layers.0.attn.wq"].float()
    assert abs(float(wq.std()) - cfg.d_model ** -0.5) < 0.02
    wd = sd["layers.0.mlp.w_down"].float()
    assert abs(float(wd.std()) - cfg.d_ff ** -0.5) < 0.02
    again = build_model(cfg, torch.bfloat16, device=CPU).init(
        torch.Generator().manual_seed(3))
    assert all(torch.equal(sd[k], again[k]) for k in sd)


@pytest.mark.parametrize("arch", ref_configs.ARCH_IDS)
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_params_round_trip_bit_exact(arch, dtype):
    """Every family's tree (MoE experts and router, mamba layers, the
    hybrid's shared block, whisper's encoder and cross attention) crosses
    both ways bit for bit."""
    cfg = ref_configs.get_smoke_config(arch)
    jp = jax.tree.map(np.asarray, ref_models.build_model(
        cfg, dtype=dtype).init(jax.random.key(1)))
    pcfg = port_configs.get_smoke_config(arch)
    sd = model_params_from_reference(jp, pcfg, device=CPU)
    model = build_model(pcfg, torch.float32 if dtype == jnp.float32
                        else torch.bfloat16, device=CPU)
    assert set(sd) == set(model.state_dict())
    assert all(sd[k].dtype == v.dtype for k, v in model.state_dict().items())
    model.load_state_dict(sd)
    back = model_params_to_reference(model.state_dict(), pcfg)
    assert jax.tree.structure(back) == jax.tree.structure(jp)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))
    again = model_params_from_reference(back, pcfg, device=CPU)
    assert all(torch.equal(sd[k].view(torch.uint8), again[k].view(torch.uint8))
               for k in sd)


# the families that raised until they were ported keep this test's name
# and case ids, so its history stays one test
@pytest.mark.parametrize("arch", [a for a in ref_configs.ARCH_IDS
                                  if ref_configs.get_config(a).family
                                  != "dense"])
def test_unported_families_raise(arch):
    """No family raises now: each builds on the CPU, with the JAX
    model's parameter count on the same smoke config, and draws its
    weights."""
    cfg = port_configs.get_smoke_config(arch)
    model = build_model(cfg, torch.float32, device=CPU)
    assert model.device.type == "cpu"
    jp = ref_models.build_model(ref_configs.get_smoke_config(arch),
                                dtype=jnp.float32).param_specs()
    n_ref = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(jp))
    assert sum(p.numel() for p in model.parameters()) == n_ref
    sd = model.init(torch.Generator().manual_seed(0))
    assert all(torch.isfinite(v.float()).all() for v in sd.values())
    if cfg.family != "audio":
        assert isinstance(TransformerLM(cfg, device=CPU), TransformerLM)


def test_build_model_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = port_configs.get_smoke_config("phi3-mini-3.8b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(cfg)
    assert build_model(cfg, device="cpu").device.type == "cpu"


def spec_shapes(tree):
    return jax.tree.map(lambda s: (tuple(s.shape), str(s.dtype)), tree)


def port_spec(x):
    return (tuple(x.shape), str(x.dtype).removeprefix("torch."))


@pytest.mark.parametrize("arch", ["phi3-mini-3.8b", "gemma3-12b",
                                  "phi-3-vision-4.2b", "whisper-tiny"])
@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k",
                                   "long_500k"])
def test_specs_match(arch, shape):
    rcfg, pcfg = ref_configs.get_config(arch), port_configs.get_config(arch)
    rs, ps = ref_configs.get_shape(shape), port_configs.get_shape(shape)
    assert supports_shape(pcfg, ps) == ref_models.supports_shape(rcfg, rs)
    for port_fn, ref_fn in ((train_batch_specs, ref_models.train_batch_specs),
                            (prefill_specs, ref_models.prefill_specs)):
        port = {k: port_spec(v) for k, v in port_fn(pcfg, ps).items()}
        assert port == spec_shapes(ref_fn(rcfg, rs))
        assert all(v.device.type == "meta"
                   for v in port_fn(pcfg, ps).values())
    assert_decode_specs_match(rcfg, pcfg, rs, ps)


def assert_decode_specs_match(rcfg, pcfg, rs, ps):
    """The port's per-layer cache specs against the reference's stacked
    ones (over groups, or over whisper's decoder layers)."""
    port = decode_specs(pcfg, ps)
    ref = ref_models.decode_specs(rcfg, rs)
    layers = ref["cache"]["layers"]
    p = len(pcfg.pattern)
    assert len(port["cache"]["layers"]) == pcfg.n_layers
    for layer, c in enumerate(port["cache"]["layers"]):
        want = (layers if pcfg.family == "audio"
                else layers[f"l{layer % p}"])
        stack = pcfg.n_layers if pcfg.family == "audio" else pcfg.n_groups
        assert set(c) == set(want)
        for name, spec in c.items():
            shape, dtype = port_spec(spec)
            assert ((stack,) + shape, dtype) == spec_shapes(want[name]), name
            assert spec.device.type == "meta"
    assert port["cache"]["step"] == 0
    assert port_spec(port["tokens"]) == spec_shapes(ref["tokens"])


@pytest.mark.parametrize("arch,shape", [
    ("granite-moe-1b-a400m", "decode_32k"), ("kimi-k2-1t-a32b", "decode_32k"),
    ("mamba2-1.3b", "long_500k"), ("zamba2-2.7b", "long_500k")])
def test_decode_specs_match_every_family(arch, shape):
    """The MoE, ssm and hybrid caches at full size (no memory: meta)."""
    assert_decode_specs_match(ref_configs.get_config(arch),
                              port_configs.get_config(arch),
                              ref_configs.get_shape(shape),
                              port_configs.get_shape(shape))
