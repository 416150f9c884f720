"""The port's model families beyond ``dense`` against the JAX package's:
the SSD scan and the Mamba-2 block (prefill and recurrent decode), every
moe / ssm / hybrid / vlm / audio smoke config (forward, prefill with
every cache tensor, three decode steps), a prompt of two whole SSD
chunks, the VLM's image prefix, whisper's frames, the hybrid's shared
layer, each config's own cache against its own forward, the serve
engine with the coded head, and the launcher's refusal of audio.

Weights cross from JAX through ``model_params_from_reference``; inputs
come from a numpy seed.  f32 is held to the reference's 2e-5
(``tests/test_kernels.py:27-28``); a config's cache against its own
forward to ``tests/test_models_smoke.py``'s 5e-3.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
import repro.launch.serve as ref_launch
import repro.models as ref_models
import repro.models.mamba2 as ref_mamba
import repro.serve as ref_serve
import repro_torch.configs as port_configs
import repro_torch.launch.serve as port_launch
from repro_torch.configs.base import CodedConfig, SSMConfig
from repro_torch.convert import model_params_from_reference
from repro_torch.models import TransformerLM, WhisperLM, build_model
from repro_torch.models.mamba2 import (
    _causal_conv,
    _split_proj,
    _ssd_scan,
    init_mamba_cache,
    mamba_block,
    mamba_decode_step,
    mamba_param_shapes,
    mamba_prefill,
)
from repro_torch.serve import Request, ServeEngine

TOL = dict(rtol=2e-5, atol=2e-5)
SELF = dict(rtol=5e-3, atol=5e-3)
CPU = torch.device("cpu")
FAMILIES = ["granite-moe-1b-a400m", "kimi-k2-1t-a32b", "mamba2-1.3b",
            "zamba2-2.7b", "phi-3-vision-4.2b", "whisper-tiny"]
SERVED = [a for a in FAMILIES if a != "whisper-tiny"]


def t(x):
    return torch.as_tensor(np.asarray(x))


def close(port, ref, tol=TOL):
    np.testing.assert_allclose(port.detach().float().numpy(),
                               np.asarray(ref, np.float32), **tol)


def pair(arch, shared_experts: int = 0):
    """(jax model, jax params, port model) on the same f32 weights;
    ``shared_experts`` sets an MoE config's ``n_shared_experts``."""
    cfg = ref_configs.get_smoke_config(arch)
    pcfg = port_configs.get_smoke_config(arch)
    if shared_experts:
        cfg = cfg.with_(moe=dataclasses.replace(
            cfg.moe, n_shared_experts=shared_experts))
        pcfg = pcfg.with_(moe=dataclasses.replace(
            pcfg.moe, n_shared_experts=shared_experts))
    jm = ref_models.build_model(cfg, dtype=jnp.float32)
    jp = jm.init(jax.random.key(0))
    pm = build_model(pcfg, torch.float32, device=CPU)
    pm.load_state_dict(model_params_from_reference(
        jax.tree.map(np.asarray, jp), pcfg, device=CPU))
    return jm, jp, pm


def extras(cfg, rng, b):
    """The family's extra inputs: (jax kwargs, port kwargs)."""
    if cfg.family == "audio":
        x = rng.standard_normal((b, cfg.encoder.n_frames, cfg.d_model))
        name = "frames"
    elif cfg.family == "vlm":
        x = rng.standard_normal((b, cfg.vision_tokens, cfg.d_model))
        name = "image_embeds"
    else:
        return {}, {}
    x = x.astype(np.float32)
    return {name: jnp.asarray(x)}, {name: torch.from_numpy(x)}


def forward(model, params, tokens, kw, port: bool):
    """A forward pass in either package's calling convention."""
    if port:
        return model(tokens, **kw)
    if "frames" in kw:
        return model.forward(params, tokens, kw["frames"])
    return model.forward(params, tokens, kw.get("image_embeds"))


def ref_layer_caches(cfg, rc, n_layers):
    """The reference cache, one dict of arrays per layer position."""
    layers = rc["layers"]
    if cfg.family == "audio":
        return [{n: np.asarray(v[j]) for n, v in layers.items()}
                for j in range(n_layers)]
    p = len(cfg.pattern)
    return [{n: np.asarray(v[g]) for n, v in layers[f"l{i}"].items()}
            for g in range(cfg.n_groups) for i in range(p)]


# ---------------------------------------------------------------------------
# The SSD scan and the Mamba-2 block (tests/test_model_internals.py)
# ---------------------------------------------------------------------------


class TestSSD:
    def _naive(self, xdt, dA, B, C):
        """Token-by-token recurrence oracle."""
        b, s, h, p = xdt.shape
        n = B.shape[-1]
        state = np.zeros((b, h, p, n))
        ys = []
        for step in range(s):
            state = state * np.exp(dA[:, step])[:, :, None, None] + \
                np.einsum("bhp,bn->bhpn", xdt[:, step], B[:, step])
            ys.append(np.einsum("bhpn,bn->bhp", state, C[:, step]))
        return np.stack(ys, axis=1)

    @pytest.mark.parametrize("s,chunk", [(16, 4), (32, 8), (24, 24),
                                         (32, 32)])
    def test_chunked_equals_naive(self, s, chunk):
        rng = np.random.default_rng(3)
        b, h, p, n = 2, 3, 4, 5
        xdt = rng.standard_normal((b, s, h, p))
        dA = -np.abs(rng.standard_normal((b, s, h))) * 0.1
        B = rng.standard_normal((b, s, n))
        C = rng.standard_normal((b, s, n))
        y, state = _ssd_scan(t(xdt), t(dA), t(B), t(C), chunk)
        assert y.dtype == state.dtype == torch.float32
        np.testing.assert_allclose(y.numpy(), self._naive(xdt, dA, B, C),
                                   rtol=1e-4, atol=1e-4)
        ry, rstate = ref_mamba._ssd_scan(
            jnp.asarray(xdt), jnp.asarray(dA), jnp.asarray(B),
            jnp.asarray(C), chunk)
        close(y, ry)
        close(state, rstate)

    def test_final_state_consistent_across_chunkings(self):
        rng = np.random.default_rng(4)
        b, s, h, p, n = 1, 32, 2, 4, 3
        xdt = t(rng.standard_normal((b, s, h, p)))
        dA = t(-np.abs(rng.standard_normal((b, s, h))) * 0.1)
        B = t(rng.standard_normal((b, s, n)))
        C = t(rng.standard_normal((b, s, n)))
        _, st1 = _ssd_scan(xdt, dA, B, C, 8)
        _, st2 = _ssd_scan(xdt, dA, B, C, 32)
        np.testing.assert_allclose(st1.numpy(), st2.numpy(), rtol=1e-5,
                                   atol=1e-5)

    def test_ragged_chunk_raises(self):
        z = torch.zeros((1, 12, 1, 2))
        with pytest.raises(ValueError, match="not a multiple of chunk"):
            _ssd_scan(z, torch.zeros((1, 12, 1)), torch.zeros((1, 12, 3)),
                      torch.zeros((1, 12, 3)), 8)


SSM = dict(d_state=8, head_dim=8, expand=2, chunk=4)


def mamba_params(seed=0, d=16):
    rp = ref_mamba.init_mamba_params(jax.random.key(seed), d,
                                     ref_configs.base.SSMConfig(**SSM))
    bias = np.random.default_rng(seed).standard_normal(rp["conv_b"].shape)
    rp = dict(rp, conv_b=jnp.asarray(bias * 0.1, jnp.float32))
    pp = {n: torch.from_numpy(np.array(v)) for n, v in rp.items()}
    return pp, rp


def test_conv_and_split_match():
    rng = np.random.default_rng(5)
    xbc = rng.standard_normal((2, 7, 12)).astype(np.float32)
    w = rng.standard_normal((4, 12)).astype(np.float32)
    b = rng.standard_normal(12).astype(np.float32)
    close(_causal_conv(t(xbc), t(w), t(b)),
          ref_mamba._causal_conv(jnp.asarray(xbc), jnp.asarray(w),
                                 jnp.asarray(b)))
    proj = t(rng.standard_normal((2, 3, 2 * 8 + 2 * 4 + 2)))
    for got, want in zip(_split_proj(proj, 8, 4, 2),
                         ref_mamba._split_proj(jnp.asarray(proj.numpy()),
                                               8, 4, 2)):
        close(got, want)


def test_mamba_param_shapes_match():
    cfg = ref_configs.base.SSMConfig(**SSM)
    rp = ref_mamba.init_mamba_params(jax.random.key(0), 16, cfg)
    assert {n: tuple(v.shape) for n, v in rp.items()} == \
        mamba_param_shapes(16, SSMConfig(**SSM))


@pytest.mark.parametrize("s", [3, 8])
def test_mamba_block_prefill_and_decode_match(s):
    """``mamba_block`` over a prompt; the prefill's cache (a conv tail
    padded for a prompt shorter than ``d_conv - 1``) and five recurrent
    decode steps, each step's output and cache, against the reference."""
    cfg, rcfg = SSMConfig(**SSM), ref_configs.base.SSMConfig(**SSM)
    pp, rp = mamba_params()
    rng = np.random.default_rng(6)
    u = rng.standard_normal((2, s, 16)).astype(np.float32)
    if s % SSM["chunk"]:
        cfg = SSMConfig(**dict(SSM, chunk=s))
        rcfg = ref_configs.base.SSMConfig(**dict(SSM, chunk=s))
    out = mamba_block(pp, t(u), cfg, eps=1e-6)
    close(out, ref_mamba.mamba_block(rp, jnp.asarray(u), rcfg, eps=1e-6))
    got, cache = mamba_prefill(pp, t(u), cfg, eps=1e-6)
    assert torch.equal(got, out)
    assert tuple(cache["conv"].shape) == (2, 3, 32 + 2 * 8)   # d_conv - 1
    # the reference's cache after the same prompt: its decode from zeros
    rc = ref_mamba.init_mamba_cache(2, 16, rcfg)
    for j in range(s):
        _, rc = ref_mamba.mamba_decode_step(rp, jnp.asarray(u[:, j:j + 1]),
                                            rc, rcfg, eps=1e-6)
    close(cache["conv"], rc["conv"])
    np.testing.assert_allclose(cache["state"].numpy(),
                               np.asarray(rc["state"]), rtol=1e-4,
                               atol=1e-4)
    pc = init_mamba_cache(2, 16, cfg)
    rc = ref_mamba.init_mamba_cache(2, 16, rcfg)
    for _ in range(5):
        x = rng.standard_normal((2, 1, 16)).astype(np.float32)
        conv, state = pc["conv"], pc["state"]
        py, pc = mamba_decode_step(pp, t(x), pc, cfg, eps=1e-6)
        assert pc["conv"] is conv and pc["state"] is state   # in place
        ry, rc = ref_mamba.mamba_decode_step(rp, jnp.asarray(x), rc, rcfg,
                                             eps=1e-6)
        close(py, ry)
        close(pc["conv"], rc["conv"])
        close(pc["state"], rc["state"])


# ---------------------------------------------------------------------------
# Whole models
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,shared", [(a, 0) for a in FAMILIES]
                         + [("granite-moe-1b-a400m", 1)])
def test_family_matches(arch, shared):
    """forward (logits and aux), prefill (logits and every cache tensor)
    and three decode steps against the JAX package; granite's smoke
    config also with one shared expert (no registry config sets one)."""
    jm, jp, pm = pair(arch, shared)
    assert ("layers.0.moe.shared.w_up" in pm.state_dict()) == bool(shared)
    cfg = pm.cfg
    assert isinstance(pm, WhisperLM if cfg.family == "audio"
                      else TransformerLM)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab, (2, 10))
    rkw, pkw = extras(cfg, rng, 2)
    rl, raux = forward(jm, jp, jnp.asarray(toks), rkw, port=False)
    pl, paux = forward(pm, None, t(toks), pkw, port=True)
    v = cfg.vision_tokens if cfg.family == "vlm" else 0
    assert pl.shape == (2, 10 + v, cfg.vocab) and pl.dtype == torch.float32
    close(pl, rl)
    close(paux, raux)

    rl, rc = jm.prefill(jp, jnp.asarray(toks), max_len=32, **rkw)
    pl, pc = pm.prefill(t(toks), max_len=32, **pkw)
    close(pl, rl)
    assert pc["step"] == int(rc["step"]) == 10 + v
    ref_caches = ref_layer_caches(cfg, rc, len(pc["layers"]))
    for c, ref in zip(pc["layers"], ref_caches):
        assert set(c) == set(ref)
        for name in c:
            assert tuple(c[name].shape) == ref[name].shape, name
            close(c[name], ref[name])
    for _ in range(3):
        nxt = rng.integers(0, cfg.vocab, (2, 1))
        rl, rc = jm.decode_step(jp, rc, jnp.asarray(nxt))
        pl, pc = pm.decode_step(pc, t(nxt))
        close(pl, rl)
    assert pc["step"] == int(rc["step"]) == 13 + v


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "zamba2-2.7b"])
def test_two_chunk_prompt_carries_the_state(arch):
    """A prompt of two whole SSD chunks (the smoke configs' chunk is 16):
    the second chunk starts from the first one's carried state."""
    jm, jp, pm = pair(arch)
    assert pm.cfg.ssm.chunk == 16
    rng = np.random.default_rng(2)
    toks = rng.integers(0, pm.cfg.vocab, (2, 32))
    rl, rc = jm.prefill(jp, jnp.asarray(toks), max_len=40)
    pl, pc = pm.prefill(t(toks), max_len=40)
    close(pl, rl)
    close(pm(t(toks))[0], jm.forward(jp, jnp.asarray(toks))[0])
    for c, ref in zip(pc["layers"], ref_layer_caches(pm.cfg, rc,
                                                     len(pc["layers"]))):
        for name in c:
            close(c[name], ref[name])
    nxt = rng.integers(0, pm.cfg.vocab, (2, 1))
    close(pm.decode_step(pc, t(nxt))[0],
          jm.decode_step(jp, rc, jnp.asarray(nxt))[0])


def test_vlm_without_image_serves_text():
    """The prefix is optional: without ``image_embeds`` the vlm is its
    text backbone (the engine's prefill passes none)."""
    jm, jp, pm = pair("phi-3-vision-4.2b")
    toks = np.random.default_rng(3).integers(0, pm.cfg.vocab, (2, 6))
    pl, _ = pm(t(toks))
    assert pl.shape == (2, 6, pm.cfg.vocab)
    close(pl, jm.forward(jp, jnp.asarray(toks))[0])
    rl, _ = jm.prefill(jp, jnp.asarray(toks), max_len=16)
    close(pm.prefill(t(toks), max_len=16)[0], rl)


def test_whisper_encoder_matches():
    jm, jp, pm = pair("whisper-tiny")
    frames = np.random.default_rng(4).standard_normal(
        (2, pm.cfg.encoder.n_frames, pm.cfg.d_model)).astype(np.float32)
    close(pm.encode(t(frames)), jm.encode(jp, jnp.asarray(frames)))


def test_hybrid_shared_layer_is_one_set_of_weights():
    """zamba2's S block: one ``shared.*`` in the state dict, nothing at
    the S positions of ``layers``, the JAX model's parameter count, and
    the same module at every S position."""
    jm, jp, pm = pair("zamba2-2.7b")
    cfg = pm.cfg
    sd = pm.state_dict()
    p = len(cfg.pattern)
    s_layers = [g * p + i for g in range(cfg.n_groups)
                for i, k in enumerate(cfg.pattern) if k == "S"]
    assert len(s_layers) == 2
    assert not any(key.startswith(f"layers.{L}.") for L in s_layers
                   for key in sd)
    assert any(key.startswith("shared.attn.") for key in sd)
    n_port = sum(v.numel() for v in pm.state_dict().values())
    n_ref = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(jp))
    assert n_port == n_ref == sum(x.numel() for x in pm.parameters())
    blocks = pm._blocks()
    assert blocks[s_layers[0]] is blocks[s_layers[1]] is pm.shared
    # per-position caches: the two S positions hold different keys
    _, cache = pm.prefill(t(np.arange(12).reshape(2, 6)), max_len=16)
    k0, k1 = (cache["layers"][L]["k"] for L in s_layers)
    assert k0.shape == k1.shape and not torch.equal(k0, k1)


@pytest.mark.parametrize("arch", port_configs.ARCH_IDS)
def test_prefill_decode_consistency(arch):
    """Each config's own cache against its own forward
    (``tests/test_models_smoke.py``): prefill of 8 tokens, two decode
    steps, within 5e-3 of the full forward's logits."""
    cfg = port_configs.get_smoke_config(arch)
    model = build_model(cfg, torch.float32, device=CPU)
    model.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(2)
    toks = t(rng.integers(0, cfg.vocab, (2, 32)))
    _, kw = extras(cfg, rng, 2)
    lp, cache = model.prefill(toks[:, :8], max_len=32, **kw)
    l1, cache = model.decode_step(cache, toks[:, 8:9])
    l2, cache = model.decode_step(cache, toks[:, 9:10])
    full, _ = model(toks[:, :10], **kw)
    v = cfg.vision_tokens if cfg.family == "vlm" else 0
    for got, ref in ((lp, full[:, v + 7]), (l1, full[:, v + 8]),
                     (l2, full[:, v + 9])):
        torch.testing.assert_close(got, ref, **SELF)


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", SERVED)
def test_engine_with_coded_head_matches(arch):
    """The serve engine on each non-audio family: every step's logits
    within f32 tolerance of the JAX engine's, and the coded head under
    an explicit mask against the JAX engine's coded head."""
    coded = dict(enabled=True, n_workers=6, stragglers=2, seed=1)
    jm, jp, pm = pair(arch)
    cfg = pm.cfg
    rcfg = ref_configs.get_smoke_config(arch)
    ref = ref_serve.ServeEngine(jm, jp, rcfg, batch_size=2, max_len=32,
                                coded=ref_configs.base.CodedConfig(**coded))
    port = ServeEngine(pm, pm.state_dict(), cfg, batch_size=2, max_len=32,
                       coded=CodedConfig(**coded))
    seen = {"ref": [], "port": []}
    for key, eng, conv in (("ref", ref, np.asarray),
                           ("port", port, lambda x: x.numpy())):
        prefill, decode = eng._prefill, eng._decode

        def rec_prefill(*a, _f=prefill, _k=key, _c=conv):
            out = _f(*a)
            seen[_k].append(_c(out[0]))
            return out

        def rec_decode(*a, _f=decode, _k=key, _c=conv):
            out = _f(*a)
            seen[_k].append(_c(out[0]))
            return out
        eng._prefill, eng._decode = rec_prefill, rec_decode
    reqs = [[1, 5, 9], [1, 7], [1, 2, 3, 4]]
    ref.run([ref_serve.Request(prompt=p, max_new=3) for p in reqs])
    out = port.run([Request(prompt=p, max_new=3) for p in reqs])
    assert [len(r.output) for r in out] == [3, 3, 3]
    assert len(seen["port"]) == len(seen["ref"]) == 6
    for p, r in zip(seen["port"], seen["ref"]):
        np.testing.assert_allclose(p, r, **TOL)
    hidden = np.random.default_rng(0).standard_normal(
        (2, cfg.d_model)).astype(np.float32)
    done = np.array([True, False, True, True, False, True])
    np.testing.assert_allclose(
        port.coded_logits(t(hidden), done).numpy(),
        np.asarray(ref.coded_logits(jnp.asarray(hidden), jnp.asarray(done))),
        **TOL)


def test_launcher_refuses_audio(monkeypatch):
    argv = ["--arch", "whisper-tiny", "--smoke"]
    with pytest.raises(SystemExit) as port_exit:
        port_launch.build(port_launch.parse_args(argv + ["--device", "cpu"]))
    monkeypatch.setattr("sys.argv", ["serve"] + argv)
    with pytest.raises(SystemExit) as ref_exit:
        ref_launch.main()
    assert str(port_exit.value) == str(ref_exit.value) == \
        "audio serving needs frames; see tests/examples"


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "zamba2-2.7b"])
def test_launcher_serves_the_family(arch, capsys):
    args = port_launch.parse_args(
        ["--arch", arch, "--smoke", "--device", "cpu", "--coded",
         "--requests", "2", "--max-new", "2"])
    cfg, _, params, engine = port_launch.build(args)
    rng = np.random.default_rng(args.seed)
    out = port_launch.serve(engine, port_launch.make_requests(args, cfg, rng))
    assert [len(r.output) for r in out] == [2, 2]
    assert port_launch.check_coded_head(args, cfg, params, engine, rng) < 1e-4
    assert "served 2 requests, 4 tokens" in capsys.readouterr().out
