"""Latent attention's absorbed-decode core (``kernels/mla_decode.py``) on
the CPU: the plain version against an f64 expanded-attention reference,
``mla_decode`` bitwise the six eager ops it ran before the kernel, the
route between the kernel and the plain version (by device, dtype and
widths), and the launch counter.
The kernel itself runs only on the card (``test_torch_cuda.py``).

Tolerance: the plain version in f32 against f64 differs by f32 rounding
of a softmax over at most 65 positions and a sum over them: 1e-5."""

import dataclasses

import numpy as np
import pytest
import torch

import repro_torch.models.mla as mla_module
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.kernels import (
    launch_counts,
    mla_decode_attention,
    mla_decode_attention_plain,
    reset_launch_counts,
)
from repro_torch.kernels.mla_decode import takes
from repro_torch.models import build_model
from repro_torch.models.mla import mla_decode, softmax_scale

ARCH = "kimi-k2-instruct"


def draw(rng, b, h, r, p, length_max, dtype=torch.float32):
    return tuple(torch.as_tensor(rng.standard_normal(shape)).to(dtype)
                 for shape in ((b, h, r), (b, h, p), (b, length_max, r),
                               (b, length_max, p)))


def expanded(q_hat, q_pe, c, kr, length, scale):
    """Attention written out in f64 over keys [c | kr] and values c."""
    q = torch.cat([q_hat, q_pe], -1).double()
    k = torch.cat([c, kr], -1)[:, :length].double()
    w = torch.softmax(scale * q @ k.transpose(1, 2), dim=-1)
    return w @ c[:, :length].double()


@pytest.mark.parametrize("h,r,p,b,length,length_max", [
    (4, 16, 8, 2, 5, 9),          # the smoke config's widths
    (4, 16, 8, 3, 1, 1),
    (64, 512, 64, 2, 7, 12),      # Kimi-K2's
    (64, 512, 64, 1, 65, 65),
    (16, 512, 64, 3, 64, 70),
])
def test_plain_version_is_expanded_attention(h, r, p, b, length, length_max):
    rng = np.random.default_rng(h + r + length)
    args = draw(rng, b, h, r, p, length_max)
    got = mla_decode_attention_plain(*args, length, 0.3)
    assert got.shape == (b, h, r) and got.dtype == torch.float32
    np.testing.assert_allclose(got.double().numpy(),
                               expanded(*args, length, 0.3).numpy(),
                               rtol=1e-5, atol=1e-5)


def old_mla_decode(p, h, cache, step, m, *, eps):
    """``mla_decode`` as it was before the kernel: the six ops inline."""
    b = h.shape[0]
    hn, dn, dv = m.n_heads, m.qk_nope_head_dim, m.v_head_dim
    positions = torch.full((1,), step, device=h.device)
    q_nope, q_pe = mla_module._query(p, h, m, positions, eps)
    c_new, kr_new = mla_module._latent(p, h, m, positions, eps)
    cache["c"][:, step] = c_new[:, 0]
    cache["kr"][:, step] = kr_new[:, 0]
    c, kr = cache["c"][:, :step + 1], cache["kr"][:, :step + 1]
    wkv = p["wkv_b"].view(m.kv_lora_rank, hn, dn + dv)
    wk, wv = wkv[..., :dn], wkv[..., dn:]
    q_hat = torch.einsum("bhn,chn->bhc", q_nope[:, 0], wk)
    sc = softmax_scale(m)
    scores = torch.bmm(kr, q_pe[:, 0].transpose(1, 2))
    scores.baddbmm_(c, q_hat.transpose(1, 2), beta=sc, alpha=sc)
    probs = torch.softmax(scores.transpose(1, 2).contiguous(), dim=-1)
    probs = probs.transpose(1, 2).contiguous()
    o_lat = torch.bmm(probs.transpose(1, 2), c)
    o = torch.einsum("bhc,chv->bhv", o_lat, wv).reshape(b, 1, hn * dv)
    return torch.einsum("bse,ed->bsd", o, p["wo"])


def latent_widths():
    """The smoke config with Kimi-K2's latent widths (64 heads, c 512, kr
    64) and small other widths: a layer the kernel would take."""
    cfg = get_smoke_config(ARCH)
    return cfg.with_(mla=dataclasses.replace(
        cfg.mla, n_heads=64, kv_lora_rank=512, qk_rope_head_dim=64))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("widths", ["smoke", "latent"])
def test_mla_decode_on_the_cpu_is_bitwise_as_before(widths, dtype):
    cfg = get_smoke_config(ARCH) if widths == "smoke" else latent_widths()
    model = build_model(cfg, dtype, device="cpu")
    model.init(torch.Generator().manual_seed(0))
    p, m = model.layers[1].attn, cfg.mla
    gen = torch.Generator().manual_seed(3)
    h = torch.randn(3, 1, cfg.d_model, generator=gen).to(dtype)
    cache = {"c": torch.randn(3, 10, m.kv_lora_rank, generator=gen)
             .to(dtype),
             "kr": torch.randn(3, 10, m.qk_rope_head_dim, generator=gen)
             .to(dtype)}
    before = {k: v.clone() for k, v in cache.items()}
    with torch.inference_mode():
        got = mla_decode(p, h, cache, 6, m, eps=cfg.norm_eps)
        want = old_mla_decode(p, h, before, 6, m, eps=cfg.norm_eps)
    assert torch.equal(got, want)
    for k in cache:
        assert torch.equal(cache[k], before[k])


@pytest.mark.parametrize("cfg,kernel", [
    (get_config(ARCH), True),
    (get_smoke_config(ARCH), False),
    (latent_widths(), True),
])
def test_mla_decode_routes_on_the_widths(monkeypatch, cfg, kernel):
    """On the card in bf16, Kimi-K2's widths go to the kernel and others
    to the plain version; on the CPU every width goes to the plain
    version."""
    m = cfg.mla
    widths = (m.n_heads, m.kv_lora_rank, m.qk_rope_head_dim)
    assert takes(torch.device("cuda"), torch.bfloat16, *widths) is kernel
    assert not takes(torch.device("cpu"), torch.bfloat16, *widths)
    if cfg.d_model > 1024:
        return      # the published model is too large to build here
    called = []

    def spy(name, fn):
        def wrapped(*args):
            called.append(name)
            return fn(*args)
        monkeypatch.setattr(mla_module, name, wrapped)

    spy("mla_decode_attention", mla_decode_attention)
    spy("mla_decode_attention_plain", mla_decode_attention_plain)
    model = build_model(cfg, torch.float32, device="cpu")
    model.init(torch.Generator().manual_seed(0))
    h = torch.randn(2, 1, cfg.d_model, generator=torch.Generator()
                    .manual_seed(1))
    cache = {"c": torch.zeros(2, 4, m.kv_lora_rank),
             "kr": torch.zeros(2, 4, m.qk_rope_head_dim)}
    with torch.inference_mode():
        mla_decode(model.layers[0].attn, h, cache, 2, m, eps=cfg.norm_eps)
    assert called == ["mla_decode_attention_plain"]


@pytest.mark.parametrize("h,r,p", [(65, 512, 64), (64, 256, 64),
                                   (64, 512, 32), (0, 512, 64)])
def test_other_widths_are_not_the_kernels(h, r, p):
    assert not takes(torch.device("cuda"), torch.bfloat16, h, r, p)


@pytest.mark.parametrize("device,dtype,kernel", [
    ("cuda", torch.bfloat16, True),
    ("cuda:1", torch.bfloat16, True),
    ("cuda", torch.float32, False),
    ("cuda", torch.float16, False),
    ("cpu", torch.bfloat16, False),
    ("meta", torch.bfloat16, False),
])
def test_only_bf16_on_the_card_is_the_kernels(device, dtype, kernel):
    """A model at Kimi-K2's widths in another dtype, or off the card, runs
    the plain version rather than raising."""
    assert takes(torch.device(device), dtype, 64, 512, 64) is kernel


def test_wrapper_on_the_cpu_runs_the_plain_version_and_counts_nothing():
    rng = np.random.default_rng(2)
    args = draw(rng, 2, 64, 512, 64, 8, torch.bfloat16)
    reset_launch_counts()
    assert torch.equal(mla_decode_attention(*args, 6, 0.13),
                       mla_decode_attention_plain(*args, 6, 0.13))
    assert launch_counts()["mla_decode_attention"] == 0


def test_launch_counter_is_listed_and_reset():
    saved = mla_decode_attention.launches
    try:
        mla_decode_attention.launches = 7
        assert launch_counts()["mla_decode_attention"] == 7
        reset_launch_counts()
        assert mla_decode_attention.launches == 0
        assert set(launch_counts()) == {"bcsr_matmul", "cyclic_encode",
                                        "decode_matmul",
                                        "mla_decode_attention",
                                        "held_expert_ffn"}
    finally:
        mla_decode_attention.launches = saved


@pytest.mark.parametrize("bad,msg", [
    ("length0", "length 0 outside"),
    ("length_past", "length 9 outside"),
    ("shapes", "disagree"),
    ("ndim", "3-d"),
])
def test_wrapper_rejects_bad_arguments(bad, msg):
    rng = np.random.default_rng(4)
    q_hat, q_pe, c, kr = draw(rng, 2, 4, 16, 8, 8)
    length = {"length0": 0, "length_past": 9}.get(bad, 4)
    if bad == "shapes":
        kr = kr[:, :, :4]
    if bad == "ndim":
        q_hat = q_hat[0]
    with pytest.raises(ValueError, match=msg):
        mla_decode_attention(q_hat, q_pe, c, kr, length, 0.1)
