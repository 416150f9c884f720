"""The port's training loss and its gradients against the JAX package's:
for every arch of the registry at smoke width, ``model.train_loss`` and
the gradient of every weight against ``jax.value_and_grad(model.
train_loss)`` on the same (converted) f32 weights and batch; the
cross-entropy's label mask; the MoE router's gradients at a capacity
where slots drop; remat against no remat.

The loss is held to ``rtol=1e-5``; each weight's gradient to 1e-4 of
that leaf's max |g|.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
import repro.models as ref_models
import repro.models.transformer as ref_transformer
import repro_torch.configs as port_configs
from repro_torch.convert import model_params_from_reference
from repro_torch.models import build_model
from repro_torch.models.transformer import sharded_cross_entropy

CPU = torch.device("cpu")
LOSS_RTOL = 1e-5
GRAD_REL = 1e-4


def configs(arch, **moe):
    cfg = ref_configs.get_smoke_config(arch)
    pcfg = port_configs.get_smoke_config(arch)
    if moe:
        cfg = cfg.with_(moe=dataclasses.replace(cfg.moe, **moe))
        pcfg = pcfg.with_(moe=dataclasses.replace(pcfg.moe, **moe))
    return cfg, pcfg


def batch(cfg, rng, b=2, s=16):
    """A training batch as numpy arrays (the data pipeline's dtypes)."""
    toks = rng.integers(0, cfg.vocab, (b, s + 1)).astype(np.int32)
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family == "audio":
        out["frames"] = rng.standard_normal(
            (b, cfg.encoder.n_frames, cfg.d_model)).astype(np.float32)
    elif cfg.family == "vlm":
        out["image_embeds"] = rng.standard_normal(
            (b, cfg.vision_tokens, cfg.d_model)).astype(np.float32)
    return out


def both(cfg, pcfg, data, seed=0):
    """(jax loss, jax grads as port keys, port loss, port grads)."""
    jm = ref_models.build_model(cfg, dtype=jnp.float32)
    jp = jm.init(jax.random.key(seed))
    jl, jg = jax.value_and_grad(jm.train_loss)(
        jp, {k: jnp.asarray(v) for k, v in data.items()})
    pm = build_model(pcfg, torch.float32, device=CPU)
    pm.load_state_dict(model_params_from_reference(
        jax.tree.map(np.asarray, jp), pcfg, device=CPU))
    pm.requires_grad_(True)
    loss = pm.train_loss({k: torch.from_numpy(v) for k, v in data.items()})
    loss.backward()
    ref_grads = model_params_from_reference(
        jax.tree.map(np.asarray, jg), pcfg, device=CPU)
    grads = {name: p.grad for name, p in pm.named_parameters()}
    return float(jl), ref_grads, float(loss.detach()), grads


def hold_grads(grads, ref_grads):
    assert set(grads) == set(ref_grads)
    for name, ref in ref_grads.items():
        g = grads[name]
        assert g is not None, name
        scale = float(ref.abs().max())
        err = float((g - ref).abs().max())
        assert err <= GRAD_REL * scale + 1e-12, (name, err, scale)


@pytest.mark.parametrize("arch", list(ref_configs.ARCH_IDS))
def test_train_loss_and_grads_match_reference(arch):
    cfg, pcfg = configs(arch)
    data = batch(cfg, np.random.default_rng(7))
    jl, ref_grads, loss, grads = both(cfg, pcfg, data)
    assert np.isfinite(loss)
    np.testing.assert_allclose(loss, jl, rtol=LOSS_RTOL)
    hold_grads(grads, ref_grads)


def test_moe_router_grads_where_slots_drop(monkeypatch):
    """At capacity 1.25 the dispatch sends some slots to the spare
    (dropped) row, an ``index_put`` with repeated destinations; the
    router's and the experts' gradients still match the reference's."""
    import repro_torch.models.moe as moe_module

    kept = []
    route = moe_module._route_tokens

    def recording(*args):
        out = route(*args)
        kept.append(out[3].detach().clone())
        return out

    monkeypatch.setattr(moe_module, "_route_tokens", recording)
    cfg, pcfg = configs("granite-moe-1b-a400m", capacity_factor=1.25)
    data = batch(cfg, np.random.default_rng(3), b=4, s=16)
    jl, ref_grads, loss, grads = both(cfg, pcfg, data)
    assert kept and any(not bool(k.all()) for k in kept), "nothing dropped"
    np.testing.assert_allclose(loss, jl, rtol=LOSS_RTOL)
    hold_grads(grads, ref_grads)
    router = [n for n in grads if n.endswith("moe.router")]
    assert router and all(float(grads[n].abs().max()) > 0 for n in router)


def test_cross_entropy_masks_negative_labels():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((2, 5, 11)).astype(np.float32)
    labels = rng.integers(0, 11, (2, 5)).astype(np.int32)
    labels[0, :2] = -1
    labels[1, 4] = -100
    want = ref_transformer.sharded_cross_entropy(jnp.asarray(logits),
                                                 jnp.asarray(labels))
    lt = torch.from_numpy(logits).requires_grad_(True)
    got = sharded_cross_entropy(lt, torch.from_numpy(labels))
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=LOSS_RTOL)
    got.backward()
    jg = jax.grad(lambda z: ref_transformer.sharded_cross_entropy(
        z, jnp.asarray(labels)))(jnp.asarray(logits))
    np.testing.assert_allclose(lt.grad.numpy(), np.asarray(jg), rtol=1e-5,
                               atol=1e-7)
    # masked positions get no gradient
    assert float(lt.grad[0, :2].abs().max()) == 0.0


@pytest.mark.parametrize("arch", ["phi3-mini-3.8b", "zamba2-2.7b"])
def test_remat_gives_the_same_loss_and_grads(arch):
    """Checkpointing recomputes: the values are those without it."""
    _, pcfg = configs(arch)
    data = batch(pcfg, np.random.default_rng(1))
    out = {}
    for remat in ("full", "none"):
        pm = build_model(pcfg.with_(remat=remat), torch.float32, device=CPU)
        pm.init(torch.Generator().manual_seed(0))
        pm.requires_grad_(True)
        loss = pm.train_loss({k: torch.from_numpy(v)
                              for k, v in data.items()})
        loss.backward()
        out[remat] = (float(loss.detach()), {n: p.grad.clone()
                                    for n, p in pm.named_parameters()})
    assert out["full"][0] == out["none"][0]
    for name, g in out["none"][1].items():
        torch.testing.assert_close(out["full"][1][name], g, rtol=0, atol=0)
