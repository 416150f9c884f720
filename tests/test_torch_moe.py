"""The port's MoE layer against the JAX package's: the capacity rule, the
routing (top-k, slots, drops) exactly, ``moe_block`` with and without
capacity drops and with a shared expert, the reference's own MoE
invariants, and ``CodedMoE`` in process and through a fleet.

Weights come from the reference's ``init_moe_params`` and cross as
numpy arrays; inputs from a numpy seed.  ``moe_block`` is held to f32
``rtol=atol=2e-5``; ``CodedMoE`` to the reference test's 1e-4
(``tests/test_api_plan.py``), its aux loss to 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import repro.models.moe as ref_moe
from repro.configs.base import MoEConfig as RefMoEConfig
from repro_torch.api.fleet import CodedFleet
from repro_torch.configs.base import MoEConfig
from repro_torch.models.moe import (
    CodedMoE,
    _capacity,
    _route_tokens,
    init_moe_params,
    moe_apply,
    moe_block,
    moe_param_shapes,
)

TOL = dict(rtol=2e-5, atol=2e-5)
CODED = dict(rtol=1e-4, atol=1e-4)
CPU = torch.device("cpu")


def configs(**kw):
    return MoEConfig(**kw), RefMoEConfig(**kw)


def params(moe_kw, d, seed=0):
    """(port params, reference params) from the reference's init."""
    _, rmoe = configs(**moe_kw)
    rp = ref_moe.init_moe_params(jax.random.key(seed), d, rmoe)
    pp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), rp)
    return pp, rp


def inputs(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    return torch.from_numpy(x), jnp.asarray(x)


def close(port, ref, tol=TOL):
    np.testing.assert_allclose(port.detach().float().numpy(),
                               np.asarray(ref, np.float32), **tol)


@pytest.mark.parametrize("e,k,cf", [(8, 2, 1.25), (32, 8, 1.25), (8, 2, 8.0),
                                    (384, 8, 1.25), (4, 1, 0.5)])
@pytest.mark.parametrize("tokens", [1, 8, 72, 513])
def test_capacity_matches(e, k, cf, tokens):
    moe, rmoe = configs(n_experts=e, top_k=k, d_expert=4, capacity_factor=cf)
    assert _capacity(tokens, moe) == ref_moe._capacity(tokens, rmoe)


@given(st.integers(8, 512), st.integers(1, 8))
@settings(max_examples=30, deadline=None)
def test_capacity_formula(tokens, k):
    moe, rmoe = configs(n_experts=8, top_k=k, d_expert=4)
    c = _capacity(tokens, moe)
    assert c == ref_moe._capacity(tokens, rmoe)
    assert c % 4 == 0 and c >= 4
    assert c * moe.n_experts >= tokens * k  # cf >= 1 covers all tokens


@pytest.mark.parametrize("e,k,cf,t", [(8, 2, 1.25, 32), (8, 2, 8.0, 16),
                                      (32, 8, 1.25, 8), (32, 8, 1.25, 72),
                                      (4, 1, 0.5, 64)])
def test_route_tokens_exactly(e, k, cf, t):
    """top_e's choice, keep and dest are the reference's exactly (drops
    included); the weights and aux within f32 tolerance."""
    moe_kw = dict(n_experts=e, top_k=k, d_expert=8, capacity_factor=cf)
    moe, rmoe = configs(**moe_kw)
    pp, rp = params(moe_kw, 16, seed=e + k)
    tok, rtok = inputs(np.random.default_rng(t), (t, 16))
    cap = _capacity(t, moe)
    aux, fp, tok_id, keep, dest = _route_tokens(pp["router"], tok, moe, cap)
    raux, rfp, rtok_id, rkeep, rdest = ref_moe._route_tokens(
        rp["router"], rtok, rmoe, cap)
    np.testing.assert_array_equal(tok_id.numpy(), np.asarray(rtok_id))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(rkeep))
    np.testing.assert_array_equal(dest.numpy(), np.asarray(rdest))
    close(fp, rfp)
    close(aux, raux)
    if cf < 1.0:
        assert not keep.all()              # capacity below the mean load


@pytest.mark.parametrize("cf", [1.25, 8.0])
@pytest.mark.parametrize("shared", [0, 1])
def test_moe_block_matches(cf, shared):
    """Capacity 1.25 drops slots (granite's published factor), 8.0 drops
    none (the smoke configs'); with and without a shared expert (no
    registry config sets one)."""
    moe_kw = dict(n_experts=8, top_k=2, d_expert=32, capacity_factor=cf,
                  n_shared_experts=shared)
    moe, rmoe = configs(**moe_kw)
    pp, rp = params(moe_kw, 64)
    assert ("shared" in pp) == bool(shared)
    x, rx = inputs(np.random.default_rng(1), (2, 12, 64))
    out, aux = moe_block(pp, x, moe)
    rout, raux = ref_moe.moe_block(rp, rx, rmoe)
    assert out.shape == x.shape and out.dtype == x.dtype
    close(out, rout)
    close(aux, raux)
    out2, _ = moe_apply(pp, x, moe)
    assert torch.equal(out2, out)


def test_moe_block_bf16_matches():
    moe_kw = dict(n_experts=8, top_k=2, d_expert=32, capacity_factor=8.0)
    moe, rmoe = configs(**moe_kw)
    _, rp = params(moe_kw, 64)
    rp = {n: (v if n == "router" else v.astype(jnp.bfloat16))
          for n, v in rp.items()}
    pp = {n: torch.from_numpy(np.array(v, np.float32)).to(
        torch.float32 if n == "router" else torch.bfloat16)
        for n, v in rp.items()}
    x = np.random.default_rng(2).standard_normal((2, 8, 64))
    rx = jnp.asarray(x, jnp.bfloat16)
    px = torch.from_numpy(np.asarray(rx, np.float32)).bfloat16()
    out, _ = moe_block(pp, px, moe)
    rout, _ = ref_moe.moe_block(rp, rx, rmoe)
    assert out.dtype == torch.bfloat16
    close(out, np.asarray(rout, np.float32), dict(rtol=2e-2, atol=2e-2))


def test_param_shapes_and_init_scales():
    moe, rmoe = configs(n_experts=8, top_k=2, d_expert=32,
                        n_shared_experts=1)
    rp = ref_moe.init_moe_params(jax.random.key(0), 64, rmoe)
    shapes = moe_param_shapes(64, moe)
    flat = {n: s for n, s in shapes.items() if n != "shared"}
    assert {n: tuple(v.shape) for n, v in rp.items() if n != "shared"} == flat
    assert {n: tuple(v.shape) for n, v in rp["shared"].items()} \
        == shapes["shared"]
    gen = torch.Generator().manual_seed(0)
    pp = {n: torch.empty(s) for n, s in flat.items()}
    pp["shared"] = {n: torch.empty(s) for n, s in shapes["shared"].items()}
    init_moe_params(pp, 64, moe, gen)
    assert abs(float(pp["router"].std()) - 64 ** -0.5) < 0.02
    assert abs(float(pp["w_down"].std()) - 32 ** -0.5) < 0.02
    assert abs(float(pp["shared"]["w_up"].std()) - 64 ** -0.5) < 0.02


# ---------------------------------------------------------------------------
# The reference's MoE invariants (tests/test_model_internals.py), both
# packages on the same weights and inputs
# ---------------------------------------------------------------------------


class TestMoE:
    def make(self, e=8, k=2, cf=8.0):
        moe_kw = dict(n_experts=e, top_k=k, d_expert=16, capacity_factor=cf)
        moe, rmoe = configs(**moe_kw)
        pp, rp = params(moe_kw, 32)
        return moe, rmoe, pp, rp

    def test_output_shape_and_finite(self):
        moe, rmoe, pp, rp = self.make()
        x, rx = inputs(np.random.default_rng(1), (2, 16, 32))
        y, aux = moe_block(pp, x, moe)
        assert y.shape == x.shape
        assert bool(torch.isfinite(y).all()) and np.isfinite(float(aux))
        close(y, ref_moe.moe_block(rp, rx, rmoe)[0])

    def test_no_drop_at_high_capacity_matches_dense_mixture(self):
        """With capacity >> tokens, MoE == explicit top-k mixture."""
        moe, rmoe, pp, rp = self.make(cf=64.0)
        x, rx = inputs(np.random.default_rng(2), (1, 8, 32))
        y, _ = moe_block(pp, x, moe)
        t = x.reshape(-1, 32)
        probs = torch.softmax(t @ pp["router"], -1)
        top_p, top_e = torch.topk(probs, moe.top_k)
        top_p = top_p / top_p.sum(-1, keepdim=True)
        g = torch.einsum("td,edh->teh", t, pp["w_gate"])
        u = torch.einsum("td,edh->teh", t, pp["w_up"])
        ye = torch.einsum("teh,ehd->ted", torch.nn.functional.silu(g) * u,
                          pp["w_down"])
        ref = torch.zeros_like(t)
        for kk in range(moe.top_k):
            ref += top_p[:, kk:kk + 1] * ye[torch.arange(8), top_e[:, kk]]
        torch.testing.assert_close(y.reshape(-1, 32), ref, rtol=1e-4,
                                   atol=1e-4)
        close(y, ref_moe.moe_block(rp, rx, rmoe)[0])

    def test_capacity_drops_bounded(self):
        """Low capacity drops tokens but output stays finite & bounded."""
        moe, rmoe, pp, rp = self.make(cf=0.5)
        x, rx = inputs(np.random.default_rng(3), (2, 32, 32))
        y, _ = moe_block(pp, x, moe)
        assert bool(torch.isfinite(y).all())
        close(y, ref_moe.moe_block(rp, rx, rmoe)[0])


# ---------------------------------------------------------------------------
# CodedMoE
# ---------------------------------------------------------------------------


MASKS = (None, np.asarray([True, False, True, True, False, True]),
         np.asarray([False, True, True, False, True, True]))


@pytest.mark.parametrize("shared", [0, 1])
def test_coded_moe_parity_under_stragglers(shared):
    """``CodedMoE`` under no mask and two straggler masks against
    ``moe_block`` of both packages (``tests/test_api_plan.py``)."""
    moe_kw = dict(n_experts=4, top_k=2, d_expert=32,
                  n_shared_experts=shared)
    moe, rmoe = configs(**moe_kw)
    pp, rp = params(moe_kw, 16)
    x, rx = inputs(np.random.default_rng(21), (2, 8, 16))
    ref, aux_ref = ref_moe.moe_block(rp, rx, rmoe)
    own, _ = moe_block(pp, x, moe)
    cm = CodedMoE(pp, moe, n_workers=6, stragglers=2, backend="auto")
    assert set(cm.backends()) <= {"reference", "packed"}
    assert len(cm.gate) == len(cm.up) == len(cm.down) == 4
    assert [pl.seed for pl in cm.gate] == [0, 1, 2, 3]
    cm.detach()                           # in process: nothing to withdraw
    for done in MASKS:
        out, aux = cm(x, done)
        close(out, ref, CODED)
        torch.testing.assert_close(out, own, **CODED)
        np.testing.assert_allclose(float(aux), float(aux_ref), rtol=1e-6)


def test_coded_moe_with_drops_matches():
    """At capacity 1.25 the coded path drops the slots ``moe_block``
    drops."""
    moe_kw = dict(n_experts=8, top_k=2, d_expert=32, capacity_factor=1.25)
    moe, rmoe = configs(**moe_kw)
    pp, rp = params(moe_kw, 32)
    x, rx = inputs(np.random.default_rng(4), (2, 12, 32))
    ref, _ = ref_moe.moe_block(rp, rx, rmoe)
    cm = CodedMoE(pp, moe, backend="packed")
    for done in MASKS:
        close(cm(x, done)[0], ref, CODED)


@pytest.mark.parametrize("backend", ["packed", "cuda"])
def test_coded_moe_pipelines_experts_on_fleet(backend):
    """The fleet path against the in-process one (``tests/test_fleet.py``):
    bitwise on ``packed``; on ``cuda``, the card workers' path on the CPU
    (the kernels' plain versions sum in another order than the in-process
    plan's), within 2e-5."""
    moe_kw = dict(n_experts=2, top_k=1, d_expert=48)
    moe, _ = configs(**moe_kw)
    pp, _ = params(moe_kw, 64)
    x, _ = inputs(np.random.default_rng(0), (2, 4, 64))
    done = np.ones(6, bool)
    done[[1, 4]] = False
    local = CodedMoE(pp, moe, n_workers=6, stragglers=2, backend=backend)
    with CodedFleet(6, max_inflight=4, device="cpu",
                    backend=backend) as fleet:
        dispatched = CodedMoE(pp, moe, n_workers=6, stragglers=2,
                              backend=backend, fleet=fleet)
        assert dispatched.backends() == [backend] * 2
        o_fleet, aux_f = dispatched(x, done)
        o_local, aux_l = local(x, done)
        if backend == "packed":
            assert torch.equal(o_fleet, o_local)
        else:
            torch.testing.assert_close(o_fleet, o_local, **TOL)
        assert float(aux_f) == float(aux_l)
        # 3 plans per expert attached and served
        assert len(dispatched.gate[0].reports) == 1
        dispatched.detach()
        assert not fleet._plans
