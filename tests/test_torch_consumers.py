"""The port's coded consumers against the JAX package's: ``CodedLinear``
(the counterparts of ``TestCodedLinear`` in ``tests/test_substrate.py``
and of the plan tests in ``tests/test_api_plan.py``), on the same
weights and seeds."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.parallel.coded_layer import CodedLinear as RefCodedLinear
from repro_torch.parallel import CodedLinear

TOL = dict(rtol=2e-5, atol=2e-5)
# the layer tolerance of tests/test_substrate.py: a decode multiplies the
# f32 rounding of both packages' products by cond(G[rows])
LAYER_TOL = dict(rtol=2e-4, atol=2e-4)


def t(x):
    return torch.as_tensor(np.asarray(x, np.float32))


def patterns(n, s):
    for pat in itertools.combinations(range(n), s):
        done = np.ones(n, bool)
        done[list(pat)] = False
        yield done


@pytest.mark.parametrize("backend", [None, "reference", "packed", "cuda"])
def test_matches_uncoded_and_reference_any_pattern(backend):
    rng = np.random.default_rng(0)
    w = rng.standard_normal((24, 36)).astype(np.float32)
    x = rng.standard_normal((5, 24)).astype(np.float32)
    layer = CodedLinear.build(t(w), n_workers=6, stragglers=2, seed=1,
                              backend=backend)
    ref_layer = RefCodedLinear.build(jnp.asarray(w), n_workers=6,
                                     stragglers=2, seed=1)
    assert layer.plan().seed == 1
    np.testing.assert_array_equal(layer.G.numpy(), np.asarray(ref_layer.G))
    for done in patterns(6, 2):
        out = layer.apply(t(x), done)
        np.testing.assert_allclose(out.numpy(), x @ w, **LAYER_TOL)
        np.testing.assert_allclose(
            out.numpy(), np.asarray(ref_layer.apply(jnp.asarray(x),
                                                    jnp.asarray(done))),
            **LAYER_TOL)


def test_storage_overhead_is_omega_over_k():
    layer = CodedLinear.build(torch.ones(16, 32), n_workers=6, stragglers=2)
    ref_layer = RefCodedLinear.build(jnp.ones((16, 32)), n_workers=6,
                                     stragglers=2)
    assert tuple(layer.coded.shape) == tuple(ref_layer.coded.shape) == \
        (6, 16, 8)
    np.testing.assert_array_equal(layer.coded.numpy(),
                                  np.asarray(ref_layer.coded))


def test_differentiable():
    rng = np.random.default_rng(1)
    w = rng.standard_normal((8, 12)).astype(np.float32)
    xv = rng.standard_normal((8,)).astype(np.float32)
    layer = CodedLinear.build(t(w), n_workers=4, stragglers=1, seed=0)
    x = t(xv).requires_grad_(True)
    layer.apply(x).sum().backward()
    ref = jax.grad(lambda x: (x @ jnp.asarray(w)).sum())(jnp.asarray(xv))
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(ref),
                               rtol=1e-3, atol=1e-3)
    ref_layer = RefCodedLinear.build(jnp.asarray(w), n_workers=4,
                                     stragglers=1, seed=0)
    g_ref = jax.grad(lambda x: ref_layer.apply(x).sum())(jnp.asarray(xv))
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(g_ref), **TOL)


def test_differentiable_through_the_weight():
    """A weight that requires grad builds a reference layer whose shards
    stay in the graph, and nothing of that graph is cached."""
    rng = np.random.default_rng(2)
    w = t(rng.standard_normal((8, 12))).requires_grad_(True)
    x = t(rng.standard_normal((3, 8)))
    layer = CodedLinear.build(w, n_workers=4, stragglers=1, seed=0,
                              backend="packed")
    assert layer._plan is None and layer.executor().backend == "reference"
    done = np.array([True, False, True, True])
    layer.apply(x, done).sum().backward()
    np.testing.assert_allclose(w.grad.numpy(),
                               np.repeat(x.sum(0).numpy()[:, None], 12, 1),
                               rtol=1e-4, atol=1e-4)


def test_coded_linear_exposes_its_plan():
    rng = np.random.default_rng(19)
    w = t(rng.standard_normal((16, 24)))
    layer = CodedLinear.build(w, 6, 2, seed=0, backend="packed")
    assert layer.plan().executor is layer.executor()
    assert layer.plan().backend == "packed"
    # a layer rebuilt from its fields compiles the same plan lazily
    again = CodedLinear(scheme=layer.scheme, coded=layer.coded, G=layer.G,
                        d_out=layer.d_out, backend="packed")
    x = t(rng.standard_normal((2, 16)))
    done = np.array([True, True, False, True, False, True])
    torch.testing.assert_close(again.apply(x, done), layer.apply(x, done),
                               rtol=0, atol=0)


def test_delta_partition_scheme():
    """Worker-level done masks expand to task rows through the plan
    (``tests/test_api_plan.py``'s scs36 case)."""
    rng = np.random.default_rng(23)
    w = rng.standard_normal((16, 24)).astype(np.float32)
    x = rng.standard_normal((3, 16)).astype(np.float32)
    layer = CodedLinear.build(t(w), 6, 2, seed=0, scheme="scs36")
    ref_layer = RefCodedLinear.build(jnp.asarray(w), 6, 2, seed=0,
                                     scheme="scs36")
    assert layer.scheme.tasks_per_worker == 3       # Delta = 12
    done = np.array([True, False, True, True, False, True])
    out = layer.apply(t(x), done)
    np.testing.assert_allclose(out.numpy(), x @ w, **TOL)
    np.testing.assert_allclose(
        out.numpy(), np.asarray(ref_layer.apply(jnp.asarray(x),
                                                jnp.asarray(done))), **TOL)
    # the reference path (x in a graph) takes the same expansion
    xg = t(x).requires_grad_(True)
    np.testing.assert_allclose(layer.apply(xg, done).detach().numpy(),
                               x @ w, **TOL)
    y = layer.worker_compute(t(x))
    assert tuple(y.shape) == (18, 3, layer.coded.shape[2])  # 3 per worker
    np.testing.assert_allclose(layer.decode(y, done).numpy(), x @ w, **TOL)


@pytest.mark.parametrize("trials", [1, 4])
def test_stability_trials_pick_the_reference_seed(trials):
    rng = np.random.default_rng(4)
    w = rng.standard_normal((12, 20)).astype(np.float32)
    layer = CodedLinear.build(t(w), 6, 2, stability_trials=trials)
    ref_layer = RefCodedLinear.build(jnp.asarray(w), 6, 2,
                                     stability_trials=trials)
    np.testing.assert_array_equal(layer.G.numpy(), np.asarray(ref_layer.G))
    np.testing.assert_array_equal(layer.coded.numpy(),
                                  np.asarray(ref_layer.coded))
