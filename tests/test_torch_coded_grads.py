"""The port's ``CodedAggregator`` against the JAX package's: the same
encoding matrix, the same decode coefficients under every straggler
pattern (one solve per pattern, then cache hits), the same sums, and the
aggregate served by real workers (a private cluster, and a fleet shared
with the serve engine's coded head).

Inputs come from a numpy seed and cross to both packages as numpy
arrays.  Port and reference are held to f32 ``rtol=atol=2e-5``, plus,
for a decoded sum, the f32 rounding its decode coefficients amplify:
each payload and the k-term combine round at 2^-24, scaled by
sum_i |a_i| |p_i| (``decode_bound``; large where R[rows] is
ill-conditioned, e.g. at n=10, s=3).  The decoded sum is held against
the direct sum of the shard gradients to the reference test's 5e-3 (an
f32 k x k decode, ``tests/test_coded_grads.py``).
"""

import itertools
import unittest.mock as mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import repro.configs as ref_configs
import repro.models as ref_models
from repro.parallel.coded_grads import CodedAggregator as RefAggregator
import repro_torch.configs as port_configs
from repro_torch.api.fleet import CodedFleet
from repro_torch.configs.base import CodedConfig
from repro_torch.convert import model_params_from_reference
from repro_torch.core.weights import min_weight
from repro_torch.models import build_model
from repro_torch.parallel import CodedAggregator
from repro_torch.serve import ServeEngine

TOL = dict(rtol=2e-5, atol=2e-5)
SUM = dict(rtol=5e-3, atol=5e-3)
CPU = torch.device("cpu")


def shard_grads(rng, k, shapes=((3, 4), (5,))):
    """k shard gradients as numpy trees {"w", "b"}."""
    return [{name: rng.standard_normal(shape).astype(np.float32)
             for name, shape in zip(("w", "b"), shapes)} for _ in range(k)]


def both(grads):
    """The same trees for the port (tensors) and the reference."""
    return ([{n: torch.from_numpy(v) for n, v in g.items()} for g in grads],
            [{n: jnp.asarray(v) for n, v in g.items()} for g in grads])


def close(port, ref, tol=TOL):
    for name in ref:
        np.testing.assert_allclose(port[name].cpu().numpy(),
                                   np.asarray(ref[name]), **tol)


def decode_bound(agg, payloads, done) -> dict:
    """Per leaf, 2k 2^-24 sum_i |a_i| |p_i| over the decoded rows."""
    a, rows = agg.decode_coeffs(done)
    k = len(rows)
    return {name: 2 * k * 2.0 ** -24 * sum(
        abs(float(a[j])) * np.abs(payloads[int(r)][name].numpy())
        for j, r in enumerate(rows)) for name in payloads[0]}


def close_decoded(port, ref, bound):
    """|port - ref| <= 2e-5 + bound + 2e-5 |ref|, element by element."""
    for name in ref:
        got, want = port[name].cpu().numpy(), np.asarray(ref[name])
        excess = np.abs(got - want) - (2e-5 + bound[name]
                                       + 2e-5 * np.abs(want))
        assert excess.max() <= 0, (name, float(excess.max()))


def direct_sum(grads):
    return {name: np.sum([g[name] for g in grads], axis=0)
            for name in grads[0]}


def pair(n, s, seed):
    return (CodedAggregator.build(n, s, seed=seed, device=CPU),
            RefAggregator.build(n, s, seed=seed))


def payloads_of(agg, ref, grads):
    pg, rg = both(grads)
    n = agg.scheme.n
    return ([agg.worker_payload(i, pg) for i in range(n)],
            [ref.worker_payload(i, rg) for i in range(n)])


@pytest.mark.parametrize("n,s", [(6, 2), (12, 3), (10, 3)])
def test_exact_sum_all_patterns(n, s):
    rng = np.random.default_rng(n * 10 + s)
    agg, ref = pair(n, s, 1)
    np.testing.assert_array_equal(agg.R.numpy(), np.asarray(ref.R))
    grads = shard_grads(rng, n - s)
    pp, rp = payloads_of(agg, ref, grads)
    for i in range(n):
        close(pp[i], rp[i])
    expected = direct_sum(grads)
    patterns = list(itertools.combinations(range(n), s))
    if len(patterns) > 40:
        idx = rng.choice(len(patterns), 40, replace=False)
        patterns = [patterns[i] for i in idx]
    for pat in patterns:
        done = np.ones(n, bool)
        done[list(pat)] = False
        out = agg.aggregate(pp, done)
        close_decoded(out, ref.aggregate(rp, jnp.asarray(done)),
                      decode_bound(agg, pp, done))
        close(out, expected, SUM)


def test_decode_coeffs_match_with_one_solve_per_pattern():
    """Every C(6,2) pattern: the reference's coefficients and rows, one
    k x k inversion the first time, a cache hit every time after."""
    agg, ref = pair(6, 2, 1)
    patterns = list(itertools.combinations(range(6), 2))
    inv_calls = {"n": 0}
    real_inv = np.linalg.inv

    def counting_inv(a):
        inv_calls["n"] += 1
        return real_inv(a)

    cache = agg.plan()._decode_cache()
    misses0 = cache.misses
    with mock.patch.object(np.linalg, "inv", counting_inv):
        for _ in range(2):
            for pat in patterns:
                done = np.ones(6, bool)
                done[list(pat)] = False
                a, rows = agg.decode_coeffs(done)
                ra, rrows = ref.decode_coeffs(jnp.asarray(done))
                np.testing.assert_array_equal(a.numpy(), np.asarray(ra))
                np.testing.assert_array_equal(rows.numpy(), np.asarray(rrows))
    # the port's cache and the reference's each solved every pattern once
    assert cache.misses - misses0 == len(patterns)
    assert inv_calls["n"] == 2 * len(patterns)
    assert cache.hits >= len(patterns)


def test_weight_below_classical_gradient_coding():
    """Classical exact gradient coding uses weight s+1; this code meets
    the Prop. 1 bound, strictly lower when s <= k <= s^2."""
    agg, ref = pair(12, 3, 0)                     # k=9, s=3
    assert agg.shard_assignment == ref.shard_assignment
    w = max(len(t) for t in agg.shard_assignment)
    assert w == min_weight(12, 3) == 3 < 4        # classical = s+1 = 4


@given(st.integers(1, 4), st.data())
@settings(max_examples=15, deadline=None)
def test_property_random_system(s, data):
    k = data.draw(st.integers(max(2, s), s * s + 2))
    n = k + s
    rng = np.random.default_rng(data.draw(st.integers(0, 2**31)))
    agg, ref = pair(n, s, int(rng.integers(100)))
    grads = shard_grads(rng, k)
    pp, rp = payloads_of(agg, ref, grads)
    done = np.ones(n, bool)
    done[rng.choice(n, s, replace=False)] = False
    out = agg.aggregate(pp, done)
    close_decoded(out, ref.aggregate(rp, jnp.asarray(done)),
                  decode_bound(agg, pp, done))
    close(out, direct_sum(grads), SUM)


def test_worker_compute_budget():
    """Each worker touches exactly omega shards (the compute saving vs
    dense replication)."""
    agg, ref = pair(12, 3, 0)
    assert agg.shard_assignment == ref.shard_assignment
    for sup in agg.shard_assignment:
        assert len(sup) == 3


def test_coded_aggregator_lru_reuse():
    """Repeated steps under the same done mask reuse the cached inverse
    instead of re-solving a k x k system (``tests/test_api_plan.py``)."""
    rng = np.random.default_rng(20)
    agg, ref = pair(6, 2, 1)
    grads = [{"w": rng.standard_normal((3,)).astype(np.float32)}
             for _ in range(4)]
    pp, rp = payloads_of(agg, ref, grads)
    done = np.asarray([True, False, True, True, False, True])

    inv_calls = {"n": 0}
    real_inv = np.linalg.inv

    def counting_inv(a):
        inv_calls["n"] += 1
        return real_inv(a)

    with mock.patch.object(np.linalg, "inv", counting_inv):
        for _ in range(5):
            out = agg.aggregate(pp, done)
    close(out, ref.aggregate(rp, jnp.asarray(done)))
    close(out, direct_sum(grads), TOL)
    assert inv_calls["n"] == 1                     # one solve, 4 hits


def test_grad_tracking_R_takes_the_solve_path():
    """An R that requires grad solves a^T R[rows] = 1^T in the graph (the
    reference's traced branch); a equals the cached coefficients."""
    agg, _ = pair(6, 2, 1)
    done = np.asarray([True, True, False, True, False, True])
    a_cached, rows_cached = agg.decode_coeffs(done)
    R = agg.R.clone().requires_grad_(True)
    graded = CodedAggregator(scheme=agg.scheme, R=R, seed=agg.seed)
    a, rows = graded.decode_coeffs(torch.as_tensor(done))
    assert a.requires_grad
    np.testing.assert_array_equal(rows.numpy(), rows_cached.numpy())
    torch.testing.assert_close(a.detach(), a_cached, **TOL)
    a.sum().backward()
    assert R.grad is not None and torch.isfinite(R.grad).all()


def test_build_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CodedAggregator.build(6, 2)
    assert CodedAggregator.build(6, 2, device="cpu").R.device.type == "cpu"


def test_coded_aggregator_cluster_mode():
    """``to_cluster()`` serves the combine from real workers: within TOL
    of the in-process aggregate and of the JAX package's, and the sum of
    the shard gradients (``tests/test_cluster.py``)."""
    rng = np.random.default_rng(8)
    agg, ref = pair(6, 2, 1)
    grads = [{"w": rng.standard_normal((3, 2)).astype(np.float32)}
             for _ in range(agg.scheme.k_A)]
    pp, rp = payloads_of(agg, ref, grads)
    done = np.ones(6, bool)
    done[5] = False
    want = agg.aggregate(pp, done)
    close(want, ref.aggregate(rp, jnp.asarray(done)))
    with agg.to_cluster() as cl:
        got = agg.aggregate(pp, done, cluster=cl)
        raced = agg.aggregate(pp, cluster=cl)
    close(got, {"w": want["w"].numpy()})
    close(got, direct_sum(grads), TOL)
    close(raced, direct_sum(grads), SUM)
    with pytest.raises(ValueError, match="fleet's constructor"):
        agg.to_cluster(3, fleet=object())


@pytest.fixture(scope="module")
def qwen():
    cfg = ref_configs.get_smoke_config("qwen3-14b")
    jp = ref_models.build_model(cfg, dtype=jnp.float32).init(
        jax.random.key(0))
    pcfg = port_configs.get_smoke_config("qwen3-14b")
    params = model_params_from_reference(jax.tree.map(np.asarray, jp), pcfg,
                                         device=CPU)
    return pcfg, params


@pytest.mark.parametrize("backend", ["packed", "cuda"])
def test_engine_and_aggregator_share_one_fleet(qwen, backend):
    """The engine's coded head and the aggregator on one fleet
    (``tests/test_fleet.py``): the head within TOL of ``hidden @ head``,
    the aggregate within TOL of the in-process one, and still after the
    engine detaches.  ``cuda`` runs the card workers' path on the CPU
    (the kernels' plain versions): an aggregation-only plan attaches to
    card workers too."""
    pcfg, params = qwen
    rng = np.random.default_rng(0)
    model = build_model(pcfg, torch.float32, device=CPU)
    with CodedFleet(6, max_inflight=4, device="cpu",
                    backend=backend) as fleet:
        eng = ServeEngine(
            model, params, pcfg, batch_size=2, max_len=32,
            coded=CodedConfig(enabled=True, n_workers=6, stragglers=2,
                              backend=backend, fleet=fleet))
        agg = CodedAggregator.build(6, 2, seed=0, device=CPU)
        handle = agg.to_cluster(fleet=fleet)
        assert handle.fleet is fleet and eng.coded_cluster.fleet is fleet

        hidden = torch.from_numpy(rng.standard_normal(
            (2, pcfg.d_model)).astype(np.float32))
        head = params["embed"].T if pcfg.tie_embeddings else params["head"]
        torch.testing.assert_close(eng.coded_logits(hidden), hidden @ head,
                                   **TOL)

        grads = [{"g": rng.standard_normal(8).astype(np.float32)}
                 for _ in range(4)]
        pg, _ = both(grads)
        payloads = [agg.worker_payload(w, pg) for w in range(6)]
        done = np.ones(6, bool)
        want = agg.aggregate(payloads, done)
        got = agg.aggregate(payloads, done, cluster=handle)
        torch.testing.assert_close(got["g"], want["g"], **TOL)
        # the engine's close only detaches; the aggregator keeps serving
        eng.close()
        assert eng.coded_cluster is None
        again = agg.aggregate(payloads, done, cluster=handle)
        torch.testing.assert_close(again["g"], want["g"], **TOL)
