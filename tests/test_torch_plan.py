"""Plan API parity: ``repro_torch.api.compile_plan`` against
``repro.api.compile_plan`` for every registered scheme under every
straggler pattern, the error paths, ``retune`` / ``aggregate`` /
``prewarm``, the automatic backend pick, carrying a reference plan's
state across (``plan_from_reference_arrays``), and one whole-slice run
(compile -> matvec and matmat under stragglers) at the same seed."""

import itertools
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as japi
import repro.runtime as jrt
import repro_torch.api as tapi
import repro_torch.api.backends as tbackends
from repro_torch import plan_from_reference_arrays
from repro_torch.core import system_matrix

# tiny shapes: one intra-op thread is enough, and idle OpenMP threads
# would spin on cores that the suite's timing-sensitive tests share
torch.set_num_threads(1)

TOL = dict(rtol=5e-3, atol=5e-3)          # tests/test_api_plan.py:34
TIGHT = dict(rtol=2e-4, atol=2e-4)


def block_sparse(rng, t, r, zeros, bs=8):
    mask = rng.random((t // bs, r // bs)) >= zeros
    a = rng.standard_normal((t, r)).astype(np.float32)
    return a * np.kron(mask, np.ones((bs, bs), np.float32))


def all_masks(n, s):
    for pat in itertools.combinations(range(n), s):
        done = np.ones(n, bool)
        done[list(pat)] = False
        yield done


def close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), **tol)


def compile_kwargs(info):
    if info.hetero:
        return {"capacities": [2, 1, 1, 1], "k_A": 3}
    if info.kind == "mm":
        return {"n": 6, "k_A": 2, "k_B": 2}
    return {"n": 6, "k_A": 4}


# ---------------------------------------------------------------------------
# Every registered scheme x every straggler pattern
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind,name", [(i.kind, i.name)
                                       for i in japi.list_schemes()])
def test_compile_plan_parity_every_scheme(kind, name):
    info = japi.scheme_info(name, kind)
    kw = compile_kwargs(info)
    rng = np.random.default_rng(sum(map(ord, name)) + len(kind))
    A = rng.standard_normal((24, 16)).astype(np.float32)
    jplan = japi.compile_plan(jnp.asarray(A), scheme=name, backend="reference",
                              seed=3, **kw)
    plans = [tapi.compile_plan(torch.from_numpy(A), scheme=name, backend=b,
                               seed=3, **kw) for b in ("reference", "cuda")]
    for plan in plans:
        np.testing.assert_array_equal(plan.G, jplan.G)
        assert plan.describe()["weight"] == jplan.describe()["weight"]
    masks = (list(all_masks(jplan.n, jplan.s)) if info.straggler_resilient
             else [np.ones(jplan.n, bool)])
    if kind == "mv":
        x = rng.standard_normal((2, 24)).astype(np.float32)
        for done in masks:
            want = np.asarray(jplan.matvec(jnp.asarray(x), jnp.asarray(done)))
            close(want, x @ A)
            for plan in plans:
                close(plan.matvec(torch.from_numpy(x), done), want)
    else:
        B = rng.standard_normal((24, 10)).astype(np.float32)
        for done in masks:
            want = np.asarray(jplan.matmat(jnp.asarray(B), jnp.asarray(done)))
            close(want, A.T @ B)
            for plan in plans:
                close(plan.matmat(torch.from_numpy(B), done), want)


# ---------------------------------------------------------------------------
# Error paths, retune, aggregate, prewarm
# ---------------------------------------------------------------------------


def test_error_paths_match_reference():
    A = torch.ones(16, 8)
    mv = tapi.compile_plan(A, scheme="proposed", n=6, k_A=4,
                           backend="reference")
    mm = tapi.compile_plan(A, scheme="proposed", n=6, k_A=2, k_B=2,
                           backend="reference")
    agg = tapi.compile_plan(scheme="proposed", n=6, s=2, device="cpu")
    with pytest.raises(ValueError, match="mm plan"):
        mv.matmat(A)
    with pytest.raises(ValueError, match="mv plan"):
        mm.matvec(A[0])
    with pytest.raises(ValueError, match="mv plan"):
        mm.aggregate([])
    with pytest.raises(ValueError, match="without an operand"):
        agg.matvec(A[0])
    with pytest.raises(ValueError, match="holds no shards"):
        agg.worker_tile_counts()
    with pytest.raises(ValueError, match="2-D"):
        tapi.compile_plan(torch.ones(2, 3, 4), scheme="proposed", n=6, k_A=4)
    with pytest.raises(ValueError, match="no operand"):
        agg.retune()
    for kw, exc, msg in [
            ({"name": "nope", "n": 6, "k_A": 4}, KeyError, "unknown mv"),
            ({"name": "proposed", "k_A": 4}, ValueError, "n="),
            ({"name": "proposed", "n": 6}, ValueError, "k_A= or s="),
            ({"name": "proposed", "n": 6, "k_A": 4, "s": 3}, ValueError,
             "inconsistent"),
            ({"name": "proposed-hetero", "k_A": 3}, ValueError, "capacities")]:
        name = kw.pop("name")
        with pytest.raises(exc, match=msg):
            japi.make_scheme(name, **kw)
        with pytest.raises(exc, match=msg):
            tapi.make_scheme(name, **kw)
    with pytest.raises(ValueError, match="already registered"):
        tapi.register_scheme("proposed", "mv")(lambda n, k_A: None)


def test_prewarm_and_cache_reuse():
    rng = np.random.default_rng(13)
    A = torch.from_numpy(block_sparse(rng, 64, 48, zeros=0.99))
    plan = tapi.compile_plan(A, scheme="proposed", n=6, k_A=4,
                             backend="cuda")
    cache = plan.executor.cache
    assert (cache.hits, cache.misses) == (0, 1)    # all-alive prewarmed
    x = torch.from_numpy(rng.standard_normal((64,)).astype(np.float32))
    plan.matvec(x)                                  # all-alive -> hit
    assert (cache.hits, cache.misses) == (1, 1)
    done = torch.tensor([True, False, True, True, False, True])
    plan.matvec(x, done)
    plan.matvec(x, done.numpy())
    assert (cache.hits, cache.misses) == (2, 2)
    plan.prewarm(np.array([0, 1, 1, 1, 1, 0], bool))
    assert (cache.hits, cache.misses) == (2, 3)
    assert plan.describe()["decode_cache"] == {"hits": 2, "misses": 3}
    ref = tapi.compile_plan(A, scheme="proposed", n=6, k_A=4,
                            backend="reference")
    assert ref.prewarm() is ref and ref.executor.cache is None


def test_aggregate_matches_sum_reference_and_caches():
    n, s = 6, 2
    rng = np.random.default_rng(14)
    jplan = japi.compile_plan(scheme="proposed", n=n, s=s)
    plan = tapi.compile_plan(scheme="proposed", n=n, s=s, device="cpu")
    R, k = plan.G, plan.k
    np.testing.assert_array_equal(R, jplan.G)
    grads = [rng.standard_normal((3, 4)).astype(np.float32) for _ in range(k)]
    payloads = [sum(R[i, q] * grads[q] for q in plan.scheme.supports[i])
                .astype(np.float32) for i in range(n)]
    t_payloads = [{"w": torch.from_numpy(p), "b": [torch.from_numpy(p[0])]}
                  for p in payloads]
    j_payloads = [{"w": jnp.asarray(p), "b": [jnp.asarray(p[0])]}
                  for p in payloads]
    expect = sum(grads)
    for done in all_masks(n, s):
        out = plan.aggregate(t_payloads, done)
        close(out["w"], expect)
        close(out["b"][0], expect[0])
        close(out["w"], jplan.aggregate(j_payloads, jnp.asarray(done))["w"],
              TIGHT)
    cache = plan._decode_cache()
    first = (cache.hits, cache.misses)
    plan.aggregate(t_payloads, np.array([0, 0, 1, 1, 1, 1], bool))
    assert (cache.hits, cache.misses) == (first[0] + 1, first[1])


def test_retune_follows_density():
    rng = np.random.default_rng(15)
    sparse = torch.from_numpy(block_sparse(rng, 128, 64, zeros=0.99))
    dense = torch.from_numpy(rng.standard_normal((128, 64)).astype(np.float32))
    plan = tapi.compile_plan(sparse, scheme="proposed", n=6, k_A=4,
                             backend="auto")
    assert plan.backend == "packed"
    executor = plan.executor
    assert plan.retune() == "packed" and plan.executor is executor  # no-op
    assert plan.retune(dense) == "reference"
    x = torch.from_numpy(rng.standard_normal((128,)).astype(np.float32))
    close(plan.matvec(x, np.array([1, 0, 1, 1, 0, 1], bool)),
          x.numpy() @ dense.numpy())
    assert plan.retune(sparse, crossover=0.999) == "reference"


def test_delta_partition_worker_mask_expansion():
    rng = np.random.default_rng(16)
    A = torch.from_numpy(rng.standard_normal((24, 16)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((24,)).astype(np.float32))
    plan = tapi.compile_plan(A, scheme="scs36", n=6, k_A=4, backend="cuda")
    assert plan.tasks_per_worker == 3 and plan.n_tasks == 18
    for done in (np.array([1, 0, 1, 1, 0, 1], bool),
                 torch.tensor([True, False, True, True, False, True])):
        close(plan.matvec(x, done), x.numpy() @ A.numpy())


# ---------------------------------------------------------------------------
# Automatic backend choice
# ---------------------------------------------------------------------------


class TestAutoBackend:
    def test_block_zero_fraction_matches_reference(self):
        rng = np.random.default_rng(8)
        for a in (block_sparse(rng, 128, 64, 0.9),
                  rng.standard_normal((20, 13)).astype(np.float32),
                  np.zeros((16, 16), np.float32)):
            assert tapi.block_zero_fraction(a) == japi.block_zero_fraction(a)
            assert (tapi.block_zero_fraction(torch.from_numpy(a))
                    == japi.block_zero_fraction(a))

    def test_density_pick_on_cpu_and_device_pick(self, monkeypatch):
        monkeypatch.delenv("REPRO_CODED_BACKEND", raising=False)
        rng = np.random.default_rng(9)
        sparse = block_sparse(rng, 128, 64, zeros=0.99)
        mid = block_sparse(rng, 128, 64, zeros=0.5)
        assert tapi.choose_backend(torch.from_numpy(sparse)) == "packed"
        assert tapi.choose_backend(torch.from_numpy(mid), "auto") == \
            "reference"
        assert tapi.choose_backend(None) == "reference"
        # an operand on a CUDA device takes the kernels, whatever its density
        assert tapi.choose_backend(mid, "auto", device="cuda") == "cuda"
        assert tapi.choose_backend(None, device="cuda:0") == "cuda"
        assert tapi.choose_backend(mid, "packed") == "packed"
        with pytest.raises(ValueError, match="unknown coded backend"):
            tapi.choose_backend(mid, "nope")

    def test_env_override_beats_auto(self, monkeypatch):
        rng = np.random.default_rng(10)
        sparse = block_sparse(rng, 64, 32, zeros=0.995)
        monkeypatch.setenv("REPRO_CODED_BACKEND", "reference")
        assert tapi.choose_backend(sparse, "auto", device="cuda") == \
            "reference"
        monkeypatch.setenv("REPRO_CODED_BACKEND", "auto")
        assert tapi.choose_backend(sparse, "packed") == "packed"
        assert tapi.choose_backend(sparse, "auto") == "packed"
        monkeypatch.setenv("REPRO_CODED_BACKEND", "pallas")
        with pytest.raises(ValueError, match="cuda"):
            tapi.choose_backend(sparse, "auto")

    def test_crossover_never_reads_the_reference_bench(self, tmp_path,
                                                       monkeypatch):
        """The auto pick uses DEFAULT_DENSITY_CROSSOVER only; an explicit
        bench file parses as the reference parses it."""
        payload = {"results": [
            {"zeros": 0.95, "backend": "packed", "speedup_vs_reference": 0.6},
            {"zeros": 0.98, "backend": "packed", "speedup_vs_reference": 1.4},
        ]}
        p = tmp_path / "BENCH_runtime.json"
        p.write_text(json.dumps(
            {"results": [{"zeros": 0.5, "speedup_vs_reference": 2.0}]}))
        monkeypatch.chdir(tmp_path)
        monkeypatch.setenv("REPRO_BENCH_RUNTIME", str(p))
        monkeypatch.delenv("REPRO_CODED_BACKEND", raising=False)
        mid = block_sparse(np.random.default_rng(22), 128, 64, zeros=0.7)
        assert tapi.choose_backend(mid, "auto") == "reference"
        p.write_text(json.dumps(payload))
        assert tapi.density_crossover(str(p)) == japi.density_crossover(str(p))
        assert tapi.density_crossover(None) == \
            tbackends.DEFAULT_DENSITY_CROSSOVER == japi.DEFAULT_DENSITY_CROSSOVER


# ---------------------------------------------------------------------------
# Carrying a reference plan's state across
# ---------------------------------------------------------------------------


def export(jplan, k_A, k_B=None):
    meta = {"scheme": jplan.scheme.name, "kind": jplan.kind, "n": jplan.n,
            "s": jplan.s, "k_A": k_A, "k_B": k_B, "seed": jplan.seed,
            "r": jplan.r, "backend": jplan.backend}
    arrays = {"G": jplan.G, "coded": np.asarray(jplan.executor.coded)}
    if jplan.kind == "mm":
        arrays.update(rb=jplan._rb, sup_b=jplan._sup_b, coef_b=jplan._coef_b)
    return meta, arrays


@pytest.mark.parametrize("jbackend", ["pallas-interpret", "packed"])
def test_plan_from_reference_arrays(jbackend):
    rng = np.random.default_rng(17)
    A = block_sparse(rng, 64, 48, zeros=0.5)
    x = rng.standard_normal((3, 64)).astype(np.float32)
    done = np.array([1, 0, 1, 1, 0, 1], bool)
    jmv = japi.compile_plan(jnp.asarray(A), scheme="proposed", n=6, k_A=4,
                            backend=jbackend, seed=5)
    plan = plan_from_reference_arrays(*export(jmv, 4), device="cpu")
    assert plan.backend == ("cuda" if jbackend == "pallas-interpret"
                            else "packed")
    np.testing.assert_array_equal(plan.G, system_matrix(plan.scheme, 5))
    np.testing.assert_array_equal(plan.executor.coded.numpy(),
                                  np.asarray(jmv.executor.coded))
    close(plan.matvec(torch.from_numpy(x), done),
          jmv.matvec(jnp.asarray(x), jnp.asarray(done)), TIGHT)

    B = rng.standard_normal((64, 20)).astype(np.float32)
    done = np.ones(12, bool)
    done[[1, 6, 10]] = False
    jmm = japi.compile_plan(jnp.asarray(A), scheme="proposed", n=12, k_A=3,
                            k_B=3, backend=jbackend, seed=5)
    plan = plan_from_reference_arrays(*export(jmm, 3, 3), device="cpu")
    np.testing.assert_array_equal(plan.G, system_matrix(plan.scheme, 5))
    close(plan.matmat(torch.from_numpy(B), done),
          jmm.matmat(jnp.asarray(B), jnp.asarray(done)), TIGHT)


def test_plan_from_reference_arrays_bf16_shards():
    rng = np.random.default_rng(18)
    A = rng.standard_normal((32, 24)).astype(np.float32)
    jplan = japi.compile_plan(jnp.asarray(A, jnp.bfloat16), scheme="proposed",
                              n=6, k_A=4, backend="packed")
    plan = plan_from_reference_arrays(*export(jplan, 4), device="cpu")
    assert plan.executor.coded.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        plan.executor.coded.float().numpy(),
        np.asarray(jplan.executor.coded).astype(np.float32))


# ---------------------------------------------------------------------------
# The cuda backend's decode layouts, every straggler pattern
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("x_shape", [(40,), (1, 40), (3, 40)],
                         ids=["vector", "batch1", "batch3"])
def test_cuda_matvec_layout_all_patterns(x_shape):
    """plan.matvec on cuda (plain versions on CPU tensors) stores (b, r)
    straight from the decode: r = 30 clips the last unknown (k_A = 4,
    c = 8), and a 1-D x returns (r,)."""
    rng = np.random.default_rng(len(x_shape) * 7 + x_shape[0])
    A = rng.standard_normal((40, 30)).astype(np.float32)
    x = rng.standard_normal(x_shape).astype(np.float32)
    jplan = japi.compile_plan(jnp.asarray(A), scheme="proposed", n=6, s=2,
                              backend="packed", seed=5)
    plan = tapi.compile_plan(torch.from_numpy(A), scheme="proposed", n=6,
                             s=2, backend="cuda", seed=5)
    for done in all_masks(6, 2):
        got = plan.matvec(torch.from_numpy(x), done)
        want = np.asarray(jplan.matvec(jnp.asarray(x), jnp.asarray(done)))
        assert got.shape == want.shape == x_shape[:-1] + (30,)
        assert got.is_contiguous()
        close(got, want, TIGHT)


@pytest.mark.parametrize("r,w", [(30, 22), (32, 24), (25, 9)])
def test_cuda_matmat_layout_all_patterns(r, w):
    """plan.matmat on cuda gets (r, w) from one decode; r and w need not
    be multiples of k_A * 32 or k_B."""
    rng = np.random.default_rng(r * w)
    A = rng.standard_normal((36, r)).astype(np.float32)
    B = rng.standard_normal((36, w)).astype(np.float32)
    jplan = japi.compile_plan(jnp.asarray(A), scheme="proposed", n=6, k_A=2,
                              k_B=2, backend="packed", seed=2)
    plan = tapi.compile_plan(torch.from_numpy(A), scheme="proposed", n=6,
                             k_A=2, k_B=2, backend="cuda", seed=2)
    for done in all_masks(6, 2):
        got = plan.matmat(torch.from_numpy(B), done)
        want = np.asarray(jplan.matmat(jnp.asarray(B), jnp.asarray(done)))
        assert got.shape == want.shape == (r, w) and got.is_contiguous()
        close(got, want, TIGHT)
        close(got, A.T @ B, dict(rtol=1e-3, atol=1e-3))


# ---------------------------------------------------------------------------
# The whole slice
# ---------------------------------------------------------------------------


def test_whole_slice_against_reference():
    """compile_plan -> encode -> pack -> fastest-k products -> cached
    decode, on the cuda backend (plain versions on CPU tensors), against
    the reference plan on pallas-interpret at the same seed."""
    rng = np.random.default_rng(19)
    A = block_sparse(rng, 96, 72, zeros=0.8)
    x = rng.standard_normal((4, 96)).astype(np.float32)
    jmv = japi.compile_plan(jnp.asarray(A), scheme="proposed", n=8, s=2,
                            backend="pallas-interpret", seed=11)
    mv = tapi.compile_plan(torch.from_numpy(A), scheme="proposed", n=8, s=2,
                           backend="cuda", seed=11)
    close(mv.executor.coded, jmv.executor.coded, TIGHT)
    # the cuda backend packs 32 x 32 tiles; the reference packer agrees at
    # that tile size
    np.testing.assert_array_equal(
        mv.worker_tile_counts(),
        jrt.pack_coded_blocks(np.asarray(jmv.executor.coded), 32, 32)
        .tile_counts)
    for done in (np.ones(8, bool), np.array([1, 1, 0, 1, 1, 1, 0, 1], bool),
                 np.array([0, 1, 1, 1, 0, 1, 1, 1], bool)):
        close(mv.matvec(torch.from_numpy(x), done),
              jmv.matvec(jnp.asarray(x), jnp.asarray(done)), TIGHT)

    B = block_sparse(rng, 96, 40, zeros=0.8)
    jmm = japi.compile_plan(jnp.asarray(A), scheme="proposed", n=20, k_A=4,
                            k_B=4, backend="packed", seed=11)
    mm = tapi.compile_plan(torch.from_numpy(A), scheme="proposed", n=20,
                           k_A=4, k_B=4, backend="cuda", seed=11)
    done = np.ones(20, bool)
    done[[0, 7, 13, 19]] = False
    out = mm.matmat(torch.from_numpy(B), done)
    close(out, jmm.matmat(jnp.asarray(B), jnp.asarray(done)), TIGHT)
    close(out, A.T @ B, dict(rtol=1e-3, atol=1e-3))
