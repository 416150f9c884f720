"""Runtime parity: packing bitwise against ``repro.runtime.pack``, the
decode cache's hits, misses and LRU as in the reference, and the
executor's ``matvec`` / ``matmat`` / ``decode`` on ``cuda`` (CPU tensors,
so the kernels' plain versions) and ``packed`` against the reference
executor on ``pallas-interpret`` and ``packed`` over every straggler
pattern."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.runtime as jrt
from repro.core import mm_encoding_matrices, mv_encoding_matrix, proposed_mm
from repro.core import proposed_mv, system_matrix
from repro.core.coded_matmul import split_block_columns as j_split
from repro.core.encoding import khatri_rao_rows
from repro_torch import runtime as trt
from repro_torch.core import CodedOperator, poly_mv
from repro_torch.core import proposed_mv as t_proposed_mv
from repro_torch.core.weights import mv_weight

# tiny shapes: one intra-op thread is enough, and idle OpenMP threads
# would spin on cores that the suite's timing-sensitive tests share
torch.set_num_threads(1)

TOL = dict(rtol=2e-4, atol=2e-4)


def all_masks(n, s):
    for pat in itertools.combinations(range(n), s):
        done = np.ones(n, bool)
        done[list(pat)] = False
        yield done


def build_mv(rng, n, k, t, r, seed=0):
    sch = proposed_mv(n, k)
    A = rng.standard_normal((t, r)).astype(np.float32)
    R = mv_encoding_matrix(sch, seed)
    blocks = np.asarray(j_split(jnp.asarray(A), k))
    coded = np.einsum("nk,ktc->ntc", R, blocks).astype(np.float32)
    return A, coded, np.asarray(system_matrix(sch, seed))


def close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), **tol)


# ---------------------------------------------------------------------------
# Packing layer
# ---------------------------------------------------------------------------


class TestPacking:
    @pytest.mark.parametrize("t,c,bk,bm", [
        (32, 16, 8, 8),       # exact multiples
        (20, 9, 8, 8),        # both dims need padding
        (64, 8, 16, 8),       # rectangular tiles
        (70, 40, 32, 32),     # the cuda backend's tile
    ])
    def test_bitwise_and_round_trip(self, t, c, bk, bm):
        rng = np.random.default_rng(t * 100 + c + bk)
        coded = rng.standard_normal((5, t, c)).astype(np.float32)
        coded[:, : t // 2] *= rng.random((5, 1, 1)) > 0.5
        coded[1, :, : c // 2] = 0.0
        ref = jrt.pack_coded_blocks(coded, bk, bm)
        got = trt.pack_coded_blocks(torch.from_numpy(coded), bk, bm)
        np.testing.assert_array_equal(got.a_data.numpy(),
                                      np.asarray(ref.a_data))
        np.testing.assert_array_equal(got.a_idx.numpy(), np.asarray(ref.a_idx))
        assert got.a_idx.dtype == torch.int32
        assert got.tile_counts == ref.tile_counts
        assert got.slot_counts == ref.slot_counts
        np.testing.assert_array_equal(
            got.counts.numpy(), np.asarray(ref.slot_counts).reshape(-1))
        assert (got.n, got.mb, got.t_pad, got.c_pad, got.slots) == (
            ref.n, ref.mb, ref.t_pad, ref.c_pad, ref.slots)
        np.testing.assert_array_equal(trt.unpack_coded_blocks(got).numpy(),
                                      coded)
        for mine, theirs in zip(trt.bsr_shards(got), jrt.pack.bsr_shards(ref)):
            np.testing.assert_array_equal(mine.toarray(), theirs.toarray())

    def test_bf16_bitwise(self):
        rng = np.random.default_rng(1)
        coded = rng.standard_normal((3, 16, 16)).astype(np.float32)
        coded[:, :8] = 0.0
        ref = jrt.pack_coded_blocks(np.asarray(jnp.asarray(coded,
                                                           jnp.bfloat16)), 8, 8)
        got = trt.pack_coded_blocks(torch.from_numpy(coded).bfloat16(), 8, 8)
        np.testing.assert_array_equal(
            got.a_data.float().numpy(),
            np.asarray(ref.a_data).astype(np.float32))
        assert got.tile_counts == ref.tile_counts

    def test_select_workers_matches_views(self):
        rng = np.random.default_rng(2)
        coded = torch.from_numpy(rng.standard_normal((6, 16, 8)).astype(
            np.float32))
        packed = trt.pack_coded_blocks(coded, 8, 8)
        rows = np.array([4, 1, 3])
        sel_d, sel_i = packed.select_workers(rows)
        for j, i in enumerate(rows):
            vd, vi = packed.worker_view(int(i))
            lo, hi = j * packed.mb, (j + 1) * packed.mb
            assert torch.equal(sel_d[lo:hi], vd)
            assert torch.equal(sel_i[lo:hi], vi)


# ---------------------------------------------------------------------------
# Decode planner
# ---------------------------------------------------------------------------


class TestDecodeCache:
    def test_hits_misses_and_inverses_match_reference(self):
        rng = np.random.default_rng(2)
        G = rng.standard_normal((6, 4))
        ref, got = jrt.DecodeCache(G, 4), trt.DecodeCache(G, 4)
        masks = [np.array([1, 1, 0, 1, 1, 0], bool),
                 np.array([0, 1, 1, 1, 1, 0], bool)]
        for m in masks + masks[:1] + [torch.as_tensor(masks[1])]:
            p_ref, p_got = ref.plan(np.asarray(m)), got.plan(m)
            np.testing.assert_array_equal(p_got.hinv, p_ref.hinv)
            np.testing.assert_array_equal(p_got.rows, p_ref.rows)
            np.testing.assert_array_equal(p_got.hinv_dev.numpy(), p_ref.hinv)
            assert p_got.rows_dev.dtype == torch.int32
            assert p_got.key == p_ref.key
        assert (got.hits, got.misses) == (ref.hits, ref.misses) == (2, 2)
        np.testing.assert_array_equal(got.patterns(), ref.patterns())

    def test_lru_eviction(self):
        rng = np.random.default_rng(3)
        G = rng.standard_normal((6, 4))
        caches = [jrt.DecodeCache(G, 4, maxsize=2),
                  trt.DecodeCache(G, 4, maxsize=2)]
        for cache in caches:
            masks = [np.ones(6, bool) for _ in range(3)]
            for i, m in enumerate(masks):
                m[i] = False
                cache.plan(m)
            assert len(cache) == 2
            cache.plan(masks[0])              # evicted -> re-inverted
        assert caches[1].misses == caches[0].misses == 4

    def test_insufficient_workers_raises(self):
        cache = trt.DecodeCache(np.eye(4), 4)
        with pytest.raises(ValueError, match="need k"):
            cache.plan(np.array([1, 0, 1, 0], bool))
        with pytest.raises(ValueError, match="incompatible"):
            cache.plan(np.ones(5, bool))


# ---------------------------------------------------------------------------
# Executor parity over every straggler pattern
# ---------------------------------------------------------------------------


class TestExecutorParity:
    """Both port backends against the reference's two sparse backends,
    pattern by pattern; the reference runs once per pattern."""

    @staticmethod
    def port_executors(coded, G, k, r):
        return {b: trt.CodedExecutor(torch.from_numpy(coded), G, k, r,
                                     backend=b) for b in ("cuda", "packed")}

    def test_matvec_all_patterns(self):
        n, k, t, r, b = 6, 4, 40, 30, 3      # t, r and batch need padding
        rng = np.random.default_rng(5)
        A, coded, G = build_mv(rng, n, k, t, r)
        x = rng.standard_normal((b, t)).astype(np.float32)
        j_packed = jrt.CodedExecutor(coded, G, k, r, backend="packed")
        j_kernel = jrt.CodedExecutor(coded, G, k, r,
                                     backend="pallas-interpret")
        ports = self.port_executors(coded, G, k, r)
        for done in all_masks(n, n - k):
            want_p = j_packed.matvec(jnp.asarray(x), done)
            want_k = j_kernel.matvec(jnp.asarray(x), done)
            for ex in ports.values():
                got = ex.matvec(torch.from_numpy(x), done)
                close(got, want_p)
                close(got, want_k)
                close(got, x @ A, dict(rtol=2e-3, atol=2e-3))
        want = j_packed.matvec(jnp.asarray(x[0]))      # 1-d x, all alive
        for ex in ports.values():
            close(ex.matvec(torch.from_numpy(x[0])), want)
            assert (ex.cache.hits, ex.cache.misses) == (
                j_packed.cache.hits, j_packed.cache.misses)

    def test_matmat_all_patterns(self):
        n, ka, kb, t, ca, cb = 6, 2, 2, 24, 5, 7
        rng = np.random.default_rng(6)
        sch = proposed_mm(n, ka, kb)
        ra, rb = mm_encoding_matrices(sch, 0)
        G = khatri_rao_rows(ra, rb)
        A = rng.standard_normal((t, ka * ca)).astype(np.float32)
        B = rng.standard_normal((t, kb * cb)).astype(np.float32)
        coded_a = np.einsum("nk,ktc->ntc", ra, np.asarray(
            j_split(jnp.asarray(A), ka))).astype(np.float32)
        coded_b = np.einsum("nk,ktc->ntc", rb, np.asarray(
            j_split(jnp.asarray(B), kb))).astype(np.float32)
        k = ka * kb
        j_packed = jrt.CodedExecutor(coded_a, G, k, ka * ca, backend="packed")
        j_kernel = jrt.CodedExecutor(coded_a, G, k, ka * ca,
                                     backend="pallas-interpret")
        ports = self.port_executors(coded_a, G, k, ka * ca)
        for done in all_masks(n, n - k):
            want_p = j_packed.matmat(jnp.asarray(coded_b), done)
            want_k = j_kernel.matmat(jnp.asarray(coded_b), done)
            for ex in ports.values():
                got = ex.matmat(torch.from_numpy(coded_b), done)
                assert got.shape == (k, ca, cb)
                close(got, want_p)
                close(got, want_k)

    def test_cuda_matmat_uneven_slot_counts_all_patterns(self):
        """The cuda backend's one grouped product (plain versions on CPU
        tensors) skips pad slots by the device counts; block-sparse
        operands give block-rows of different real slot counts."""
        n, ka, kb, t, ca, cb = 6, 2, 2, 160, 64, 40
        rng = np.random.default_rng(13)
        sch = proposed_mm(n, ka, kb)
        ra, rb = mm_encoding_matrices(sch, 0)
        G = khatri_rao_rows(ra, rb)

        def tiled(r, zeros):
            keep = rng.random((t // 32, r // 32)) >= zeros
            mask = np.kron(keep, np.ones((32, 32)))
            return (rng.standard_normal((t, r)) * mask).astype(np.float32)

        A = tiled(ka * ca, 0.6)
        B = rng.standard_normal((t, kb * cb)).astype(np.float32)
        coded_a = np.einsum("nk,ktc->ntc", ra, np.asarray(
            j_split(jnp.asarray(A), ka))).astype(np.float32)
        coded_b = np.einsum("nk,ktc->ntc", rb, np.asarray(
            j_split(jnp.asarray(B), kb))).astype(np.float32)
        k = ka * kb
        ex = trt.CodedExecutor(torch.from_numpy(coded_a), G, k, ka * ca,
                               backend="cuda")
        packed = ex.packed
        assert len({c for row in packed.slot_counts for c in row}) > 1
        assert min(c for row in packed.slot_counts for c in row) < \
            packed.slots
        np.testing.assert_array_equal(
            packed.counts.numpy(), np.asarray(packed.slot_counts).reshape(-1))
        assert packed.counts.dtype == torch.int32
        ref = jrt.CodedExecutor(coded_a, G, k, ka * ca, backend="reference")
        for done in all_masks(n, n - k):
            got = ex.matmat(torch.from_numpy(coded_b), done)
            assert got.shape == (k, ca, cb)
            close(got, ref.matmat(jnp.asarray(coded_b), jnp.asarray(done)))

    def test_cuda_backend_takes_only_its_tile(self):
        rng = np.random.default_rng(14)
        _, coded, G = build_mv(rng, 6, 4, 64, 64)
        with pytest.raises(ValueError, match="32x32"):
            trt.CodedExecutor(torch.from_numpy(coded), G, 4, 64,
                              backend="cuda", bk=16)
        ex = trt.CodedExecutor(torch.from_numpy(coded), G, 4, 64,
                               backend="packed", bk=16, bm=16)
        assert (ex.packed.bk, ex.packed.bm) == (16, 16)

    def test_decode_all_patterns(self):
        n, k, t, r = 6, 4, 32, 24
        rng = np.random.default_rng(9)
        A, coded, G = build_mv(rng, n, k, t, r)
        y = rng.standard_normal((n, 5, 6)).astype(np.float32)
        j_packed = jrt.CodedExecutor(coded, G, k, r, backend="packed")
        j_kernel = jrt.CodedExecutor(coded, G, k, r,
                                     backend="pallas-interpret")
        ports = self.port_executors(coded, G, k, r)
        for done in all_masks(n, n - k):
            want_p = j_packed.decode(jnp.asarray(y), done)
            want_k = j_kernel.decode(jnp.asarray(y), done)
            for ex in ports.values():
                got = ex.decode(torch.from_numpy(y), done)
                close(got, want_p)
                close(got, want_k)

    @pytest.mark.parametrize("layout", [
        "two-lead-axes", "bf16", "f64", "no-lead", "worker-strided",
        "last-axis-strided", "lead-axes-do-not-merge"])
    def test_decode_layouts_all_patterns(self, layout):
        """decode on cuda (one gather launch on the card; the plain
        version here) takes y as the caller passes it: any lead axes,
        strides and dtype, and returns (..., r) in y's dtype."""
        n, k, t, r = 6, 4, 32, 22
        rng = np.random.default_rng(len(layout))
        A, coded, G = build_mv(rng, n, k, t, r)
        base = torch.from_numpy(rng.standard_normal((2 * n, 3, 5, 6))
                                .astype(np.float32))
        y = {"two-lead-axes": base[:n],
             "bf16": base[:n, 0].to(torch.bfloat16),
             "f64": base[:n, 0].double(),
             "no-lead": base[:n, 0, 0],
             "worker-strided": base[::2, 1],
             "last-axis-strided":
                 base.reshape(2 * n, 3, 6, 5)[:n, 0].transpose(1, 2),
             "lead-axes-do-not-merge": base[:n].transpose(1, 2)}[layout]
        j = jrt.CodedExecutor(coded, G, k, r, backend="packed")
        ex = trt.CodedExecutor(torch.from_numpy(coded), G, k, r,
                               backend="cuda")
        jy = jnp.asarray(y.float().numpy(),
                         jnp.bfloat16 if layout == "bf16" else jnp.float32)
        tol = dict(rtol=2e-2, atol=2e-2) if layout == "bf16" else TOL
        for done in all_masks(n, n - k):
            got = ex.decode(y, done)
            want = np.asarray(j.decode(jy, done), np.float32)
            assert got.dtype == y.dtype
            assert got.shape == want.shape == y.shape[1:-1] + (r,)
            close(got.float(), want, tol)

    def test_matmat_merge_on_every_backend(self):
        """matmat(merge=(k_A, k_B, r, w)) is A^T B (r, w) on every
        backend; the cuda decode stores it directly."""
        n, ka, kb, t, ca, cb = 6, 2, 2, 64, 40, 12
        rng = np.random.default_rng(31)
        ra, rb = mm_encoding_matrices(proposed_mm(n, ka, kb), 0)
        G = khatri_rao_rows(ra, rb)
        A = rng.standard_normal((t, ka * ca)).astype(np.float32)
        B = rng.standard_normal((t, kb * cb)).astype(np.float32)
        coded_a = np.einsum("nk,ktc->ntc", ra, np.asarray(
            j_split(jnp.asarray(A), ka))).astype(np.float32)
        coded_b = torch.from_numpy(np.einsum("nk,ktc->ntc", rb, np.asarray(
            j_split(jnp.asarray(B), kb))).astype(np.float32))
        r, w = ka * ca - 3, kb * cb - 5
        done = np.array([1, 0, 1, 1, 0, 1], bool)
        for backend in ("cuda", "packed", "reference"):
            ex = trt.CodedExecutor(torch.from_numpy(coded_a), G, ka * kb,
                                   ka * ca, backend=backend)
            got = ex.matmat(coded_b, done, merge=(ka, kb, r, w))
            assert got.shape == (r, w)
            close(got, (A.T @ B)[:r, :w], dict(rtol=1e-3, atol=1e-3))
            close(got, trt.merge_unknowns(ex.matmat(coded_b, done), ka, kb,
                                          r, w))
        with pytest.raises(ValueError, match="k_A \\* k_B"):
            ex.matmat(coded_b, done, merge=(ka, 3, r, w))

    def test_reference_backend_matches(self):
        n, k, t, r = 6, 4, 32, 24
        rng = np.random.default_rng(10)
        A, coded, G = build_mv(rng, n, k, t, r)
        x = rng.standard_normal((2, t)).astype(np.float32)
        y = rng.standard_normal((n, 3, 6)).astype(np.float32)
        j = jrt.CodedExecutor(coded, G, k, r, backend="reference")
        ex = trt.CodedExecutor(torch.from_numpy(coded), G, k, r,
                               backend="reference")
        assert ex.cache is None and ex.packed is None
        for done in all_masks(n, n - k):
            close(ex.matvec(torch.from_numpy(x), done),
                  j.matvec(jnp.asarray(x), jnp.asarray(done)))
            close(ex.decode(torch.from_numpy(y), torch.as_tensor(done)),
                  j.decode(jnp.asarray(y), jnp.asarray(done)))

    def test_encode_backend_parity(self):
        rng = np.random.default_rng(10)
        sch = proposed_mv(12, 9)
        R = mv_encoding_matrix(sch, 5)
        blocks = rng.standard_normal((9, 40, 8)).astype(np.float32)
        sup, coef = jrt.support_tables(sch.supports, R)
        t_sup, t_coef = trt.support_tables(sch.supports, R)
        np.testing.assert_array_equal(t_sup, sup)
        np.testing.assert_array_equal(t_coef, coef)
        ref = np.asarray(jrt.encode_blocks(blocks, sup, coef,
                                           "pallas-interpret"))
        for backend in trt.BACKENDS:
            close(trt.encode_blocks(torch.from_numpy(blocks), sup, coef,
                                    backend), ref)


class TestBackendsAndFallback:
    def test_registry_and_env_override(self, monkeypatch):
        assert trt.BACKENDS == ("reference", "packed", "cuda")
        monkeypatch.delenv("REPRO_CODED_BACKEND", raising=False)
        assert trt.resolve_backend("packed") == "packed"
        assert trt.resolve_backend() == "reference"
        assert trt.resolve_backend("auto", "cuda") == "cuda"
        assert trt.resolve_backend(None, "cpu") == "reference"
        monkeypatch.setenv("REPRO_CODED_BACKEND", "cuda")
        assert trt.resolve_backend("packed") == "cuda"
        monkeypatch.setenv("REPRO_CODED_BACKEND", "pallas")
        with pytest.raises(ValueError, match="reference.*packed.*cuda"):
            trt.resolve_backend()
        monkeypatch.setenv("REPRO_CODED_BACKEND", "nope")
        with pytest.raises(ValueError, match="unknown coded backend"):
            trt.resolve_backend()

    def test_requires_grad_takes_the_reference_path(self):
        rng = np.random.default_rng(11)
        A, coded, G = build_mv(rng, 6, 4, 16, 24)
        ex = trt.CodedExecutor(torch.from_numpy(coded), G, 4, 24,
                               backend="cuda")
        x = torch.tensor(rng.standard_normal((16,)), dtype=torch.float32,
                         requires_grad=True)
        done = np.array([1, 1, 0, 1, 1, 0], bool)
        misses = ex.cache.misses
        out = ex.matvec(x, done)
        out.sum().backward()
        assert ex.cache.misses == misses          # no sparse path taken
        close(out.detach(), x.detach().numpy() @ A, dict(rtol=2e-4,
                                                          atol=2e-4))
        close(x.grad, A.sum(axis=1), dict(rtol=1e-3, atol=1e-3))

    def test_repeated_apply_zero_additional_inversions(self, monkeypatch):
        rng = np.random.default_rng(4)
        A = torch.tensor(rng.standard_normal((32, 24)), dtype=torch.float32)
        op = CodedOperator.build(A, t_proposed_mv(6, 4), seed=1,
                                 backend="cuda")
        x = torch.tensor(rng.standard_normal((3, 32)), dtype=torch.float32)
        done = np.array([True, False, True, True, False, True])
        calls = {"n": 0}
        real_inv = np.linalg.inv

        def counting_inv(a):
            calls["n"] += 1
            return real_inv(a)

        def forbidden_solve(*a, **kw):  # pragma: no cover - must not run
            raise AssertionError("sparse path called torch.linalg.solve")

        monkeypatch.setattr(np.linalg, "inv", counting_inv)
        monkeypatch.setattr(torch.linalg, "solve", forbidden_solve)
        first = op.apply(x, done)
        for _ in range(5):
            out = op.apply(x, done)
        assert torch.equal(out, first)
        assert calls["n"] == 1
        ex = op.executor()
        assert (ex.cache.hits, ex.cache.misses) == (5, 2)

    def test_tile_count_scales_with_omega_not_k(self):
        """Banded A: a weight-omega shard touches omega bands, a
        dense-coded one all k -- at equal tile size the port counts the
        same tiles as the reference."""
        n, k, t, r = 6, 4, 64, 32
        rng = np.random.default_rng(12)
        A = np.zeros((t, r), np.float32)
        band, c = t // k, r // k
        for q in range(k):
            A[q * band:(q + 1) * band, q * c:(q + 1) * c] = (
                rng.standard_normal((band, c)))
        omega = mv_weight(n, k)
        prop = CodedOperator.build(torch.from_numpy(A), t_proposed_mv(n, k),
                                   seed=1, backend="packed")
        dense = CodedOperator.build(torch.from_numpy(A), poly_mv(n, k),
                                    seed=1, backend="packed")
        band_tiles = (band // 8) * (c // 8)
        np.testing.assert_array_equal(prop.worker_tile_counts(),
                                      omega * band_tiles)
        np.testing.assert_array_equal(dense.worker_tile_counts(),
                                      k * band_tiles)
        from repro.core import CodedOperator as JOp
        jprop = JOp.build(jnp.asarray(A), proposed_mv(n, k), seed=1,
                          backend="packed")
        np.testing.assert_array_equal(prop.worker_tile_counts(),
                                      jprop.worker_tile_counts())
        np.testing.assert_array_equal(prop.worker_nnz(), jprop.worker_nnz())
        # the cuda backend packs 32 x 32; at that tile the counts match the
        # reference packer's at the same tile
        cuda = CodedOperator.build(torch.from_numpy(A), t_proposed_mv(n, k),
                                   seed=1, backend="cuda")
        ref32 = jrt.pack_coded_blocks(np.asarray(jprop.coded), 32, 32)
        np.testing.assert_array_equal(cuda.worker_tile_counts(),
                                      ref32.tile_counts)
