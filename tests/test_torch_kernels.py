"""Kernel parity: each kernel's plain PyTorch version (what the wrapper
runs on a CPU tensor) against ``repro.kernels.ref`` and against the
Pallas kernel run with ``interpret=True``, over the shape, density and
dtype sweeps of ``tests/test_kernels.py``.  The CUDA half, each kernel
against its plain version on a Hopper card, is ``test_torch_cuda.py``:
it imports no JAX, so it runs on a machine with the card and no JAX."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import mv_encoding_matrix, proposed_mv
from repro.kernels import ref as jref
from repro.kernels.bcsr_matmul import bcsr_matmul as pallas_bcsr
from repro.kernels.cyclic_encode import cyclic_encode as pallas_encode
from repro.kernels.decode_matmul import decode_matmul as pallas_decode
from repro_torch.kernels import (
    bcsr_matmul,
    bcsr_matmul_plain,
    coded_worker_matmul,
    cyclic_encode,
    cyclic_encode_plain,
    decode_matmul,
    decode_matmul_plain,
    decode_unknowns,
    encode_submatrices,
    held_expert_ffn,
    launch_counts,
    mla_decode_attention,
    mla_decode_attention_plain,
    pack_bcsr,
    reset_launch_counts,
)
from repro_torch.kernels import ref as tref

# tiny shapes: one intra-op thread is enough, and idle OpenMP threads
# would spin on cores that the suite's timing-sensitive tests share
torch.set_num_threads(1)

TOL = dict(rtol=2e-5, atol=2e-5)
TOL_BF16 = dict(rtol=2e-2, atol=2e-2)


def make_block_sparse(rng, K, M, bk, bm, density, dtype=np.float32):
    mask = rng.random((K // bk, M // bm)) < density
    if not mask.any():
        mask[0, 0] = True
    a = rng.standard_normal((K, M)).astype(dtype)
    return a * np.kron(mask, np.ones((bk, bm))).astype(dtype)


def t(x, dtype=torch.float32):
    return torch.as_tensor(np.asarray(x)).to(dtype)


def close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), **tol)


class TestBcsrMatmul:
    @pytest.mark.parametrize("K,M,N,bk,bm,bn", [
        (64, 32, 48, 8, 8, 16),
        (128, 128, 128, 16, 16, 128),
        (256, 64, 96, 32, 16, 32),
        (32, 32, 32, 32, 32, 32),   # single block
        (64, 16, 8, 8, 8, 8),
    ])
    @pytest.mark.parametrize("density", [0.15, 0.5, 1.0])
    def test_shape_density_sweep(self, K, M, N, bk, bm, bn, density):
        rng = np.random.default_rng(K * 7 + M * 3 + N + int(density * 100))
        a = make_block_sparse(rng, K, M, bk, bm, density)
        b = rng.standard_normal((K, N)).astype(np.float32)
        a_data, a_idx, j = pack_bcsr(a, bk, bm)
        r_data, r_idx, r_j = jref.pack_bcsr(a, bk, bm)
        np.testing.assert_array_equal(a_data, r_data)
        np.testing.assert_array_equal(a_idx, r_idx)
        assert j == r_j
        out = bcsr_matmul(t(a_data), t(a_idx, torch.int32), t(b))
        assert out.dtype == torch.float32
        close(out, jref.bcsr_matmul_ref(a, b))
        close(out, pallas_bcsr(jnp.asarray(a_data), jnp.asarray(a_idx),
                               jnp.asarray(b), bn=bn, interpret=True))

    @pytest.mark.parametrize("dtype,tol", [(torch.float32, TOL),
                                           (torch.bfloat16, TOL_BF16)])
    def test_dtype_sweep(self, dtype, tol):
        rng = np.random.default_rng(0)
        jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
        a = make_block_sparse(rng, 64, 32, 8, 8, 0.4)
        b = rng.standard_normal((64, 32)).astype(np.float32)
        a_data, a_idx, _ = pack_bcsr(a, 8, 8)
        out = bcsr_matmul(t(a_data, dtype), t(a_idx, torch.int32), t(b, dtype))
        assert out.dtype == torch.float32  # f32 accumulation contract
        ref = pallas_bcsr(jnp.asarray(a_data, jdt), jnp.asarray(a_idx),
                          jnp.asarray(b, jdt), bn=16, interpret=True)
        close(out, ref, tol)
        close(out, jref.bcsr_matmul_ref(jnp.asarray(a, jdt),
                                        jnp.asarray(b, jdt)), tol)

    def test_packed_ref_matches_dense_ref(self):
        rng = np.random.default_rng(3)
        a = make_block_sparse(rng, 96, 48, 8, 16, 0.3)
        b = rng.standard_normal((96, 24)).astype(np.float32)
        a_data, a_idx, _ = pack_bcsr(a, 8, 16)
        close(tref.bcsr_matmul_packed_ref(t(a_data), t(a_idx), t(b)),
              jref.bcsr_matmul_packed_ref(jnp.asarray(a_data),
                                          jnp.asarray(a_idx), jnp.asarray(b)))
        close(tref.bcsr_matmul_ref(t(a), t(b)), jref.bcsr_matmul_ref(a, b))

    def test_live_rows_and_ragged_edges(self):
        """``rows`` picks workers' block-rows out of the full operand, and
        a B whose K is not a multiple of bk is masked, not padded."""
        rng = np.random.default_rng(4)
        n, mb, bk, bm = 5, 3, 8, 8
        shards = [make_block_sparse(rng, 24, mb * bm, bk, bm, 0.5)
                  for _ in range(n)]
        packs = [pack_bcsr(s, bk, bm, max_nnz=3) for s in shards]
        a_data = np.concatenate([p[0] for p in packs])
        a_idx = np.concatenate([p[1] for p in packs])
        rows = np.array([4, 0, 2], np.int32)
        b = rng.standard_normal((21, 5)).astype(np.float32)   # K=21 < 24
        out = bcsr_matmul(t(a_data), t(a_idx, torch.int32), t(b),
                          t(rows, torch.int32), mb=mb)
        want = np.concatenate([shards[i][:21].T @ b for i in rows])
        close(out, want, dict(rtol=1e-5, atol=1e-5))
        dst = torch.zeros_like(out)
        bcsr_matmul(t(a_data), t(a_idx, torch.int32), t(b),
                    t(rows, torch.int32), mb=mb, out=dst)
        np.testing.assert_array_equal(dst.numpy(), out.numpy())

    @pytest.mark.parametrize("K,M,N,bk,bm", [(96, 64, 8, 32, 32),
                                             (64, 32, 5, 8, 8),
                                             (128, 48, 24, 16, 16)])
    def test_counts_skip_nan_pad_slots(self, K, M, N, bk, bm):
        """Slots at or past ``counts`` are masked whatever they hold: NaN
        pad tiles (and a garbage index) give the JAX oracle's result on
        the packer's zero pads."""
        rng = np.random.default_rng(K + M + N)
        a = make_block_sparse(rng, K, M, bk, bm, 0.35)
        b = rng.standard_normal((K, N)).astype(np.float32)
        a_data, a_idx, _ = pack_bcsr(a, bk, bm, max_nnz=K // bk)
        nz = np.abs(a.reshape(K // bk, bk, M // bm, bm)).max(axis=(1, 3)) > 0
        counts = nz.sum(axis=0).astype(np.int32)
        assert counts.min() < K // bk           # some block-rows have pads
        pad = np.arange(K // bk)[None, :] >= counts[:, None]
        nan_data, bad_idx = a_data.copy(), a_idx.copy()
        nan_data[pad] = np.nan
        bad_idx[pad] = 10 ** 6
        out = bcsr_matmul_plain(t(nan_data), t(bad_idx, torch.int32), t(b),
                                counts=t(counts, torch.int32))
        assert torch.isfinite(out).all()
        close(out, jref.bcsr_matmul_packed_ref(
            jnp.asarray(a_data), jnp.asarray(a_idx), jnp.asarray(b)))
        close(out, jref.bcsr_matmul_ref(a, b))

    def test_per_worker_b_with_rows(self):
        """B given per worker (n, K, N): output block-row group j is worker
        rows[j]'s shard times its own B, as a loop of the JAX oracle."""
        rng = np.random.default_rng(6)
        n, mb, bk, bm, K, N = 5, 2, 8, 8, 40, 7
        shards = [make_block_sparse(rng, K, mb * bm, bk, bm, 0.5)
                  for _ in range(n)]
        packs = [pack_bcsr(s, bk, bm, max_nnz=K // bk) for s in shards]
        a_data = t(np.concatenate([p[0] for p in packs]))
        a_idx = t(np.concatenate([p[1] for p in packs]), torch.int32)
        b = rng.standard_normal((n, K - 3, N)).astype(np.float32)  # ragged K
        rows = np.array([3, 0, 4], np.int32)
        want = np.concatenate([np.asarray(jref.bcsr_matmul_ref(
            shards[i][: K - 3], b[i])) for i in rows])
        for fn in (bcsr_matmul_plain, bcsr_matmul):
            out = fn(a_data, a_idx, t(b), t(rows, torch.int32), mb=mb)
            close(out, want)
        # all workers when rows is None
        out = bcsr_matmul_plain(a_data, a_idx, t(b), mb=mb)
        close(out, np.concatenate([np.asarray(jref.bcsr_matmul_ref(
            shards[i][: K - 3], b[i])) for i in range(n)]))

    def test_flop_saving_structure(self):
        rng = np.random.default_rng(4)
        _, _, j_sparse = pack_bcsr(make_block_sparse(rng, 128, 64, 8, 8, 0.2),
                                   8, 8)
        _, _, j_dense = pack_bcsr(make_block_sparse(rng, 128, 64, 8, 8, 1.0),
                                  8, 8)
        assert j_sparse < j_dense / 2

    def test_ops_wrapper(self):
        rng = np.random.default_rng(5)
        a = make_block_sparse(rng, 64, 32, 8, 8, 0.4)
        b = rng.standard_normal((64, 16)).astype(np.float32)
        out = coded_worker_matmul(a, b, bk=8, bm=8, device="cpu")
        close(out, jref.bcsr_matmul_ref(a, b))


class TestCyclicEncode:
    @pytest.mark.parametrize("k,T,C,n,w,bt", [
        (4, 32, 8, 6, 2, 16),
        (9, 64, 16, 12, 3, 32),
        (6, 128, 4, 10, 4, 128),
        (3, 16, 32, 5, 2, 16),
    ])
    def test_shape_sweep(self, k, T, C, n, w, bt):
        rng = np.random.default_rng(k * 1000 + T + C + n + w)
        blocks = rng.standard_normal((k, T, C)).astype(np.float32)
        sup = rng.integers(0, k, size=(n, w)).astype(np.int32)
        coef = rng.standard_normal((n, w)).astype(np.float32)
        out = cyclic_encode(t(blocks), t(sup, torch.int32), t(coef))
        assert out.dtype == torch.float32 and out.shape == (n, T, C)
        close(out, jref.cyclic_encode_ref(jnp.asarray(blocks),
                                          jnp.asarray(sup), jnp.asarray(coef)))
        close(out, pallas_encode(jnp.asarray(blocks), jnp.asarray(sup),
                                 jnp.asarray(coef), bt=bt, interpret=True))

    @pytest.mark.parametrize("k,T,C,n,w", [(4, 24, 8, 6, 2),
                                           (3, 16, 7, 5, 2),
                                           (6, 20, 5, 8, 3)])
    def test_strided_block_column_view(self, k, T, C, n, w):
        """The encode reads ``split_block_columns``' strided view of the
        operand as it is (the wrapper copies nothing)."""
        from repro.core.coded_matmul import split_block_columns as j_split
        from repro_torch.core.coded_matmul import split_block_columns
        rng = np.random.default_rng(k * 100 + C)
        A = rng.standard_normal((T, k * C)).astype(np.float32)
        blocks = split_block_columns(t(A), k)
        assert not blocks.is_contiguous()
        sup = rng.integers(0, k, size=(n, w)).astype(np.int32)
        coef = rng.standard_normal((n, w)).astype(np.float32)
        want = pallas_encode(j_split(jnp.asarray(A), k), jnp.asarray(sup),
                             jnp.asarray(coef), bt=4, interpret=True)
        close(cyclic_encode_plain(blocks, t(sup, torch.int32), t(coef)), want)
        close(cyclic_encode(blocks, t(sup, torch.int32), t(coef)), want)
        with pytest.raises(ValueError, match="unit-stride"):
            cyclic_encode(blocks.transpose(1, 2), t(sup, torch.int32),
                          t(coef))

    def test_bf16_blocks(self):
        rng = np.random.default_rng(1)
        blocks = rng.standard_normal((4, 32, 8)).astype(np.float32)
        sup = rng.integers(0, 4, size=(6, 2)).astype(np.int32)
        coef = rng.standard_normal((6, 2)).astype(np.float32)
        out = cyclic_encode(t(blocks, torch.bfloat16), t(sup, torch.int32),
                            t(coef))
        ref = pallas_encode(jnp.asarray(blocks, jnp.bfloat16),
                            jnp.asarray(sup), jnp.asarray(coef), bt=16,
                            interpret=True)
        close(out, ref, TOL_BF16)

    @pytest.mark.parametrize("seed", [0, 1, 12345, 2**31 - 1])
    def test_matches_encoding_matrix_semantics(self, seed):
        """encode == R @ blocks for the Alg. 1 scheme."""
        rng = np.random.default_rng(seed)
        sch = proposed_mv(6, 4)
        R = mv_encoding_matrix(sch, seed=seed % 101)
        sup = np.array([list(s) for s in sch.supports], dtype=np.int32)
        coef = np.take_along_axis(R, sup, axis=1).astype(np.float32)
        blocks = rng.standard_normal((4, 32, 8)).astype(np.float32)
        out = encode_submatrices(blocks, sup, coef, device="cpu")
        np.testing.assert_allclose(out.numpy(),
                                   np.einsum("nk,ktc->ntc", R, blocks),
                                   rtol=1e-4, atol=1e-4)


class TestDecodeMatmul:
    @pytest.mark.parametrize("k,P,bp", [(4, 64, 16), (9, 512, 512),
                                        (16, 256, 64), (36, 72, 36)])
    def test_shape_sweep(self, k, P, bp):
        rng = np.random.default_rng(k * 1000 + P)
        h = rng.standard_normal((k, k)).astype(np.float32)
        y = rng.standard_normal((k, P)).astype(np.float32)
        out = decode_matmul(t(h), t(y))
        close(out, jref.decode_matmul_ref(h, y))
        close(out, pallas_decode(jnp.asarray(h), jnp.asarray(y), bp=bp,
                                 interpret=True))

    def test_end_to_end_decode(self):
        """Hinv from a real scheme pattern: decode reproduces the
        uncoded blocks."""
        rng = np.random.default_rng(7)
        R = mv_encoding_matrix(proposed_mv(6, 4), seed=3)
        alive = [0, 2, 3, 5]
        hinv = np.linalg.inv(R[alive]).astype(np.float32)
        u_true = rng.standard_normal((4, 64)).astype(np.float32)
        y = (R[alive] @ u_true).astype(np.float32)
        u = decode_unknowns(hinv, y, device="cpu")
        np.testing.assert_allclose(u.numpy(), u_true, rtol=1e-4, atol=1e-4)


# Output layouts of decode_matmul, each against the Pallas kernel (run in
# interpret mode) followed by the same rearrangement in numpy.  Ragged on
# purpose: r and w are not multiples of the unknowns' widths, and Y's pad
# columns hold NaN, which must not reach the output.
MM_KB = {1: 1, 4: 2, 14: 7, 16: 4}


def decode_case(mode, k, b, rng):
    """(y (f32 numpy), kwargs, the k x P operand the Pallas kernel decodes,
    and numpy's rearrangement of its result)."""
    if mode == "flat":
        y = rng.standard_normal((k, 29 + 10 * b)).astype(np.float32)
        return y, {}, y, lambda u: u
    if mode == "gather":
        n, c = k + 2, 9
        lead = (2, b) if b == 3 else (b,)
        y = rng.standard_normal((n, *lead, c)).astype(np.float32)
        rows = rng.permutation(n)[:k]
        r = max(k * c - 4, 1)
        kw = {"rows": t(rows, torch.int32), "r": r}

        def rearrange(u):
            u = np.moveaxis(u.reshape((k, *lead, c)), 0, -2)
            return u.reshape((*lead, k * c))[..., :r]
        return y, kw, y[rows].reshape(k, -1), rearrange
    c_pad = 32
    if mode == "mv":
        c = 13
        y = rng.standard_normal((k, c_pad, b)).astype(np.float32)
        r = max(k * c - 3, 1)               # the last unknown is clipped
        kw = {"c": c, "r": r}

        def rearrange(u):
            u = u.reshape(k, c, b).transpose(2, 0, 1)
            return u.reshape(b, k * c)[:, :r]
    else:
        kb, c, cb = MM_KB[k], 11, 3 * b + 2
        ka = k // kb
        y = rng.standard_normal((k, c_pad, cb)).astype(np.float32)
        r, w = max(ka * c - 2, 1), kb * cb - 1
        kw = {"c": c, "r": r, "w": w, "kb": kb}

        def rearrange(u):
            u = u.reshape(ka, kb, c, cb).transpose(0, 2, 1, 3)
            return u.reshape(ka * c, kb * cb)[:r, :w]
    operand = y[:, :c].reshape(k, -1).copy()
    y[:, c:] = np.nan                       # pad columns: never decoded
    return y, kw, operand, rearrange


@pytest.mark.parametrize("b", [1, 3, 8])
@pytest.mark.parametrize("k", [1, 4, 14, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("mode", ["flat", "mv", "mm", "gather"])
def test_decode_matmul_layouts_vs_pallas(mode, dtype, k, b):
    rng = np.random.default_rng(1000 * k + 10 * b + len(mode))
    y, kw, operand, rearrange = decode_case(mode, k, b, rng)
    h = rng.standard_normal((k, k)).astype(np.float32)
    yt = t(y, dtype)
    # the Pallas kernel on the same values (bf16 inputs as stored)
    op = t(operand, dtype).float().numpy()
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    want = rearrange(np.asarray(pallas_decode(
        jnp.asarray(h), jnp.asarray(op, jdt), bp=op.shape[1],
        interpret=True)))
    got = decode_matmul(t(h), yt, mode, **kw)
    out_dtype = dtype if mode == "gather" else torch.float32
    assert got.dtype == out_dtype and got.is_contiguous()
    assert got.shape == want.shape
    assert torch.isfinite(got).all()
    close(got.float(), want, TOL if dtype == torch.float32 else TOL_BF16)
    np.testing.assert_array_equal(
        got.float().numpy(),
        decode_matmul_plain(t(h), yt, mode, **kw).float().numpy())


@pytest.mark.parametrize("mode", ["flat", "mv", "mm", "gather"])
def test_prepare_decode_describes_the_result(mode):
    """prepare_decode, which checks a layout once for launch_decode, gives
    the plain version's result shape and dtype, and the C launcher's
    geometry (dtype codes, k, then the layout's scalars)."""
    from repro_torch.kernels.decode_matmul import prepare_decode
    rng = np.random.default_rng(len(mode))
    y, kw, _, _ = decode_case(mode, 14, 3, rng)
    h, yt = t(rng.standard_normal((14, 14))), t(y, torch.bfloat16)
    layout = prepare_decode(h, yt, mode, **kw)
    want = decode_matmul_plain(h, yt, mode, **kw)
    assert layout.like.shape == want.shape
    assert layout.like.dtype == want.dtype and not layout.empty
    geometry = list(layout.geometry)
    assert geometry[:3] == [1, 1 if mode == "gather" else 0, 14]
    assert len(geometry) == 13


def test_decode_matmul_gather_reads_strided_workers():
    """gather reads worker rows through y's strides: a worker-strided
    slice and merged lead axes need no copy."""
    rng = np.random.default_rng(21)
    full = t(rng.standard_normal((12, 4, 3, 7)))
    y = full[::2]                             # worker stride 2 * 84
    assert not y.is_contiguous()
    h, rows = t(rng.standard_normal((3, 3))), t([4, 0, 2], torch.int32)
    got = decode_matmul(h, y, "gather", rows=rows, r=19)
    want = decode_matmul_plain(h, y.contiguous(), "gather", rows=rows, r=19)
    assert got.shape == (4, 3, 19)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("mode,kw,y_shape,msg", [
    ("mv", {"c": 40, "r": 10}, (4, 32, 3), "c=40"),
    ("mv", {"c": 8, "r": 33}, (4, 32, 3), "r=33"),
    ("mm", {"c": 8, "r": 10, "w": 9, "kb": 3}, (4, 32, 3), "kb=3"),
    ("mm", {"c": 8, "r": 17, "w": 6, "kb": 2}, (4, 32, 3), "r=17"),
    ("mm", {"c": 8, "r": 16, "w": 7, "kb": 2}, (4, 32, 3), "w=7"),
    ("gather", {"r": 5}, (6, 2, 3), "rows"),
    ("flat", {}, (4, 5, 6), "y must be"),
    ("other", {}, (4, 5), "unknown decode mode"),
])
def test_decode_matmul_rejects_bad_layouts(mode, kw, y_shape, msg):
    with pytest.raises(ValueError, match=msg):
        decode_matmul(torch.ones(4, 4), torch.ones(y_shape), mode, **kw)


def test_cpu_tensors_take_the_plain_version():
    """On the CPU the wrappers run the plain versions and launch
    nothing: the counters count launches only."""
    reset_launch_counts()
    rng = np.random.default_rng(8)
    a = make_block_sparse(rng, 32, 16, 8, 8, 0.5)
    a_data, a_idx, _ = pack_bcsr(a, 8, 8)
    b = t(rng.standard_normal((32, 4)))
    args = (t(a_data), t(a_idx, torch.int32), b)
    np.testing.assert_array_equal(bcsr_matmul(*args).numpy(),
                                  bcsr_matmul_plain(*args).numpy())
    blocks, sup = t(rng.standard_normal((3, 8, 4))), t([[0, 2]], torch.int32)
    coef = t([[0.5, -1.0]])
    np.testing.assert_array_equal(cyclic_encode(blocks, sup, coef).numpy(),
                                  cyclic_encode_plain(blocks, sup, coef).numpy())
    h, y = t(rng.standard_normal((3, 3))), t(rng.standard_normal((3, 10)))
    np.testing.assert_array_equal(decode_matmul(h, y).numpy(),
                                  decode_matmul_plain(h, y).numpy())
    q_hat, q_pe = t(rng.standard_normal((2, 4, 16))), t(rng.standard_normal(
        (2, 4, 8)))
    c, kr = t(rng.standard_normal((2, 6, 16))), t(rng.standard_normal(
        (2, 6, 8)))
    np.testing.assert_array_equal(
        mla_decode_attention(q_hat, q_pe, c, kr, 5, 0.3).numpy(),
        mla_decode_attention_plain(q_hat, q_pe, c, kr, 5, 0.3).numpy())
    assert launch_counts() == {"bcsr_matmul": 0, "cyclic_encode": 0,
                               "decode_matmul": 0, "mla_decode_attention": 0,
                               "held_expert_ffn": 0}


# ---------------------------------------------------------------------------
# Thread safety: cluster workers are threads that launch kernels
# ---------------------------------------------------------------------------


def test_library_builds_once_under_concurrent_first_calls(monkeypatch,
                                                          tmp_path):
    """Eight threads reaching ``library()`` first, together: one build,
    one binding, one library for all (the build stubbed)."""
    import threading
    import time
    import types

    from repro_torch.kernels import _build

    builds, loads = [], []

    def fake_compile(target):
        builds.append(target)
        time.sleep(0.05)            # widen the window a second build needs
        target.write_bytes(b"")

    class FakeLib:
        def __getattr__(self, name):
            return types.SimpleNamespace()

    def fake_dll(path):
        loads.append(path)
        return FakeLib()

    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_compile", fake_compile)
    monkeypatch.setattr(_build.ctypes, "PyDLL", fake_dll)
    barrier = threading.Barrier(8)
    got = []

    def first_call():
        barrier.wait(timeout=30)
        got.append(_build.library())

    threads = [threading.Thread(target=first_call) for _ in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
    assert not any(th.is_alive() for th in threads)
    assert len(builds) == 1 and len(loads) == 1
    assert len(got) == 8 and all(lib is got[0] for lib in got)
    assert _build.build_info["cached"] is False


def test_launch_counters_exact_across_threads():
    """``count_launch`` from 8 threads at once, with the interpreter
    switching threads as often as it can: no increment is lost."""
    import sys
    import threading

    from repro_torch.kernels import _build

    per_thread, saved = 20000, launch_counts()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        reset_launch_counts()
        threads = [threading.Thread(target=lambda fn=fn: [
            _build.count_launch(fn) for _ in range(per_thread)])
            for fn in (bcsr_matmul, cyclic_encode, decode_matmul,
                       bcsr_matmul) * 2]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
        assert not any(th.is_alive() for th in threads)
        assert launch_counts() == {"bcsr_matmul": 4 * per_thread,
                                   "cyclic_encode": 2 * per_thread,
                                   "decode_matmul": 2 * per_thread,
                                   "mla_decode_attention": 0,
                                   "held_expert_ffn": 0}
    finally:
        sys.setswitchinterval(old)
        for fn in (bcsr_matmul, cyclic_encode, decode_matmul,
                   mla_decode_attention, held_expert_ffn):
            fn.launches = saved[fn.__name__]


def test_bcsr_matmul_splits_its_launch_count_by_layout():
    """``bcsr_matmul``'s launches split by layout: ``count_launch`` with a
    counter's name adds one to ``launches`` and to that counter, exact
    from several threads at once, and a reset clears both splits."""
    import threading

    from repro_torch.kernels import _build

    saved = (bcsr_matmul.launches, bcsr_matmul.narrow_launches,
             bcsr_matmul.wide_launches)
    try:
        reset_launch_counts()
        assert (bcsr_matmul.narrow_launches, bcsr_matmul.wide_launches) \
            == (0, 0)
        threads = [threading.Thread(target=lambda name=name: [
            _build.count_launch(bcsr_matmul, name) for _ in range(5000)])
            for name in ("narrow_launches", "wide_launches",
                         "narrow_launches")]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
        assert not any(th.is_alive() for th in threads)
        assert (bcsr_matmul.launches, bcsr_matmul.narrow_launches,
                bcsr_matmul.wide_launches) == (15000, 10000, 5000)
        reset_launch_counts()
        assert (bcsr_matmul.launches, bcsr_matmul.narrow_launches,
                bcsr_matmul.wide_launches) == (0, 0, 0)
    finally:
        (bcsr_matmul.launches, bcsr_matmul.narrow_launches,
         bcsr_matmul.wide_launches) = saved
