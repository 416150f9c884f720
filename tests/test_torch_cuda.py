"""The CUDA half of the port's kernel tests: each hand-written kernel
against its plain PyTorch version on a Hopper card, and the plan's
``cuda`` backend on the card against the same plan on the CPU.

Every test here needs an sm_90 device and skips elsewhere, with a
reason.  The file imports no JAX, so it runs where the card is:

    python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch._device import is_hopper
from repro_torch.api import compile_plan
from repro_torch.kernels import (
    bcsr_matmul,
    bcsr_matmul_plain,
    cyclic_encode,
    cyclic_encode_plain,
    decode_matmul,
    decode_matmul_plain,
    launch_counts,
    mla_decode_attention,
    mla_decode_attention_plain,
    pack_bcsr,
)

TOL = dict(rtol=2e-5, atol=2e-5)          # tests/test_kernels.py:27-28
TOL_BF16 = dict(rtol=2e-2, atol=2e-2)

pytestmark = pytest.mark.cuda


@pytest.fixture
def hopper():
    if not is_hopper():
        pytest.skip("needs an sm_90 (Hopper) CUDA device; the kernels are "
                    "built for sm_90a")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def t(x, dtype=torch.float32):
    return torch.as_tensor(np.asarray(x)).to(dtype)


def close(a, b, dtype=torch.float32):
    tol = TOL if dtype == torch.float32 else TOL_BF16
    np.testing.assert_allclose(a.float().cpu().numpy(),
                               b.float().cpu().numpy(), **tol)


def block_sparse(rng, K, M, bk, bm, density):
    mask = rng.random((K // bk, M // bm)) < density
    mask[0, 0] = True
    a = rng.standard_normal((K, M)).astype(np.float32)
    return a * np.kron(mask, np.ones((bk, bm))).astype(np.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K,M,N,bk,bm", [
    (96, 64, 8, 32, 32), (256, 128, 1000, 32, 32), (64, 16, 24, 8, 8),
    (128, 64, 3, 16, 8)])
def test_bcsr_matmul(hopper, dtype, K, M, N, bk, bm):
    rng = np.random.default_rng(K + M + N)
    a = block_sparse(rng, K, M, bk, bm, 0.3)
    a_data, a_idx, _ = pack_bcsr(a, bk, bm)
    b = t(rng.standard_normal((K - 3, N)), dtype).to(hopper)  # ragged K
    args = (t(a_data, dtype).to(hopper), t(a_idx, torch.int32).to(hopper), b)
    if (bk, bm) != (32, 32):
        # the kernel is specialised on the cuda backend's tile
        with pytest.raises(ValueError, match="32x32"):
            bcsr_matmul(*args)
        return
    before = bcsr_matmul.launches
    out = bcsr_matmul(*args)
    torch.cuda.synchronize()
    assert bcsr_matmul.launches == before + 1
    close(out, bcsr_matmul_plain(*args), dtype)


def test_bcsr_matmul_live_rows(hopper):
    rng = np.random.default_rng(3)
    n, mb, bk, bm = 6, 4, 32, 32
    shards = [block_sparse(rng, 96, mb * bm, bk, bm, 0.5) for _ in range(n)]
    packs = [pack_bcsr(s, bk, bm, max_nnz=3) for s in shards]
    a_data = t(np.concatenate([p[0] for p in packs])).to(hopper)
    a_idx = t(np.concatenate([p[1] for p in packs]), torch.int32).to(hopper)
    rows = t([5, 0, 3], torch.int32).to(hopper)
    b = t(rng.standard_normal((96, 8))).to(hopper)
    out = bcsr_matmul(a_data, a_idx, b, rows, mb=mb)
    close(out, bcsr_matmul_plain(a_data, a_idx, b, rows, mb=mb))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N", [1, 2, 3, 4, 5, 6, 7, 8, 64])
def test_bcsr_matmul_sums_in_its_plain_versions_order(hopper, N, dtype):
    """Each output is one f32 sum over the slots and K rows in order, at
    every width: bitwise the plain version, one column included (where
    the library would take a GEMV that sums as a tree).  The shape is a
    card worker's task of the LM head, where the two orders differ; A
    in f32 and in bf16 (a coded head's shards) times an f32 B."""
    rng = np.random.default_rng(N)
    a = block_sparse(rng, 3072, 8032, 8, 8, 0.1)
    a_data, a_idx, _ = pack_bcsr(a, 32, 32)
    args = (t(a_data, dtype).to(hopper), t(a_idx, torch.int32).to(hopper),
            t(rng.standard_normal((3072, N))).to(hopper))
    assert torch.equal(bcsr_matmul(*args), bcsr_matmul_plain(*args))


@pytest.mark.parametrize("b_offset", [0, 1], ids=["aligned", "offset"])
@pytest.mark.parametrize("dtype,b_dtype", [
    (torch.bfloat16, torch.float32), (torch.float32, torch.float32),
    (torch.bfloat16, torch.bfloat16), (torch.float32, torch.bfloat16)],
    ids=["bf16-f32", "f32", "bf16", "f32-bf16"])
def test_bcsr_matmul_narrow_walks_every_block_row_once(hopper, dtype,
                                                       b_dtype, b_offset):
    """More output block-rows than the card holds narrow warps at once,
    and a count no number of rounds divides: live ``rows``, ``counts``
    with NaN and out-of-range indices in the pad slots, arbitrary slot
    K-blocks, ragged K, widths 1-8, 16, 24 and 32 and two column-tiled
    ones, B 16-byte aligned or one element off (each way of staging B),
    against the
    plain version.  The output starts as NaN, so a block-row left out or
    written twice with garbage shows."""
    gen = torch.Generator(device=hopper)
    gen.manual_seed(11)
    n, mb, K, J = 6, 1001, 317, 10
    a_data = torch.randn((n * mb, J, 32, 32), generator=gen,
                         device=hopper).to(dtype)
    a_idx = torch.randint(0, -(-K // 32), (n * mb, J), generator=gen,
                          device=hopper, dtype=torch.int32)
    counts = torch.randint(0, J + 1, (n * mb,), generator=gen,
                           device=hopper, dtype=torch.int32)
    pad = torch.arange(J, device=hopper) >= counts[:, None]
    a_data[pad] = float("nan")
    a_idx[pad] = 12345
    rows = t([4, 1, 5, 0, 2], torch.int32).to(hopper)
    tol = torch.float32 if (dtype, b_dtype) == (F32, F32) else BF16
    for N in (1, 2, 3, 4, 5, 6, 7, 8, 16, 24, 32, 40, 63):
        flat = torch.randn((K * N + b_offset,), generator=gen, device=hopper)
        b = flat.to(b_dtype)[b_offset:].view(K, N)
        out = torch.full((5 * mb * 32, N), float("nan"), device=hopper)
        bcsr_matmul(a_data, a_idx, b, rows, mb=mb, counts=counts, out=out)
        torch.cuda.synchronize()
        assert torch.isfinite(out).all(), N
        close(out, bcsr_matmul_plain(a_data, a_idx, b, rows, mb=mb,
                                     counts=counts), tol)


def test_bcsr_matmul_counts_launches_by_layout(hopper):
    """A narrow call (N < 64) adds one to ``narrow_launches``, a wide one
    to ``wide_launches``, each beside ``launches``."""
    rng = np.random.default_rng(5)
    a_data, a_idx, _ = pack_bcsr(block_sparse(rng, 128, 64, 32, 32, 0.5),
                                 32, 32)
    a_data, a_idx = t(a_data).to(hopper), t(a_idx, torch.int32).to(hopper)
    for N, narrow, wide in ((8, 1, 0), (1, 1, 0), (63, 1, 0), (64, 0, 1)):
        b = t(rng.standard_normal((128, N))).to(hopper)
        before = (bcsr_matmul.launches, bcsr_matmul.narrow_launches,
                  bcsr_matmul.wide_launches)
        bcsr_matmul(a_data, a_idx, b)
        assert (bcsr_matmul.launches, bcsr_matmul.narrow_launches,
                bcsr_matmul.wide_launches) == (
            before[0] + 1, before[1] + narrow, before[2] + wide), N


def packed_workers(rng, n, mb, K, dtype):
    """n workers' shards (K, mb * 32), packed to J = K / 32 slots with the
    packer's zero pads, and each block-row's real slot count."""
    shards = [block_sparse(rng, K, mb * 32, 32, 32, 0.3) for _ in range(n)]
    packs = [pack_bcsr(s, 32, 32, max_nnz=K // 32) for s in shards]
    counts = np.concatenate([
        (np.abs(s.reshape(K // 32, 32, mb, 32)).max(axis=(1, 3)) > 0)
        .sum(axis=0) for s in shards])
    return (shards,
            t(np.concatenate([p[0] for p in packs]), dtype).to("cuda"),
            t(np.concatenate([p[1] for p in packs]), torch.int32).to("cuda"),
            t(counts, torch.int32).to("cuda"))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N", [8, 5, 200])
def test_bcsr_matmul_nan_in_pad_slots_never_reaches_output(hopper, dtype, N):
    rng = np.random.default_rng(N)
    mb, K = 3, 320
    _, a_data, a_idx, counts = packed_workers(rng, 4, mb, K, dtype)
    clean = a_data.clone()
    live = torch.arange(K // 32, device=hopper) < counts[:, None]
    a_data[~live] = float("nan")
    a_idx[~live] = 12345             # out of range, never read either
    b = t(rng.standard_normal((K, N)), dtype).to(hopper)
    out = bcsr_matmul(a_data, a_idx, b, counts=counts)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    a_idx_clean = a_idx.masked_fill(~live, 0)
    close(out, bcsr_matmul_plain(clean, a_idx_clean, b), dtype)


@pytest.mark.parametrize("N", [8, 128])
def test_bcsr_matmul_empty_block_row_writes_zeros(hopper, N):
    rng = np.random.default_rng(7)
    _, a_data, a_idx, counts = packed_workers(rng, 2, 4, 128, torch.float32)
    counts[[0, 5]] = 0
    b = t(rng.standard_normal((128, N))).to(hopper)
    out = torch.full((8 * 32, N), float("nan"), device=hopper)
    bcsr_matmul(a_data, a_idx, b, counts=counts, out=out)
    torch.cuda.synchronize()
    assert (out[:32] == 0).all() and (out[5 * 32:6 * 32] == 0).all()
    close(out, bcsr_matmul_plain(a_data, a_idx, b, counts=counts))


F32, BF16 = torch.float32, torch.bfloat16


@pytest.mark.parametrize("dtype,b_dtype", [
    (F32, F32), (BF16, BF16),
    (BF16, F32),     # a bf16 plan's matmat: bf16 shards, f32 coded B
    (F32, BF16)], ids=["f32", "bf16", "bf16-f32", "f32-bf16"])
@pytest.mark.parametrize("K,N", [(317, 1000), (256, 1024), (100, 6),
                                 (96, 64), (130, 97)])
def test_bcsr_matmul_grouped_per_worker_b(hopper, dtype, b_dtype, K, N):
    """One launch over the live workers, each with its own B, ragged K/N,
    against the plain version and a per-worker dense product."""
    rng = np.random.default_rng(K + N)
    n, mb, kp = 6, 3, -(-K // 32) * 32
    shards, a_data, a_idx, counts = packed_workers(rng, n, mb, kp, dtype)
    b = t(rng.standard_normal((n, K, N)), b_dtype).to(hopper)
    tol = BF16 if BF16 in (dtype, b_dtype) else F32
    live = (4, 1, 5, 0)
    rows = t(live, torch.int32).to(hopper)
    before = bcsr_matmul.launches
    out = bcsr_matmul(a_data, a_idx, b, rows, mb=mb, counts=counts)
    torch.cuda.synchronize()
    assert bcsr_matmul.launches == before + 1
    close(out, bcsr_matmul_plain(a_data, a_idx, b, rows, mb=mb,
                                 counts=counts), tol)
    dense = torch.cat([t(shards[i][:K], dtype).to(hopper).float().T
                       @ b[i].float() for i in live])
    close(out, dense, tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,n,w", [(14, 16, 3), (36, 40, 2), (4, 20, 2)])
@pytest.mark.parametrize("C", [64, 33])
def test_cyclic_encode_strided_view(hopper, dtype, k, n, w, C):
    """The kernel reads split_block_columns' strided view in place: C=64
    takes the 16-byte path, C=33 (odd) the single-element one."""
    from repro_torch.core.coded_matmul import split_block_columns
    rng = np.random.default_rng(k * C)
    A = t(rng.standard_normal((70, k * C)), dtype).to(hopper)
    blocks = split_block_columns(A, k)
    assert not blocks.is_contiguous()
    sup = t(rng.integers(0, k, size=(n, w)), torch.int32).to(hopper)
    coef = t(rng.standard_normal((n, w))).to(hopper)
    before = cyclic_encode.launches
    out = cyclic_encode(blocks, sup, coef)
    torch.cuda.synchronize()
    assert cyclic_encode.launches == before + 1
    close(out, cyclic_encode_plain(blocks.contiguous(), sup, coef), dtype)


def test_cyclic_encode_rejects_too_many_sources(hopper):
    blocks = torch.zeros((300, 4, 8), device=hopper)
    sup = torch.zeros((2, 2), dtype=torch.int32, device=hopper)
    with pytest.raises(ValueError, match="shared memory"):
        cyclic_encode(blocks, sup, torch.ones((2, 2), device=hopper))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cyclic_encode(hopper, dtype):
    rng = np.random.default_rng(2)
    blocks = t(rng.standard_normal((9, 130, 33)), dtype).to(hopper)
    sup = t(rng.integers(0, 9, size=(12, 3)), torch.int32).to(hopper)
    coef = t(rng.standard_normal((12, 3))).to(hopper)
    close(cyclic_encode(blocks, sup, coef),
          cyclic_encode_plain(blocks, sup, coef), dtype)


MM_KB = {1: 1, 4: 2, 14: 7, 16: 4, 36: 6, 64: 8}


def decode_case(mode, k, b, rng, c_pad=32):
    """y (f32 numpy, NaN in the pad columns) and the wrapper's keywords
    for one layout; r and w are ragged, and in mv the last unknown is
    clipped."""
    if mode == "flat":
        return rng.standard_normal((k, 29 + 10 * b)).astype(np.float32), {}
    if mode == "gather":
        n, c = k + 2, 9 if b != 8 else 12     # c = 12: the vector path
        lead = (2, b) if b == 3 else (b,)
        y = rng.standard_normal((n, *lead, c)).astype(np.float32)
        rows = rng.permutation(n)[:k]
        return y, {"rows": t(rows, torch.int32).to("cuda"),
                   "r": max(k * c - 4, 1)}
    if mode == "mv":
        c = 13
        y = rng.standard_normal((k, c_pad, b)).astype(np.float32)
        kw = {"c": c, "r": max(k * c - 3, 1)}
    else:
        kb, c, cb = MM_KB[k], 11, 3 * b + 2 if b != 8 else 32
        y = rng.standard_normal((k, c_pad, cb)).astype(np.float32)
        kw = {"c": c, "r": max(k // kb * c - 2, 1), "w": kb * cb - 1,
              "kb": kb}
    y[:, c:] = np.nan
    return y, kw


@pytest.mark.parametrize("b", [1, 3, 8, 20])
@pytest.mark.parametrize("k", [1, 4, 14, 16, 36, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["flat", "mv", "mm", "gather"])
def test_decode_matmul(hopper, mode, dtype, k, b):
    """Every layout, dtype and ragged size against the plain version;
    NaN in Y's pad columns never reaches the output."""
    rng = np.random.default_rng(k * 100 + b)
    y, kw = decode_case(mode, k, b, rng, c_pad=33 if b == 3 else 32)
    h = t(rng.standard_normal((k, k))).to(hopper)
    y = t(y, dtype).to(hopper)
    before = decode_matmul.launches
    got = decode_matmul(h, y, mode, **kw)
    torch.cuda.synchronize()
    assert decode_matmul.launches == before + 1
    assert got.is_contiguous() and torch.isfinite(got).all()
    want = decode_matmul_plain(h, y, mode, **kw)
    assert got.dtype == want.dtype and got.shape == want.shape
    close(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_matmul_lm_head_shapes(hopper, dtype):
    """The coded LM head's decode: k = 14, c = 2291 of c_pad = 2304, 8
    requests, r = 32064 (the last unknown clipped), and the gather of
    the same results, misaligned by one element (the scalar path)."""
    rng = np.random.default_rng(5)
    k, c, c_pad, b, r = 14, 2291, 2304, 8, 32064
    h = t(rng.standard_normal((k, k))).to(hopper)
    y = t(rng.standard_normal((k, c_pad, b)), dtype).to(hopper)
    y[:, c:] = float("nan")
    close(decode_matmul(h, y, "mv", c=c, r=r),
          decode_matmul_plain(h, y, "mv", c=c, r=r), dtype)
    ys = t(rng.standard_normal((16 * b * c + 1,)), dtype).to(hopper)
    ys = ys[1:].view(16, b, c)
    rows = torch.arange(2, 16, dtype=torch.int32, device=hopper)
    close(decode_matmul(h, ys, "gather", rows=rows, r=r),
          decode_matmul_plain(h, ys, "gather", rows=rows, r=r), dtype)


@pytest.mark.parametrize("mode,shape,kw", [
    ("mv", (14, 2304, 8), {"c": 2291, "r": 32064}),
    ("mm", (16, 64, 40), {"c": 60, "r": 230, "w": 150, "kb": 4}),
    ("flat", (5, 1000), {})])
def test_prepared_decode_launches_like_the_checked_call(hopper, mode, shape,
                                                        kw):
    """launch_decode of a layout prepare_decode checked once (the
    executor's path for its own products) computes what decode_matmul
    does, on fresh tensors of that layout, one launch each."""
    from repro_torch.kernels.decode_matmul import launch_decode, prepare_decode
    rng = np.random.default_rng(len(shape) + shape[-1])
    k = shape[0]
    h = t(rng.standard_normal((k, k))).to(hopper)
    layout = prepare_decode(h, torch.empty(shape, device=hopper), mode, **kw)
    for _ in range(2):
        y = t(rng.standard_normal(shape)).to(hopper)
        before = decode_matmul.launches
        got = launch_decode(layout, h, y)
        torch.cuda.synchronize()
        assert decode_matmul.launches == before + 1
        assert got.is_contiguous()
        close(got, decode_matmul_plain(h, y, mode, **kw))


def test_decode_matmul_gather_reads_strides_in_place(hopper):
    rng = np.random.default_rng(6)
    full = t(rng.standard_normal((12, 4, 3, 8))).to(hopper)
    y = full[::2]
    h = t(rng.standard_normal((3, 3))).to(hopper)
    rows = t([4, 0, 2], torch.int32).to(hopper)
    close(decode_matmul(h, y, "gather", rows=rows, r=21),
          decode_matmul_plain(h, y.contiguous(), "gather", rows=rows, r=21))


def test_decode_matmul_on_a_device_that_is_not_current(hopper):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    rng = np.random.default_rng(8)
    h = t(rng.standard_normal((4, 4))).to("cuda:0")
    y = t(rng.standard_normal((4, 32, 8))).to("cuda:0")
    with torch.cuda.device(1):
        got = decode_matmul(h, y, "mv", c=30, r=100)
        assert torch.cuda.current_device() == 1
    torch.cuda.synchronize(0)
    close(got, decode_matmul_plain(h, y, "mv", c=30, r=100))


def test_wrappers_raise_instead_of_falling_back(hopper):
    y = torch.ones(4, 8, device=hopper)
    with pytest.raises(TypeError, match="float32"):
        decode_matmul(torch.ones(4, 4, device=hopper, dtype=torch.float64),
                      y)
    with pytest.raises(ValueError, match="contiguous"):
        decode_matmul(torch.ones(4, 4, device=hopper), y.T.contiguous().T)
    with pytest.raises(ValueError, match="above the kernel"):
        decode_matmul(torch.ones(65, 65, device=hopper),
                      torch.ones(65, 8, device=hopper))
    with pytest.raises(ValueError, match="expected"):
        decode_matmul(torch.ones(4, 4), y)
    y3 = torch.ones(4, 32, 8, device=hopper)
    with pytest.raises(ValueError, match="contiguous"):
        decode_matmul(torch.ones(4, 4, device=hopper),
                      y3.transpose(1, 2).contiguous().transpose(1, 2), "mv",
                      c=30, r=100)
    with pytest.raises(ValueError, match="expected"):
        decode_matmul(torch.ones(4, 4, device=hopper), y3, "gather",
                      rows=torch.arange(4, dtype=torch.int32), r=20)
    with pytest.raises(TypeError, match="int32"):
        decode_matmul(torch.ones(4, 4, device=hopper), y3, "gather",
                      rows=torch.arange(4, device=hopper), r=20)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        decode_matmul(torch.ones(4, 4, device=hopper), y3.double(), "mm",
                      c=30, r=60, w=16, kb=2)
    with pytest.raises(ValueError, match="stride 1"):
        decode_matmul(torch.ones(4, 4, device=hopper), y3.transpose(1, 2),
                      "gather", rows=torch.arange(4, dtype=torch.int32,
                                                  device=hopper), r=20)


def test_plan_on_the_card_matches_the_cpu(hopper):
    """compile_plan on the card (kernels) against the same plan on the
    CPU (plain versions), mv and mm, with launch counts."""
    rng = np.random.default_rng(4)
    A = rng.standard_normal((200, 130)).astype(np.float32)
    x = rng.standard_normal((5, 200)).astype(np.float32)
    done = np.array([1, 1, 0, 1, 1, 1, 1, 0], bool)
    card = compile_plan(t(A).to(hopper), scheme="proposed", n=8, s=2, seed=1)
    cpu = compile_plan(t(A), scheme="proposed", n=8, s=2, seed=1,
                       backend="cuda")
    assert card.backend == "cuda" and card.device.type == "cuda"
    before = launch_counts()
    out = card.matvec(t(x).to(hopper), done)
    after = launch_counts()
    assert after["bcsr_matmul"] == before["bcsr_matmul"] + 1
    assert after["decode_matmul"] == before["decode_matmul"] + 1
    np.testing.assert_allclose(out.cpu().numpy(),
                               cpu.matvec(t(x), done).numpy(),
                               rtol=2e-4, atol=2e-4)

    B = rng.standard_normal((200, 60)).astype(np.float32)
    done = np.ones(20, bool)
    done[[2, 5, 11, 17]] = False
    card = compile_plan(t(A).to(hopper), scheme="proposed", n=20, k_A=4,
                        k_B=4, seed=1)
    cpu = compile_plan(t(A), scheme="proposed", n=20, k_A=4, k_B=4, seed=1,
                       backend="cuda")
    before = launch_counts()
    got = card.matmat(t(B).to(hopper), done)
    after = launch_counts()
    assert {k: after[k] - before[k] for k in after} == {
        "bcsr_matmul": 1, "cyclic_encode": 1, "decode_matmul": 1,
        "mla_decode_attention": 0,
        "held_expert_ffn": 0}
    assert got.shape == (130, 60) and got.is_contiguous()
    np.testing.assert_allclose(got.cpu().numpy(),
                               cpu.matmat(t(B), done).numpy(),
                               rtol=2e-4, atol=2e-4)

    # decode-only: one launch, no gather, cast or copy around it
    y = t(rng.standard_normal((20, 3, 33)), torch.bfloat16)
    before = launch_counts()
    got = card.executor.decode(y.to(hopper), done)
    after = launch_counts()
    assert {k: after[k] - before[k] for k in after} == {
        "bcsr_matmul": 0, "cyclic_encode": 0, "decode_matmul": 1,
        "mla_decode_attention": 0,
        "held_expert_ffn": 0}
    assert got.dtype == torch.bfloat16 and got.shape == (3, 130)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               cpu.executor.decode(y, done).float().numpy(),
                               rtol=2e-2, atol=2e-2)


def smoke_engine(device, coded=None):
    """The phi3-mini smoke engine (f32) on ``device``, its weights drawn on
    the CPU from seed 0 so both devices serve the same model."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import CodedConfig
    from repro_torch.models import build_model
    from repro_torch.serve import ServeEngine

    cfg = get_smoke_config("phi3-mini-3.8b")
    params = build_model(cfg, torch.float32, device="cpu").init(
        torch.Generator().manual_seed(0))
    model = build_model(cfg, torch.float32, device=device)
    return ServeEngine(
        model, {k: v.to(device) for k, v in params.items()}, cfg,
        batch_size=2, max_len=64,
        coded=None if coded is None else CodedConfig(**coded))


def record_logits(engine) -> list:
    """Wrap an engine's prefill and decode to keep each step's logits."""
    seen = []

    def keep(fn):
        def call(*args):
            out = fn(*args)
            seen.append(out[0].cpu())
            return out
        return call

    engine._prefill, engine._decode = (keep(engine._prefill),
                                       keep(engine._decode))
    return seen


def test_smoke_engine_on_the_card_matches_the_cpu(hopper):
    """Every step's logits of ``TestServeEngine.test_batched_generation``'s
    case on the card against the same engine on the CPU, f32, and no
    coded-path kernel launched while serving."""
    from repro_torch.serve import Request

    engines = {dev: smoke_engine(dev) for dev in ("cpu", hopper)}
    logits = {dev: record_logits(eng) for dev, eng in engines.items()}
    before = launch_counts()
    outs = {dev: eng.run([Request(prompt=[1, 5, 9], max_new=4),
                          Request(prompt=[1, 7], max_new=4),
                          Request(prompt=[1, 2, 3, 4], max_new=4)])
            for dev, eng in engines.items()}
    assert launch_counts() == before
    assert len(logits["cpu"]) == len(logits[hopper]) == 8
    for a, b in zip(logits[hopper], logits["cpu"]):
        close(a, b)
    assert [r.output for r in outs[hopper]] == [r.output for r in outs["cpu"]]


def test_coded_logits_launch_counts(hopper):
    """Engine build: one cyclic_encode (the head's encode); each
    coded_logits: one bcsr_matmul and one decode_matmul; against the CPU
    engine's coded head within f32 tolerance, per straggler mask."""
    before = launch_counts()
    eng = smoke_engine(hopper, dict(enabled=True, n_workers=6, stragglers=2))
    after = launch_counts()
    assert {k: after[k] - before[k] for k in after} == {
        "bcsr_matmul": 0, "cyclic_encode": 1, "decode_matmul": 0,
        "mla_decode_attention": 0,
        "held_expert_ffn": 0}
    assert eng.coded.backend == "cuda"
    cpu = smoke_engine("cpu", dict(enabled=True, n_workers=6, stragglers=2,
                                   backend="cuda"))
    hidden = t(np.random.default_rng(0).standard_normal((2, 64)))
    for _ in range(3):
        done = eng._straggler_mask()
        np.testing.assert_array_equal(done, cpu._straggler_mask())
        before = launch_counts()
        got = eng.coded_logits(hidden.to(hopper), done)
        after = launch_counts()
        assert {k: after[k] - before[k] for k in after} == {
            "bcsr_matmul": 1, "cyclic_encode": 0, "decode_matmul": 1,
            "mla_decode_attention": 0,
            "held_expert_ffn": 0}
        assert got.dtype == torch.float32 and got.shape == (2, 256)
        np.testing.assert_allclose(got.cpu().numpy(),
                                   cpu.coded_logits(hidden, done).numpy(),
                                   rtol=2e-4, atol=2e-4)


# ---------------------------------------------------------------------------
# The cluster on the card: card workers and their decode
# ---------------------------------------------------------------------------


def test_card_worker_matches_its_plain_version(hopper):
    """A card worker's task (the BSR re-tiled to 32x32 on the card, one
    ``bcsr_matmul``) against the same worker on the CPU (the plain
    version) and the host scipy path, dense and support-restricted
    operands, f32."""
    from repro_torch.cluster import shard_plan
    from repro_torch.cluster.wire import Task
    from repro_torch.cluster.worker import ShardRuntime

    rng = np.random.default_rng(11)
    A = block_sparse(rng, 256, 200, 8, 8, 0.3)
    plan = compile_plan(torch.as_tensor(A), scheme="proposed", n=6, s=2,
                        backend="packed", device="cpu")
    card = ShardRuntime(hopper, "cuda")
    plain = ShardRuntime("cpu", "cuda")
    host = ShardRuntime()
    for shard in shard_plan(plan, 3, plan_id=1):
        for rt in (card, plain, host):
            rt.load(shard)
        for j, row in enumerate(shard.task_rows):
            b = rng.standard_normal((shard.t_pad, 3)).astype(np.float32)
            kb = np.asarray(shard.supports[j][:3], np.int32)
            bx = b.reshape(-1, shard.bk, 3)[kb].reshape(-1, 3)
            for payload in ({"b": b}, {"bx": bx, "bi": kb}):
                task = Task(round=1, op="matvec", task_row=row, plan=1,
                            payload=payload)
                before = launch_counts()
                y = card.run(task)[0]["y"]
                after = launch_counts()
                assert after["bcsr_matmul"] - before["bcsr_matmul"] == 1
                assert isinstance(y, np.ndarray) and y.shape == (
                    shard.c_pad, 3)
                np.testing.assert_allclose(y, plain.run(task)[0]["y"], **TOL)
                np.testing.assert_allclose(y, host.run(task)[0]["y"], **TOL)


def test_memory_cluster_matvec_on_the_card(hopper):
    """A card plan served by card workers over the memory transport: per
    parity-mode matvec exactly k ``bcsr_matmul`` launches and one
    ``decode_matmul``, no encode; the result on the card, within f32
    tolerance of the in-process plan; no death, no requeue."""
    rng = np.random.default_rng(12)
    A = torch.as_tensor(block_sparse(rng, 512, 288, 32, 32, 0.5))
    x = torch.as_tensor(rng.standard_normal((2, 512)).astype(np.float32))
    plan = compile_plan(A.to(hopper), scheme="proposed", n=6, s=2)
    assert plan.backend == "cuda"
    with plan.to_cluster(transport="memory") as cl:
        assert (cl.fleet.backend, cl.fleet.device.type) == ("cuda", "cuda")
        for i in range(6):
            done = np.ones(6, bool)
            done[[i, (i + 3) % 6]] = False
            before = launch_counts()
            got = cl.matvec(x, done)
            torch.cuda.synchronize()
            after = launch_counts()
            assert {k: after[k] - before[k] for k in after} == {
                "bcsr_matmul": plan.k, "cyclic_encode": 0,
                "decode_matmul": 1,
                "mla_decode_attention": 0,
                "held_expert_ffn": 0}
            rep = cl.last_report
            assert (rep.deaths, rep.requeues) == (0, 0)
            assert got.device.type == "cuda" and got.shape == (2, 288)
            close(got, plan.matvec(x.to(hopper), done))
        np.testing.assert_allclose(cl.matvec(x).cpu().numpy(),
                                   (x @ A).numpy(), rtol=5e-3, atol=5e-3)


@pytest.mark.parametrize("transport", ["tcp", "shm"])
def test_process_cluster_children_compute_on_the_card(hopper, transport):
    """A card plan served by three spawned card children over tcp or
    shm: each explicit mask is bitwise the in-process ``cuda`` plan (the
    same kernel over the same 32x32 tiles); the parent launches one
    ``decode_matmul`` and no ``bcsr_matmul`` per matvec, the children k
    ``bcsr_matmul`` in all, by their own reports; shm leaves no
    segment behind."""
    import os

    rng = np.random.default_rng(13)
    A = torch.as_tensor(block_sparse(rng, 512, 288, 32, 32, 0.5))
    x = torch.as_tensor(rng.standard_normal((2, 512)).astype(np.float32))
    plan = compile_plan(A.to(hopper), scheme="proposed", n=6, s=2)
    masks = []
    for i in range(6):
        done = np.ones(6, bool)
        done[[i, (i + 3) % 6]] = False
        masks.append(done)
    with plan.to_cluster(3, transport=transport) as cl:
        tr = cl.transport
        assert (tr.device.type, tr.backend) == ("cuda", "cuda")
        base = {w: r["launches"]["bcsr_matmul"]
                for w, r in tr.reports().items()}
        for done in masks:
            before = launch_counts()
            got = cl.matvec(x, done)
            torch.cuda.synchronize()
            after = launch_counts()
            assert {k: after[k] - before[k] for k in after} == {
                "bcsr_matmul": 0, "cyclic_encode": 0, "decode_matmul": 1,
                "mla_decode_attention": 0,
                "held_expert_ffn": 0}
            assert (cl.last_report.deaths, cl.last_report.requeues) == (0, 0)
            assert torch.equal(got, plan.matvec(x.to(hopper), done))
        reports = tr.reports()
        assert sum(r["launches"]["bcsr_matmul"] - base[w]
                   for w, r in reports.items()) == plan.k * len(masks)
        for w, r in reports.items():
            assert r["pid"] == tr._procs[w].pid
            assert r["device_name"] == torch.cuda.get_device_name(hopper)
            assert r["memory_allocated"] > 0
        prefix = getattr(tr, "prefix", None)
    if prefix is not None:
        assert not [e for e in os.listdir("/dev/shm")
                    if e.startswith(prefix)]


@pytest.mark.parametrize("cols", [2, 62, 64, 128])
def test_routed_batch_is_bitwise_each_call_solo(hopper, cols):
    """A router batch of ``cols`` operand columns (calls of width 2) is
    one round: each card worker runs one ``bcsr_matmul`` at N = cols, on
    either side of the kernel's narrow-to-wide switch at 64, and each
    call's slice one ``decode_matmul``.  Every routed result is bitwise
    the same call alone in process (N = 2) under the round's pattern."""
    from repro_torch.serve import Router

    rng = np.random.default_rng(14)
    A = torch.as_tensor(block_sparse(rng, 512, 288, 32, 32, 0.5))
    xs = torch.as_tensor(rng.standard_normal(
        (cols // 2, 2, 512)).astype(np.float32))
    plan = compile_plan(A.to(hopper), scheme="proposed", n=6, s=2)
    with Router(batch_wait_s=1.0) as router:
        router.register("head", plan, n_workers=6, adaptive=False,
                        width=cols)
        fleet = router._endpoints["head"].replicas[0].fleet
        assert (fleet.backend, fleet.device.type) == ("cuda", "cuda")
        router.pause()
        futs = [router.submit("head", x) for x in xs]
        before = launch_counts()
        router.resume()
        outs = [f.result(120) for f in futs]
        torch.cuda.synchronize()
        after = launch_counts()
        log = router.dispatch_log("head")
    assert [(e["calls"], e["cols"]) for e in log] == [(len(xs), cols)]
    rep = futs[0].report
    assert all(f.report is rep for f in futs)
    launched = {k: after[k] - before[k] for k in after}
    assert launched["decode_matmul"] == len(xs)
    assert plan.k <= launched["bcsr_matmul"] <= plan.n
    assert launched["cyclic_encode"] == 0
    for x, out in zip(xs, outs):
        assert out.device.type == "cuda"
        assert torch.equal(out, plan.matvec(x.to(hopper), rep.pattern))


def test_grown_reencode_on_the_card(hopper):
    """``CodedFleet(grow_encodings=True)`` on the card: a scale-up by two
    workers re-encodes to a larger code (n' > n, k' > k, s' >= s) with
    ``cyclic_encode`` on the card, once per join; the results
    are bitwise the chosen plan in process; scaling back reuses the
    first compile (no encode) and is bitwise the pre-growth result."""
    from repro_torch.api import CodedFleet
    from repro_torch.cluster.fleet import wait_settled
    from repro_torch.scale import Autoscaler, SchedulePolicy

    rng = np.random.default_rng(15)
    A = torch.as_tensor(block_sparse(rng, 512, 288, 32, 32, 0.5))
    x = torch.as_tensor(rng.standard_normal((2, 512)).astype(np.float32))
    plan = compile_plan(A.to(hopper), scheme="proposed", n=4, s=1)
    with CodedFleet(4, device=hopper, grow_encodings=True) as fleet:
        h = fleet.attach(plan)
        all4 = np.ones(4, bool)
        first = h.matvec(x, all4)
        scaler = Autoscaler(fleet, policy=SchedulePolicy([(0, 4), (1, 6),
                                                          (3, 4)]),
                            min_members=2, max_members=8, cooldown_s=0.0)
        scaler.step(now=0.0)
        before = launch_counts()
        assert scaler.step(now=2.0).applied == 2

        wait_settled(h, 6, timeout=60)
        torch.cuda.synchronize()
        grown = h.plan
        assert grown.n > plan.n and grown.k > plan.k and grown.s >= plan.s
        # two joins, one re-encode and one compile each
        assert launch_counts()["cyclic_encode"] - before["cyclic_encode"] \
            == 2
        for i in range(3):
            done = np.ones(grown.n, bool)
            done[[i, grown.n - 1 - i][: grown.s]] = False
            assert torch.equal(h.matvec(x, done),
                               grown.matvec(x.to(hopper), done))
        assert scaler.step(now=3.0).applied == -1
        assert scaler.step(now=3.5).applied == -1
        wait_settled(h, 4, timeout=60)
        assert h.plan is plan
        assert torch.equal(h.matvec(x, all4), first)
        scaler.close()


# ---------------------------------------------------------------------------
# The coded consumers and the model families on the card
# ---------------------------------------------------------------------------


def test_coded_moe_on_the_card_matches_moe_block(hopper):
    """``CodedMoE`` at granite's routing (32 experts, top-8, capacity
    1.25, so slots drop) on the card against ``moe_block`` on the card,
    under no mask and two masks, at the reference test's 1e-4; each call
    one ``bcsr_matmul`` and one ``decode_matmul`` per expert matmul, and
    the compile one ``cyclic_encode`` per expert matrix."""
    from repro_torch.configs.base import MoEConfig
    from repro_torch.models.moe import CodedMoE, moe_block

    moe = MoEConfig(n_experts=32, top_k=8, d_expert=64)
    gen = torch.Generator(device=hopper).manual_seed(0)
    d = 128
    p = {"router": torch.randn((d, 32), generator=gen, device=hopper)
         * d ** -0.5}
    for name, shape, scale in (("w_gate", (32, d, 64), d ** -0.5),
                               ("w_up", (32, d, 64), d ** -0.5),
                               ("w_down", (32, 64, d), 64 ** -0.5)):
        p[name] = torch.randn(shape, generator=gen, device=hopper) * scale
    x = torch.randn((2, 4, d), generator=gen, device=hopper)
    before = launch_counts()
    cm = CodedMoE(p, moe, n_workers=6, stragglers=2)
    after = launch_counts()
    assert {k: after[k] - before[k] for k in after} == {
        "bcsr_matmul": 0, "cyclic_encode": 96, "decode_matmul": 0,
        "mla_decode_attention": 0,
        "held_expert_ffn": 0}
    assert set(cm.backends()) == {"cuda"}
    ref, aux_ref = moe_block(p, x, moe)
    for done in (None, np.asarray([True, False, True, True, False, True]),
                 np.asarray([False, True, True, False, True, True])):
        before = launch_counts()
        out, aux = cm(x, done)
        torch.cuda.synchronize()
        after = launch_counts()
        assert {k: after[k] - before[k] for k in after} == {
            "bcsr_matmul": 96, "cyclic_encode": 0, "decode_matmul": 96,
            "mla_decode_attention": 0,
            "held_expert_ffn": 0}
        np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(),
                                   rtol=1e-4, atol=1e-4)
        assert abs(float(aux) - float(aux_ref)) <= 1e-6


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "kimi-k2-1t-a32b",
                                  "mamba2-1.3b", "zamba2-2.7b",
                                  "phi-3-vision-4.2b", "whisper-tiny"])
def test_family_forward_on_the_card_matches_the_cpu(hopper, arch):
    """One smoke forward of each family on the card against the same
    weights on the CPU, f32."""
    import repro_torch.configs as port_configs
    from repro_torch.models import build_model

    cfg = port_configs.get_smoke_config(arch)
    cpu = build_model(cfg, torch.float32, device="cpu")
    sd = cpu.init(torch.Generator().manual_seed(0))
    card = build_model(cfg, torch.float32, device=hopper)
    card.load_state_dict(sd)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab, (2, 8))
    kw = {}
    if cfg.family == "audio":
        kw["frames"] = t(rng.standard_normal((2, cfg.encoder.n_frames,
                                              cfg.d_model)))
    if cfg.family == "vlm":
        kw["image_embeds"] = t(rng.standard_normal((2, cfg.vision_tokens,
                                                    cfg.d_model)))
    want, _ = cpu(toks, **kw)
    got, _ = card(toks, **{k: v.to(hopper) for k, v in kw.items()})
    assert got.device.type == "cuda"
    close(got.cpu(), want)


# ---------------------------------------------------------------------------
# Training on the card
# ---------------------------------------------------------------------------


def smoke_trainer(device, steps=1, **tkw):
    """A phi3-mini smoke trainer on ``device`` whose model holds the
    weights of a CPU draw from seed 0 (its ``init`` keeps them)."""
    import repro_torch.configs as port_configs
    from repro_torch.data import DataConfig, make_pipeline
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import TrainConfig, Trainer

    cfg = port_configs.get_smoke_config("phi3-mini-3.8b")
    sd = build_model(cfg, torch.float32, device="cpu").init(
        torch.Generator().manual_seed(0))
    model = build_model(cfg, torch.float32, device=device)
    model.load_state_dict(sd)
    model.init = lambda gen: None
    tr = Trainer(model, AdamWConfig(lr=1e-3, warmup_steps=0,
                                    total_steps=steps),
                 TrainConfig(steps=steps, log_every=100, **tkw))
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=4)
    return tr, (lambda start: make_pipeline(dcfg, start))


def test_train_step_on_the_card_matches_the_cpu(hopper):
    """One smoke-config step on the card against the same step on the
    CPU: the loss and the pre-clip grad norm within 1e-5, every weight's
    gradient within 1e-4 of its max |g|, and no weight moved further
    from the CPU's than two steps of lr (AdamW's first update is
    ~lr * g/(|g|+eps), whose sign can flip where |g| is near eps).  No
    port kernel runs: training is plain PyTorch."""
    from repro_torch.data import DataConfig, SyntheticTokens

    runs = {}
    for dev in ("cpu", hopper):
        tr, data = smoke_trainer(dev)
        batch = SyntheticTokens(DataConfig(
            vocab=tr.model.cfg.vocab, seq_len=16, global_batch=4)).batch_at(0)
        tr.model.requires_grad_(True)
        loss = tr.model.train_loss(batch)
        loss.backward()
        grads = {n: p.grad.detach().cpu().clone()
                 for n, p in tr.model.named_parameters()}
        before = launch_counts()
        params, _, hist = tr.fit(data, resume=False)
        assert launch_counts() == before
        runs[dev] = (float(loss.detach()), grads, hist[0],
                     {n: p.detach().cpu() for n, p in params.items()})
    (l_cpu, g_cpu, h_cpu, p_cpu), (l_gpu, g_gpu, h_gpu, p_gpu) = \
        runs["cpu"], runs[hopper]
    np.testing.assert_allclose(l_gpu, l_cpu, rtol=1e-5)
    np.testing.assert_allclose(h_gpu["loss"], h_cpu["loss"], rtol=1e-5)
    np.testing.assert_allclose(h_gpu["grad_norm"], h_cpu["grad_norm"],
                               rtol=1e-5)
    for name, g in g_cpu.items():
        scale = float(g.abs().max())
        assert float((g_gpu[name] - g).abs().max()) <= 1e-4 * scale + 1e-12
    lr = h_cpu["lr"]
    for name, p in p_cpu.items():
        assert float((p_gpu[name] - p).abs().max()) <= 2 * lr + 1e-6, name


def test_retune_on_the_card_launches_one_encode(hopper):
    """A coded plan over the card model's head, retuned by the trainer
    after its step: exactly one cyclic_encode, of a snapshot of the live
    head; then one matvec is one bcsr_matmul + one decode_matmul, within
    f32 tolerance of hidden @ head."""
    tr, data = smoke_trainer(hopper, retune_every=1)
    plan = compile_plan(tr.model.head.detach().clone(), n=6, s=2)
    assert plan.backend == "cuda"
    tr.coded_plans = [(plan, lambda p: p["head"], None)]
    before = launch_counts()
    params, _, _ = tr.fit(data, resume=False)
    torch.cuda.synchronize()
    after = launch_counts()
    assert {k: after[k] - before[k] for k in after} == {
        "bcsr_matmul": 0, "cyclic_encode": 1, "decode_matmul": 0,
        "mla_decode_attention": 0,
        "held_expert_ffn": 0}
    assert tr.retunes == [{"step": 0, "backend": "cuda", "changed": False}]
    head = params["head"].detach()
    assert plan._A is not head and torch.equal(plan._A, head)
    x = torch.randn((2, head.shape[0]), device=hopper,
                    generator=torch.Generator(hopper).manual_seed(1))
    done = np.ones(6, bool)
    done[[0, 3]] = False
    before = launch_counts()
    got = plan.matvec(x, done)
    torch.cuda.synchronize()
    after = launch_counts()
    assert {k: after[k] - before[k] for k in after} == {
        "bcsr_matmul": 1, "cyclic_encode": 0, "decode_matmul": 1,
        "mla_decode_attention": 0,
        "held_expert_ffn": 0}
    np.testing.assert_allclose(got.cpu().numpy(), (x @ head).cpu().numpy(),
                               rtol=2e-4, atol=2e-4)


# ---------------------------------------------------------------------------
# Latent attention's absorbed decode
# ---------------------------------------------------------------------------

# Kimi-K2's softmax scale (``models.mla.softmax_scale``)
MLA_SCALE = 0.13086


def mla_inputs(dev, b, length_max, seed=0, h=64, r=512, p=64,
               dtype=torch.bfloat16):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return tuple(torch.randn(shape, generator=gen, device=dev).to(dtype)
                 for shape in ((b, h, r), (b, h, p), (b, length_max, r),
                               (b, length_max, p)))


def mla_expanded(q_hat, q_pe, c, kr, length, scale, chunk=64):
    """Attention over keys [c | kr] and values c in f64, by sessions."""
    out = []
    for at in range(0, q_hat.shape[0], chunk):
        q = torch.cat([q_hat[at:at + chunk], q_pe[at:at + chunk]], -1)
        k = torch.cat([c[at:at + chunk, :length], kr[at:at + chunk, :length]],
                      -1)
        w = torch.softmax(scale * q.double() @ k.double().transpose(1, 2), -1)
        out.append(w @ c[at:at + chunk, :length].double())
    return torch.cat(out)


@pytest.mark.parametrize("length", [1, 63, 64, 65, 2049, 3072])
@pytest.mark.parametrize("b", [1, 3, 133, 1024])
def test_mla_decode_attention_against_f64(hopper, b, length):
    """The kernel's largest error against f64 is no larger than 1.1x the
    plain chain's (which rounds its scores to bf16; the kernel keeps them
    in f32), on a cache buffer of 3072 positions."""
    args = mla_inputs(hopper, b, 3072, seed=b + length)
    before = mla_decode_attention.launches
    got = mla_decode_attention(*args, length, MLA_SCALE)
    assert mla_decode_attention.launches == before + 1
    assert got.shape == (b, 64, 512) and got.dtype == torch.bfloat16
    want = mla_expanded(*args, length, MLA_SCALE)
    err = (got.double() - want).abs().max().item()
    plain = mla_decode_attention_plain(*args, length, MLA_SCALE)
    err_plain = (plain.double() - want).abs().max().item()
    assert err <= 1.1 * err_plain, (err, err_plain)


def test_mla_decode_attention_never_reads_past_length(hopper):
    """Positions at and past ``length`` hold NaN: the output is finite and
    equal to the one over a clean buffer."""
    q_hat, q_pe, c, kr = mla_inputs(hopper, 5, 300, seed=3)
    want = mla_decode_attention(q_hat, q_pe, c, kr, 130, MLA_SCALE)
    c[:, 130:], kr[:, 130:] = float("nan"), float("nan")
    got = mla_decode_attention(q_hat, q_pe, c, kr, 130, MLA_SCALE)
    assert torch.isfinite(got).all()
    assert torch.equal(got, want)


def test_mla_decode_attention_reads_strided_operands(hopper):
    """A cache sliced from a longer buffer (batch stride 4096 * 512, not
    L * 512), and q_hat laid out as ``mla_decode``'s einsum leaves it
    (heads outermost), read as their contiguous copies."""
    q_hat, q_pe, c_buf, kr_buf = mla_inputs(hopper, 7, 4096, seed=4)
    c, kr = c_buf[2:6, :3000], kr_buf[2:6, :3000]
    assert c.stride(0) == 4096 * 512
    q_heads_outer = q_hat[2:6].transpose(0, 1).contiguous().transpose(0, 1)
    assert q_heads_outer.stride() == (512, 4 * 512, 1)
    got = mla_decode_attention(q_heads_outer, q_pe[2:6], c, kr, 2500,
                               MLA_SCALE)
    want = mla_decode_attention(q_hat[2:6].contiguous(),
                                q_pe[2:6].contiguous(), c.contiguous(),
                                kr.contiguous(), 2500, MLA_SCALE)
    assert torch.equal(got, want)
    ref = mla_expanded(q_hat[2:6], q_pe[2:6], c, kr, 2500, MLA_SCALE)
    plain = mla_decode_attention_plain(q_hat[2:6], q_pe[2:6], c, kr, 2500,
                                       MLA_SCALE)
    assert ((got.double() - ref).abs().max()
            <= 1.1 * (plain.double() - ref).abs().max())


def test_mla_decode_attention_raises_instead_of_falling_back(hopper):
    q_hat, q_pe, c, kr = mla_inputs(hopper, 2, 64)
    with pytest.raises(TypeError, match="bfloat16"):
        mla_decode_attention(q_hat.float(), q_pe.float(), c.float(),
                             kr.float(), 10, MLA_SCALE)
    narrow = mla_inputs(hopper, 2, 64, r=256)
    with pytest.raises(ValueError, match="R = 512"):
        mla_decode_attention(*narrow, 10, MLA_SCALE)
    c_cols = c.transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match="stride 1"):
        mla_decode_attention(q_hat, q_pe, c_cols, kr, 10, MLA_SCALE)
    with pytest.raises(ValueError, match="expected"):
        mla_decode_attention(q_hat, q_pe, c.cpu(), kr, 10, MLA_SCALE)


def test_kimi_decode_step_launches_the_kernel_once_a_layer(hopper,
                                                           monkeypatch):
    """One ``decode_step`` of the benchmark cell's model (5 layers, 8 held
    experts, published widths, bf16) at batch 4: one launch a layer, and
    logits within the cell's median limit (4e-2 of the largest) of the
    same step through the plain chain."""
    import dataclasses

    import repro_torch.models.mla as mla_module
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = get_config("kimi-k2-instruct").with_(n_layers=5)
    cfg = cfg.with_(moe=dataclasses.replace(cfg.moe, n_held=8, held_from=0))
    model = build_model(cfg, torch.bfloat16, device=hopper)
    model.init(torch.Generator(device=hopper).manual_seed(0))
    toks = torch.randint(0, cfg.vocab, (4, 70), device=hopper,
                         generator=torch.Generator(device=hopper)
                         .manual_seed(1))
    with torch.inference_mode():
        _, cache = model.prefill(toks[:, :69], 96)
        before = mla_decode_attention.launches
        got, _ = model.decode_step(cache, toks[:, 69:])
        assert mla_decode_attention.launches == before + cfg.n_layers
        cache["step"] = 69
        monkeypatch.setattr(mla_module, "takes", lambda *route: False)
        want, _ = model.decode_step(cache, toks[:, 69:])
    assert mla_decode_attention.launches == before + cfg.n_layers
    assert torch.isfinite(got).all()
    err = (got.float() - want.float()).abs().max() / want.abs().max()
    assert err <= 4e-2, float(err)


@pytest.mark.parametrize("widths,dtype,kernel", [
    ("latent", torch.bfloat16, True),
    ("latent", torch.float32, False),
    ("latent", torch.float16, False),
    ("smoke", torch.bfloat16, False),
])
def test_mla_decode_on_the_card_routes_by_dtype_and_widths(
        hopper, monkeypatch, widths, dtype, kernel):
    """A latent model on the card decodes in every dtype at every width:
    bf16 at Kimi-K2's latent widths through the kernel (one launch a
    layer), anything else through the plain chain, as on the CPU."""
    import dataclasses

    import repro_torch.models.mla as mla_module
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_model

    cfg = get_smoke_config("kimi-k2-instruct")
    if widths == "latent":
        cfg = cfg.with_(mla=dataclasses.replace(
            cfg.mla, n_heads=64, kv_lora_rank=512, qk_rope_head_dim=64))
    model = build_model(cfg, dtype, device=hopper)
    model.init(torch.Generator(device=hopper).manual_seed(0))
    toks = torch.randint(0, cfg.vocab, (3, 10), device=hopper,
                         generator=torch.Generator(device=hopper)
                         .manual_seed(1))
    with torch.inference_mode():
        _, cache = model.prefill(toks[:, :9], 16)
        before = mla_decode_attention.launches
        got, _ = model.decode_step(cache, toks[:, 9:])
        assert (mla_decode_attention.launches
                == before + (cfg.n_layers if kernel else 0))
        cache["step"] = 9
        monkeypatch.setattr(mla_module, "takes", lambda *route: False)
        want, _ = model.decode_step(cache, toks[:, 9:])
    assert torch.isfinite(got).all()
    if kernel:
        err = (got.float() - want.float()).abs().max() / want.abs().max()
        assert err <= 4e-2, float(err)
    else:
        assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# The held experts' decode FFN
# ---------------------------------------------------------------------------

# Kimi-K2's hidden and expert widths, the decode cell's 8 held experts,
# top 8, and its 1024 tokens a step
HELD_D, HELD_FE, HELD_N, HELD_K, HELD_T = 7168, 2048, 8, 8, 1024


def held_weights(dev, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return tuple((torch.randn(shape, generator=gen, device=dev) * 0.02)
                 .bfloat16() for shape in ((HELD_N, HELD_D, HELD_FE),
                                           (HELD_N, HELD_D, HELD_FE),
                                           (HELD_N, HELD_FE, HELD_D)))


def held_routing(dev, case, seed=0, t=HELD_T):
    """(x, weights, key) of t tokens (the cell's 1024): seeded tokens routed by
    a seeded router over 384 experts (8 held), or an edge of the counts:
    every token on one expert (count t, the others none), every token's k
    places all held (every count t), or a few tokens, one of them with
    all k places held and most with none."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.moe import route_sigmoid

    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    k, held = HELD_K, HELD_N
    x = torch.randn((t, HELD_D), generator=gen, device=dev).bfloat16()
    w = torch.rand((t, k), generator=gen, device=dev) + 0.1
    key = torch.full((t, k), held, dtype=torch.long, device=dev)
    if case == "seeded":
        moe = dataclasses.replace(get_config("kimi-k2-instruct").moe,
                                  n_held=held, held_from=0)
        router = torch.randn((HELD_D, moe.n_experts), generator=gen,
                             device=dev) * 0.02
        bias = torch.randn(moe.n_experts, generator=gen, device=dev) * 0.01
        w, top = route_sigmoid(router, bias, x, moe)
        key = torch.where(top < held, top, held)
    elif case == "one_expert":
        key[:, 3] = 2
    elif case == "all_held":
        key = torch.argsort(torch.rand((t, held), generator=gen, device=dev),
                            dim=1)[:, :k]
    else:
        key[0, :3] = torch.tensor([0, 7, 1])
        key[1] = torch.tensor([2, 4, 6, 0, 1, 3, 7, 5])
        key[700, 5] = 3
    return x, w.contiguous(), key.contiguous()


def held_args(dev, case, t=HELD_T):
    x, w, key = held_routing(dev, case, t=t)
    return (x, *held_weights(dev), w, key)


def card_slot_lists(args):
    """The slot lists ``order`` and ``ends`` the kernel built on the card."""
    from repro_torch.kernels.held_experts import _launch, scratch_layout
    t = args[0].shape[0]
    _, scratch = _launch(*args)
    (at_order, at_ends, *_), _ = scratch_layout(t, HELD_D, HELD_FE, HELD_N,
                                               HELD_K)
    return (scratch[at_order:at_order + t * HELD_K * 8].view(torch.int64),
            scratch[at_ends:at_ends + (HELD_N + 1) * 8].view(torch.int64))


def held_f64(x, w_gate, w_up, w_down, weights, key):
    """The held experts' FFN in f64 over each expert's routed tokens,
    nothing rounded."""
    out = torch.zeros(x.shape, dtype=torch.float64, device=x.device)
    for e in range(w_gate.shape[0]):
        tok, place = (key == e).nonzero(as_tuple=True)
        xe = x[tok].double()
        h = (torch.nn.functional.silu(xe @ w_gate[e].double())
             * (xe @ w_up[e].double()))
        out.index_add_(0, tok, (h @ w_down[e].double())
                       * weights[tok, place].double()[:, None])
    return out


@pytest.mark.parametrize("case", ["seeded", "one_expert", "all_held",
                                  "sparse"])
def test_held_expert_ffn_against_f64(hopper, case):
    """At the decode cell's shapes the kernel's slot lists are the plain
    builder's, its largest error against the f64 product is at most 1.1x
    the plain version's (both round h to bf16 once and keep the rest in
    f32), one launch a call, and two calls give the same bits."""
    from repro_torch.kernels import (
        held_expert_ffn,
        held_expert_ffn_plain,
        held_slots,
    )
    args = held_args(hopper, case)
    before = held_expert_ffn.launches
    got = held_expert_ffn(*args)
    assert held_expert_ffn.launches == before + 1
    order, ends = card_slot_lists(args)
    want_order, want_ends = held_slots(args[5], HELD_N)
    assert torch.equal(order, want_order) and torch.equal(ends, want_ends)
    assert got.shape == (HELD_T, HELD_D) and got.dtype == torch.float32
    want = held_f64(*args)
    err = (got.double() - want).abs().max().item()
    plain = held_expert_ffn_plain(*args)
    err_plain = (plain.double() - want).abs().max().item()
    assert err <= 1.1 * err_plain, (err, err_plain)
    # a token with no held place gets zeros
    none = (args[5] >= HELD_N).all(1)
    assert not got[none].any()
    assert torch.equal(held_expert_ffn(*args), got)


@pytest.mark.parametrize("t", [1, 1000, 2500, 4096])
def test_held_expert_ffn_at_other_batches(hopper, t):
    """Seeded routing of t tokens: the sort's threads own one token, none
    (t < 1024) or several, up to 4096 tokens' 32768 places; the slot
    lists are the plain builder's and the error against f64 at most 1.1x
    the plain version's, bitwise on a repeat."""
    from repro_torch.kernels import (
        held_expert_ffn,
        held_expert_ffn_plain,
        held_slots,
    )
    args = held_args(hopper, "seeded", t=t)
    got = held_expert_ffn(*args)
    order, ends = card_slot_lists(args)
    want_order, want_ends = held_slots(args[5], HELD_N)
    assert torch.equal(order, want_order) and torch.equal(ends, want_ends)
    want = held_f64(*args)
    err = (got.double() - want).abs().max().item()
    err_plain = (held_expert_ffn_plain(*args).double() - want).abs().max()
    assert err <= 1.1 * err_plain.item(), (err, err_plain.item())
    assert torch.equal(held_expert_ffn(*args), got)


def test_held_expert_ffn_raises_instead_of_falling_back(hopper):
    from repro_torch.kernels import held_expert_ffn
    x, w_gate, w_up, w_down, w, key = held_args(hopper, "sparse")
    with pytest.raises(TypeError, match="bfloat16"):
        held_expert_ffn(x.float(), w_gate, w_up, w_down, w, key)
    with pytest.raises(ValueError, match="multiples of 64"):
        held_expert_ffn(*(a.contiguous() for a in (
            x[:, :96], w_gate[:, :96], w_up[:, :96], w_down[:, :, :96])),
            w, key)
    with pytest.raises(ValueError, match="expected"):
        held_expert_ffn(x, w_gate, w_up, w_down, w, key.cpu())


def held_layer(dev, seed=0):
    """A held-expert MoE layer at Kimi-K2's widths, 8 held, bf16."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.moe import moe_param_shapes

    moe = dataclasses.replace(get_config("kimi-k2-instruct").moe,
                              n_held=HELD_N, held_from=0)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def draw(name, shape):
        if isinstance(shape, dict):
            return {n: draw(n, s) for n, s in shape.items()}
        t = torch.randn(shape, generator=gen, device=dev) * 0.02
        return t if name in ("router", "bias") else t.bfloat16()

    return draw("", moe_param_shapes(HELD_D, moe)), moe


def test_moe_block_held_decode_step_makes_no_host_read(hopper):
    """A decode-shaped input (one token a row) runs the held experts with
    no synchronising op: the slot lists are built and read on the card."""
    from repro_torch.kernels import held_expert_ffn
    from repro_torch.models.moe import moe_block_held
    p, moe = held_layer(hopper)
    x = torch.randn((64, 1, HELD_D), device=hopper).bfloat16()
    counts = torch.zeros(HELD_N, dtype=torch.long, device=hopper)
    with torch.inference_mode():
        want, _ = moe_block_held(p, x, moe)     # builds the library
        torch.cuda.synchronize()
        before = held_expert_ffn.launches
        torch.cuda.set_sync_debug_mode("error")
        try:
            got, _ = moe_block_held(p, x, moe, counts)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    assert held_expert_ffn.launches == before + 1
    assert torch.equal(got, want)
    assert int(counts.sum()) <= 64 * moe.top_k


def test_kimi_decode_step_launches_the_held_kernel_once_a_moe_layer(
        hopper, monkeypatch):
    """One ``decode_step`` of the benchmark cell's model at batch 4: one
    ``held_expert_ffn`` launch an MoE layer, and logits within the cell's
    median limit (4e-2 of the largest) of the same step through the held
    experts' plain version."""
    import dataclasses

    import repro_torch.models.moe as moe_module
    from repro_torch.configs import get_config
    from repro_torch.kernels import held_expert_ffn
    from repro_torch.models import build_model

    cfg = get_config("kimi-k2-instruct").with_(n_layers=5)
    cfg = cfg.with_(moe=dataclasses.replace(cfg.moe, n_held=8, held_from=0))
    model = build_model(cfg, torch.bfloat16, device=hopper)
    model.init(torch.Generator(device=hopper).manual_seed(0))
    toks = torch.randint(0, cfg.vocab, (4, 70), device=hopper,
                         generator=torch.Generator(device=hopper)
                         .manual_seed(1))
    moe_layers = cfg.n_layers - cfg.first_dense
    with torch.inference_mode():
        _, cache = model.prefill(toks[:, :69], 96)
        before = held_expert_ffn.launches
        got, _ = model.decode_step(cache, toks[:, 69:])
        assert held_expert_ffn.launches == before + moe_layers
        cache["step"] = 69
        monkeypatch.setattr(moe_module, "takes", lambda *route: False)
        want, _ = model.decode_step(cache, toks[:, 69:])
    assert held_expert_ffn.launches == before + moe_layers
    assert torch.isfinite(got).all()
    err = (got.float() - want.float()).abs().max() / want.abs().max()
    assert err <= 4e-2, float(err)


# ---------------------------------------------------------------------------
# DeepSeek-V3.2's sparse decode step
# ---------------------------------------------------------------------------


def test_deepseek_sparse_decode_step_against_its_plain_chain(hopper,
                                                             monkeypatch):
    """One ``decode_step`` of the benchmark cell's model (5 layers, 8 held
    experts, published widths, bf16) at batch 2 past ``index_topk``
    (2,100 positions, so the prompt's late queries and the step select
    2,048): latent attention's kernel twice a layer (128 heads, two
    launches of 64), no host wait, and logits within the cell's median
    limit of the same step through the plain chain.  The indexer's
    selection is the same positions in layer 0, whose input is the same
    on both paths; later layers read inputs that the two attention paths
    rounded differently, and a position whose index ties the 2048th
    within that rounding may change sides (at most 2% of them)."""
    import dataclasses

    import repro_torch.models.dsa as dsa
    import repro_torch.models.mla as mla_module
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = get_config("deepseek-v3.2").with_(n_layers=5, first_dense=1)
    cfg = cfg.with_(moe=dataclasses.replace(cfg.moe, n_held=8, held_from=0))
    model = build_model(cfg, torch.bfloat16, device=hopper)
    model.init(torch.Generator(device=hopper).manual_seed(0))
    toks = torch.randint(0, cfg.vocab, (2, 2102), device=hopper,
                         generator=torch.Generator(device=hopper)
                         .manual_seed(1))
    chosen = []
    index_topk = dsa.index_topk

    def spy(*args):
        out = index_topk(*args)
        chosen.append(out.sort(-1).values)
        return out
    monkeypatch.setattr(dsa, "index_topk", spy)
    with torch.inference_mode():
        _, cache = model.prefill(toks[:, :2100], 2112)
        assert set(cache["layers"][0]) == {"c", "kr", "ik"}
        chosen.clear()
        before = mla_decode_attention.launches
        got, _ = model.decode_step(cache, toks[:, 2100:2101])
        assert mla_decode_attention.launches == before + 2 * cfg.n_layers
        kernel_chose = list(chosen)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            model.decode_step(cache, toks[:, 2101:2102])
        finally:
            torch.cuda.set_sync_debug_mode(0)
        cache["step"] = 2100
        chosen.clear()
        monkeypatch.setattr(mla_module, "takes", lambda *route: False)
        want, _ = model.decode_step(cache, toks[:, 2100:2101])
    assert mla_decode_attention.launches == before + 4 * cfg.n_layers
    assert len(kernel_chose) == len(chosen) == cfg.n_layers
    assert torch.equal(kernel_chose[0], chosen[0])
    for a, b in zip(kernel_chose, chosen):
        assert a.shape == b.shape == (2, 1, 2048)
        for row_a, row_b in zip(a.reshape(2, -1), b.reshape(2, -1)):
            same = np.intersect1d(row_a.cpu().numpy(), row_b.cpu().numpy())
            assert len(same) >= 0.98 * 2048, len(same)
    assert torch.isfinite(got).all()
    err = (got.float() - want.float()).abs().max() / want.abs().max()
    assert err <= 4e-2, float(err)


def test_deepseek_decode_graph_replays_the_eager_step(hopper):
    """``DecodeGraph`` over the same model and cache (batch 2, 2,100
    positions of 2,112): its step at 2,100 is ``decode_step``'s, logits
    and every layer's selection (the eager step scores the whole cache
    too, at this length), it counts the step's positions on the host, and
    it refuses a position before ``index_topk`` and another cache."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.decode_graph import DecodeGraph

    cfg = get_config("deepseek-v3.2").with_(n_layers=5, first_dense=1)
    cfg = cfg.with_(moe=dataclasses.replace(cfg.moe, n_held=8, held_from=0))
    model = build_model(cfg, torch.bfloat16, device=hopper)
    model.init(torch.Generator(device=hopper).manual_seed(0))
    toks = torch.randint(0, cfg.vocab, (2, 2101), device=hopper,
                         generator=torch.Generator(device=hopper)
                         .manual_seed(2))
    with torch.inference_mode():
        _, cache = model.prefill(toks[:, :2100], 2112)
        want, _ = model.decode_step(cache, toks[:, 2100:])
        chose = [blk.selected.sort(-1).values for blk in model.layers]
        graph = DecodeGraph(model, cache)
        cache["step"] = 2100
        before = [blk.attended for blk in model.layers]
        for _ in range(2):
            got, after = graph(cache, toks[:, 2100:])
            cache["step"] = 2100
        assert after["step"] == 2101 and after["layers"] is cache["layers"]
        assert torch.equal(got, want)
        for blk, c in zip(model.layers, chose):
            assert torch.equal(blk.selected.sort(-1).values, c)
        assert [blk.attended - a for blk, a in
                zip(model.layers, before)] == [2 * 2 * 2048] * cfg.n_layers
        with pytest.raises(ValueError, match="positions"):
            graph(dict(cache, step=2047), toks[:, 2100:])
        with pytest.raises(ValueError, match="cache"):
            graph(model.init_cache(2, 2112) | {"step": 2100},
                  toks[:, 2100:])


# ---------------------------------------------------------------------------
# The mesh on the card: one rank (the card machine has one card)
# ---------------------------------------------------------------------------


@pytest.fixture
def card_mesh(hopper):
    """A one-rank NCCL process group on the card (an in-memory store, no
    port) and its (1, 1) ('data', 'model') mesh."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    dist.init_process_group(
        "nccl", store=dist.HashStore(), rank=0, world_size=1,
        device_id=torch.device("cuda", torch.cuda.current_device()))
    try:
        yield init_device_mesh("cuda", (1, 1),
                               mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()


def test_one_rank_nccl_mesh_places_without_copies(card_mesh):
    """The group reduces over each axis, and a parameter placed by
    ``param_shardings`` is a DTensor over the parameter itself."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_model
    from repro_torch.parallel import param_shardings

    for axis in ("data", "model"):
        t = torch.ones(4, device="cuda")
        dist.all_reduce(t, group=card_mesh.get_group(axis))
        assert torch.equal(t, torch.ones(4, device="cuda"))
    cfg = get_smoke_config("kimi-k2-1t-a32b")
    model = build_model(cfg, torch.bfloat16, device="cuda")
    params = dict(model.named_parameters())
    for name, pls in param_shardings(card_mesh, params, cfg).items():
        d = DTensor.from_local(params[name].detach(), card_mesh, pls,
                               run_check=False)
        assert d.shape == params[name].shape
        assert d.to_local().data_ptr() == params[name].data_ptr()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_block_ep_on_the_card_matches_moe_block(card_mesh, dtype):
    """kimi's smoke MoE layer at a capacity where no slot drops: the EP
    path on the one-rank card mesh bitwise ``moe_block`` (no collective
    runs on one rank), with plain and with DTensor inputs, and the
    served forward under ``expert_parallel`` bitwise the plain one."""
    import dataclasses

    from torch.distributed.tensor import distribute_tensor

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_model
    from repro_torch.models.moe import moe_block, moe_block_ep
    from repro_torch.parallel import expert_parallel, param_shardings

    cfg = get_smoke_config("kimi-k2-1t-a32b")
    model = build_model(cfg, dtype, device="cuda")
    model.init(torch.Generator("cuda").manual_seed(0))
    moe = dataclasses.replace(cfg.moe, capacity_factor=cfg.moe.n_experts
                              / cfg.moe.top_k)
    p = model.layers[0].moe
    x = torch.randn((4, 16, cfg.d_model), device="cuda",
                    generator=torch.Generator("cuda").manual_seed(1)
                    ).to(dtype)
    with torch.inference_mode():
        want, aux = moe_block(p, x, moe)
        got, aux_ep = moe_block_ep(p, x, moe, card_mesh, ("data",), "model")
        pls = param_shardings(card_mesh, dict(model.named_parameters()), cfg)
        placed = {n: distribute_tensor(p[n].detach(), card_mesh,
                                       pls[f"layers.0.moe.{n}"])
                  for n in ("router", "w_gate", "w_up", "w_down")}
        got_dt, _ = moe_block_ep(placed, x, moe, card_mesh, ("data",),
                                 "model")
        toks = torch.randint(0, cfg.vocab, (2, 8), device="cuda")
        ref, _ = model(toks)
        with expert_parallel(card_mesh, ("data",), "model"):
            served, _ = model(toks)
    assert torch.equal(got, want) and torch.equal(aux_ep, aux)
    assert torch.equal(got_dt.full_tensor(), want)
    assert torch.equal(served, ref)


def test_restore_resharded_onto_the_card(card_mesh, tmp_path):
    """A port trainer's smoke checkpoint restored onto the card mesh:
    every leaf a DTensor on the card, bitwise the trained weights."""
    from torch.distributed.tensor import DTensor

    from repro_torch.parallel import param_shardings
    from repro_torch.train import checkpoint

    card = torch.device("cuda", torch.cuda.current_device())
    tr, data = smoke_trainer(card, steps=2, ckpt_dir=str(tmp_path),
                             ckpt_every=2)
    params, _, _ = tr.fit(data, resume=False)
    step = checkpoint.latest_step(tmp_path)
    cfg = tr.model.cfg
    got = checkpoint.restore_resharded(
        tmp_path, step, {"params": params},
        {"params": param_shardings(card_mesh, params, cfg)},
        mesh=card_mesh, cfg=cfg)
    for name, t in got["params"].items():
        assert isinstance(t, DTensor) and t.device == card
        assert torch.equal(t.full_tensor(), params[name].detach()), name
