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
        "bcsr_matmul": 1, "cyclic_encode": 1, "decode_matmul": 1}
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
        "bcsr_matmul": 0, "cyclic_encode": 0, "decode_matmul": 1}
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
        "bcsr_matmul": 0, "cyclic_encode": 1, "decode_matmul": 0}
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
            "bcsr_matmul": 1, "cyclic_encode": 0, "decode_matmul": 1}
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
                "decode_matmul": 1}
            rep = cl.last_report
            assert (rep.deaths, rep.requeues) == (0, 0)
            assert got.device.type == "cuda" and got.shape == (2, 288)
            close(got, plan.matvec(x.to(hopper), done))
        np.testing.assert_allclose(cl.matvec(x).cpu().numpy(),
                                   (x @ A).numpy(), rtol=5e-3, atol=5e-3)
