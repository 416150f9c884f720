"""Coded executor: one API, pluggable sparsity-aware backends.

The paper's claim is that weight-omega encodings keep the per-worker
cost proportional to ``omega / k_A`` of the dense cost.  The backends
realise that claim at different altitudes:

  * ``reference`` -- dense ``torch.einsum`` over ALL n workers and a
    per-call ``torch.linalg.solve``: the numerics baseline, and the only
    path autograd can differentiate.
  * ``packed``    -- host **packed block-sparse** path: the packed tiles
    are exported as scipy BSR shards, only the fastest-k workers'
    shards are multiplied, and decode is a cached-inverse matmul.  Work
    scales with the nonzero-tile count.  The CPU fast path.
  * ``cuda``      -- the same packed layout (32 x 32 tiles) run by the
    hand-written kernels ``bcsr_matmul``, ``cyclic_encode`` and
    ``decode_matmul``.  On CPU tensors the kernel wrappers run their
    plain PyTorch versions, which is how the tests exercise this path.

Backend selection: the ``REPRO_CODED_BACKEND`` environment variable
overrides everything; otherwise an explicit ``backend=`` wins;
otherwise the device default applies (``cuda`` for a CUDA operand,
``reference`` elsewhere).  Inputs that require grad take the reference
path whatever the backend, since the sparse paths are not
differentiable.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from .._device import as_tensor, resolve_device
from ..kernels.bcsr_matmul import bcsr_matmul
from ..kernels.cyclic_encode import cyclic_encode
from ..kernels.decode_matmul import (
    MAX_K,
    decode_matmul,
    launch_decode,
    prepare_decode,
)
from ..kernels.ref import cyclic_encode_ref
from .decode_cache import DecodeCache
from .pack import PackedShards, bsr_shards, pack_coded_blocks

ENV_BACKEND = "REPRO_CODED_BACKEND"

BACKENDS = ("reference", "packed", "cuda")

# Packing tile per backend.  The cuda backend packs 32 x 32: a warp's
# width, so each tile row is one coalesced 128-byte f32 load, and four
# times the reference's 8 x 8 host tile along each edge, which cuts the
# per-slot index and loop overhead 16-fold at the cost of coarser
# sparsity (a tile is kept if any of its 1024 entries is nonzero).
CUDA_TILE = 32
HOST_TILE = 8


def resolve_backend(backend: str | None = None, device=None) -> str:
    """Env override > explicit argument > device default.

    ``"auto"`` (and None) resolve to the device default here: ``cuda``
    when ``device`` is a CUDA device, else ``reference``.  The density
    pick lives in ``repro_torch.api.backends.choose_backend``.
    """
    env = os.environ.get(ENV_BACKEND)
    if env and env != "auto":
        backend = env       # a concrete env backend forces every call site
    if backend is None or backend == "auto":
        on_cuda = device is not None and torch.device(device).type == "cuda"
        backend = "cuda" if on_cuda else "reference"
    if backend not in BACKENDS:
        raise ValueError(f"unknown coded backend {backend!r}; "
                         f"choose from {BACKENDS}")
    return backend


def tracks_grad(*vals) -> bool:
    """True when any tensor argument requires grad (None entries and
    non-tensors ignored): such calls take the reference path."""
    return any(isinstance(v, torch.Tensor) and v.requires_grad
               for v in vals)


# ---------------------------------------------------------------------------
# Encoding (Alg. 1 / Alg. 2 line: coded_i = sum_j coef[i,j] * blocks[sup[i,j]])
# ---------------------------------------------------------------------------


def merge_unknowns(u: torch.Tensor, k_A: int, k_B: int, r: int,
                   w: int) -> torch.Tensor:
    """Decoded unknowns (k_A * k_B, ca, cb) -> A^T B (r, w): unknown
    i = ia * k_B + ib is the (ia, ib) block."""
    k, ca, cb = u.shape
    out = u.reshape(k_A, k_B, ca, cb).permute(0, 2, 1, 3)
    return out.reshape(k_A * ca, k_B * cb)[:r, :w]


def support_tables(supports, R) -> tuple[np.ndarray, np.ndarray]:
    """Padded (sup, coef) tables for the gather-style encoders.

    Rows are padded to the max support size with (index 0, coef 0.0)
    slots, which contribute nothing.
    """
    R = np.asarray(R)
    w = max(len(t) for t in supports)
    sup = np.zeros((len(supports), w), dtype=np.int32)
    coef = np.zeros((len(supports), w), dtype=np.float32)
    for i, t in enumerate(supports):
        idx = list(t)
        sup[i, : len(idx)] = idx
        coef[i, : len(idx)] = R[i, idx]
    return sup, coef


def encode_blocks(blocks: torch.Tensor, sup, coef,
                  backend: str | None = None) -> torch.Tensor:
    """Encode stacked block-columns (k, T, C) -> coded (n, T, C) f32.

    O(omega) reads per coded output on every backend; ``cuda`` runs
    the ``cyclic_encode`` kernel (its plain version on CPU tensors).
    """
    dev = blocks.device
    backend = resolve_backend(backend, dev)
    sup = as_tensor(sup, dev, torch.int32).contiguous()
    coef = as_tensor(coef, dev, torch.float32).contiguous()
    if backend == "cuda":
        # the kernel reads a strided view (split_block_columns') in place
        if blocks.stride(-1) != 1:
            blocks = blocks.contiguous()
        return cyclic_encode(blocks, sup, coef)
    return cyclic_encode_ref(blocks, sup, coef)


# ---------------------------------------------------------------------------
# The executor
# ---------------------------------------------------------------------------


class CodedExecutor:
    """Backend-dispatched encode / worker-compute / decode engine.

    Bound to one pre-encoded operator: coded shards ``coded (n, t, c)``,
    system matrix ``G (n, k)`` and logical output width ``r``, all on
    one device (``coded``'s, or ``device``).
    """

    def __init__(self, coded, G, k: int, r: int,
                 backend: str | None = None, *,
                 bk: int | None = None, bm: int | None = None,
                 cache_size: int = 64, device=None):
        self.device = resolve_device(device, coded)
        self.backend = resolve_backend(backend, self.device)
        self.coded = as_tensor(coded, self.device)
        if tracks_grad(self.coded):
            self.backend = "reference"
        self.G = as_tensor(G, self.device, torch.float32)
        self.k = k
        self.r = r
        self.n, self.t, self.c = self.coded.shape
        self.packed: PackedShards | None = None
        self.cache: DecodeCache | None = None
        self.pack_seconds = 0.0
        self._bsr = None            # lazy scipy BSR shards ("packed")
        # the cuda decode's layouts, each checked on its first call
        self._decode_layouts: dict = {}
        if self.backend == "cuda" and {bk, bm} - {None, CUDA_TILE}:
            raise ValueError(f"the cuda backend packs {CUDA_TILE}x{CUDA_TILE} "
                             f"tiles, got bk={bk}, bm={bm}")
        if self.backend == "cuda" and k > MAX_K:
            raise ValueError(f"the cuda backend decodes at most {MAX_K} "
                             f"unknowns, got k={k}")
        if self.backend != "reference":
            tile = CUDA_TILE if self.backend == "cuda" else HOST_TILE
            t0 = time.perf_counter()
            self.packed = pack_coded_blocks(self.coded.detach(),
                                            bk or tile, bm or tile)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.pack_seconds = time.perf_counter() - t0
            self.cache = DecodeCache(self.G.cpu().numpy(), k,
                                     maxsize=cache_size, device=self.device)

    def _bsr_shards(self):
        if self._bsr is None:
            self._bsr = bsr_shards(self.packed)
        return self._bsr

    # -- introspection ----------------------------------------------------

    def worker_tile_counts(self) -> np.ndarray:
        """Nonzero packed tiles per worker -- the omega-scaling quantity
        (proportional to per-apply work on this worker)."""
        if self.packed is None:
            packed = pack_coded_blocks(self.coded.detach(), HOST_TILE,
                                       HOST_TILE)
            return np.asarray(packed.tile_counts)
        return np.asarray(self.packed.tile_counts)

    def _fast_path(self, *vals) -> bool:
        return self.backend != "reference" and not tracks_grad(*vals)

    def _all_alive(self, done):
        return np.ones(self.n, dtype=bool) if done is None else done

    # -- matvec: A^T x ----------------------------------------------------

    def matvec(self, x, done=None) -> torch.Tensor:
        """A^T x for x (t,) or (batch, t); returns (r,) / (batch, r)."""
        x = as_tensor(x, self.device)
        squeeze = x.ndim == 1
        xb = x[None, :] if squeeze else x
        if self._fast_path(x, done):
            out = self._matvec_packed(xb, done)
        else:
            out = self._matvec_reference(xb, done)
        return out[0] if squeeze else out

    def _solve(self, done, y: torch.Tensor) -> torch.Tensor:
        """Per-call reference solve of G[rows] U = Y[rows] (f32)."""
        from ..core.coded_matmul import fastest_k_rows  # noqa: PLC0415

        done = as_tensor(self._all_alive(done), self.device, torch.bool)
        rows = fastest_k_rows(done, self.k)
        ysub = y[rows].reshape(self.k, -1).to(torch.float32)
        return torch.linalg.solve(self.G[rows], ysub)

    def _matvec_reference(self, xb, done):
        dt = torch.promote_types(self.coded.dtype, xb.dtype)
        y = torch.einsum("ntc,bt->nbc", self.coded.to(dt), xb.to(dt))
        u = self._solve(done, y)
        b = xb.shape[0]
        u = u.reshape(self.k, b, -1).transpose(0, 1).reshape(b, -1)
        return u[:, : self.r]

    def _matvec_packed(self, xb, done):
        plan = self.cache.plan(self._all_alive(done))
        packed = self.packed
        b = xb.shape[0]
        if self.backend == "cuda":
            # one launch over the k live workers, read in place
            y = bcsr_matmul(packed.a_data, packed.a_idx, xb.T.contiguous(),
                            plan.rows_dev, mb=packed.mb,
                            counts=packed.counts)
            # the decode stores (b, r) itself, skipping the pad columns
            return self._decode(plan, y.view(self.k, packed.c_pad, b), "mv",
                                c=packed.c, r=self.r)
        # scipy BSR shards: nnz-tile-proportional worker products,
        # stragglers (and zero tiles) never touched; host numpy end to
        # end, one transfer back at the end
        shards = self._bsr_shards()
        b_op = np.zeros((packed.t_pad, b), np.float32)
        b_op[: packed.t] = xb.detach().to("cpu", torch.float32).numpy().T
        y = np.stack([shards[i] @ b_op for i in plan.rows])
        u = plan.hinv @ y.reshape(self.k, -1)
        u = u.reshape(self.k, packed.c_pad, b)[:, : packed.c]
        out = np.moveaxis(u, 2, 0).reshape(b, -1)[:, : self.r]
        return torch.from_numpy(np.ascontiguousarray(out)).to(self.device)

    # -- matmat: per-worker A_i^T B_i, decoded unknowns --------------------

    def matmat(self, coded_b, done=None, *, merge=None) -> torch.Tensor:
        """Decoded unknowns U (k, ca, cb) from paired coded operands.

        ``self.coded`` holds the coded A shards, ``coded_b`` the coded B
        shards (n, t, cb); ``self.G`` must be the Khatri-Rao system over
        the k = k_A * k_B unknowns.  With ``merge=(k_A, k_B, r, w)`` the
        result is A^T B (r, w) instead (``merge_unknowns``), which the
        ``cuda`` decode stores directly.
        """
        coded_b = as_tensor(coded_b, self.device)
        if merge is not None and merge[0] * merge[1] != self.k:
            raise ValueError(f"merge {merge}: k_A * k_B must be k={self.k}")
        if self._fast_path(coded_b, done):
            return self._matmat_packed(coded_b, done, merge)
        u = self._matmat_reference(coded_b, done)
        return u if merge is None else merge_unknowns(u, *merge)

    def _matmat_reference(self, coded_b, done):
        dt = torch.promote_types(self.coded.dtype, coded_b.dtype)
        p = torch.einsum("ntc,ntd->ncd", self.coded.to(dt), coded_b.to(dt))
        u = self._solve(done, p)
        return u.reshape((self.k,) + p.shape[1:])

    def _matmat_packed(self, coded_b, done, merge):
        plan = self.cache.plan(self._all_alive(done))
        packed = self.packed
        cb = coded_b.shape[2]
        # stragglers' products are never computed: fastest-k only
        if self.backend == "cuda":
            # one launch: live worker j's block-rows times its own B shard
            y = bcsr_matmul(packed.a_data, packed.a_idx,
                            coded_b.contiguous(), plan.rows_dev,
                            mb=packed.mb, counts=packed.counts)
            y = y.view(self.k, packed.c_pad, cb)
            # the decode stores the merged (r, w), or the unknowns one
            # under another; Y's pad columns are never decoded
            if merge is not None:
                _, kb, r, w = merge
                return self._decode(plan, y, "mm", c=packed.c, r=r, w=w,
                                    kb=kb)
            u = self._decode(plan, y, "mm", c=packed.c, r=self.k * packed.c,
                             w=cb)
            return u.view(self.k, packed.c, cb)
        shards = self._bsr_shards()
        b_np = coded_b.detach().to("cpu", torch.float32).numpy()
        b_op = np.zeros((self.k, packed.t_pad, cb), np.float32)
        b_op[:, : packed.t] = b_np[plan.rows, : packed.t]
        y = np.stack([shards[i] @ b_op[j] for j, i in enumerate(plan.rows)])
        y = y[:, : packed.c]                            # (k, ca, cb)
        u = plan.hinv @ y.reshape(self.k, -1)
        u = u.reshape((self.k,) + y.shape[1:])
        u = torch.from_numpy(np.ascontiguousarray(u)).to(self.device)
        return u if merge is None else merge_unknowns(u, *merge)

    def _decode(self, plan, y, mode, **kw):
        """One cuda decode launch.  A layout (y's shape, strides and dtype
        and the scalars) is checked on its first call and then launched
        without checks: the decode plans' inverse and rows always are
        f32 and int32 on this executor's device."""
        rows = plan.rows_dev if mode == "gather" else None
        if not y.is_cuda:
            return decode_matmul(plan.hinv_dev, y, mode, rows=rows, **kw)
        key = (mode, y.shape, y.stride(), y.dtype, *kw.values())
        layout = self._decode_layouts.get(key)
        if layout is None:
            if len(self._decode_layouts) >= 64:
                self._decode_layouts.clear()
            layout = self._decode_layouts[key] = prepare_decode(
                plan.hinv_dev, y, mode, rows=rows, **kw)
        return launch_decode(layout, plan.hinv_dev, y, rows)

    # -- decode-only: worker results supplied by the caller ----------------

    def decode(self, y, done=None) -> torch.Tensor:
        """Worker results y (n, ..., c) -> decoded output (..., r)."""
        y = as_tensor(y, self.device)
        if self._fast_path(y, done):
            plan = self.cache.plan(self._all_alive(done))
            if self.backend == "cuda":
                return self._decode_gather(plan, y)
            ysub = y[plan.rows_dev.long()].to(torch.float32)
            flat = ysub.reshape(self.k, -1).contiguous()
            u = plan.hinv_dev @ flat
        else:
            ysub = y
            u = self._solve(done, y)
        u = u.reshape((self.k,) + ysub.shape[1:])
        u = torch.movedim(u, 0, -2)
        out = u.reshape(u.shape[:-2] + (self.k * u.shape[-1],))[..., : self.r]
        return out.to(y.dtype)

    def _decode_gather(self, plan, y):
        """One decode launch: the live rows of y read in place, (..., r)
        stored in y's dtype.  Other dtypes than f32 and bf16 are decoded
        from an f32 copy."""
        yk = y if y.dtype in (torch.float32, torch.bfloat16) else y.float()
        # (n, L, c): a view unless the middle axes do not merge
        yk = yk.reshape(yk.shape[0], -1, yk.shape[-1])
        if yk.shape[2] > 1 and yk.stride(2) != 1:
            yk = yk.contiguous()
        r = min(self.r, self.k * yk.shape[2])
        out = self._decode(plan, yk, "gather", r=r)
        return out.view(y.shape[1:-1] + (r,)).to(y.dtype)
