"""Plan compilation: scheme + encoding + packed shards + backend, once.

``compile_plan`` is the port's entry point for coded computation.  It
fuses everything that is per-*operator* rather than per-*call*:

  * the scheme (via the registry, ``repro_torch.api.schemes``),
  * the encoding matrices (host numpy, seeded as in the reference),
  * the encoded / packed shards on the plan's device (weight-omega
    encode by the ``cyclic_encode`` kernel and block-sparse packing on
    the sparse backends),
  * the backend choice (``backend="auto"``: ``cuda`` on a CUDA device,
    else the density pick of ``repro_torch.api.backends``),
  * a pre-warmed decode cache (the all-alive pattern never pays a solve).

The compiled ``CodedPlan`` then exposes the per-call operations:

    plan = compile_plan(A, scheme="proposed", n=16, s=2)
    y = plan.matvec(x, done=mask)        # A^T x, straggler-resilient
    U = plan.matmat(B, done=mask)        # A^T B   (mm plans)
    g = plan.aggregate(payloads, done=mask)  # coded gradient sum

The plan runs on the card unless the caller asks for the CPU: a tensor
operand brings its device, anything else defaults to ``"cuda"``.
Plans compiled without an operand are aggregation-only: they own the
decode machinery but no shards.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from .._device import as_tensor, resolve_device
from ..core.assignment import MMScheme, MVScheme
from ..core.coded_matmul import split_block_columns
from ..core.decoding import system_matrix
from ..core.encoding import mm_encoding_matrices, mv_encoding_matrix
from ..obs.trace import default_tracer, scope
from ..runtime import (
    CodedExecutor,
    DecodeCache,
    encode_blocks,
    support_tables,
    tracks_grad,
)
from .backends import choose_backend
from .schemes import make_scheme


def _match_dtype(coded: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """Keep the encoded shards in the operand dtype.

    The weight-omega encoders accumulate in f32; a bf16 operand (LM-head
    serving) must not silently double the coded shards' footprint --
    the n/k-redundant shards are the dominant memory cost.
    """
    return coded if coded.dtype == A.dtype else coded.to(A.dtype)


def _tree_map(fn, *trees):
    """Map ``fn`` over matching leaves of dict / list / tuple trees."""
    first = trees[0]
    if isinstance(first, dict):
        return {key: _tree_map(fn, *(t[key] for t in trees)) for key in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_tree_map(fn, *leaves) for leaves in zip(*trees))
    return fn(*trees)


@dataclass(eq=False)
class CodedPlan:
    """A precompiled coded operator (see module docstring).

    Public attributes are read-only by convention; per-call state lives
    entirely in the LRU decode cache (safe to share across steps).
    """

    scheme: MVScheme | MMScheme
    kind: str                       # "mv" | "mm"
    backend: str                    # concrete backend (auto already resolved)
    seed: int
    G: np.ndarray                   # (n_tasks, k) decode system matrix
    r: int | None = None            # logical output dim (None: aggregation-only)
    executor: CodedExecutor | None = field(default=None, repr=False)
    device: torch.device = field(default_factory=lambda: torch.device("cpu"))
    cache_size: int = 64
    # mm-only: per-call B-side encoding state (device tensors)
    _rb: np.ndarray | None = field(default=None, repr=False)
    _sup_b: torch.Tensor | None = field(default=None, repr=False)
    _coef_b: torch.Tensor | None = field(default=None, repr=False)
    _agg_cache: DecodeCache | None = field(default=None, repr=False)
    # operand reference kept for ``retune``; a reference, not a copy
    _A: torch.Tensor | None = field(default=None, repr=False)

    # -- introspection ----------------------------------------------------

    @property
    def n(self) -> int:
        return self.scheme.n

    @property
    def k(self) -> int:
        return self.scheme.k

    @property
    def s(self) -> int:
        return self.scheme.s

    @property
    def tasks_per_worker(self) -> int:
        return getattr(self.scheme, "tasks_per_worker", 1)

    @property
    def n_tasks(self) -> int:
        return self.G.shape[0]

    def describe(self) -> dict:
        """Metadata for logs / benchmarks / schedulers."""
        d = {
            "scheme": self.scheme.name, "kind": self.kind,
            "backend": self.backend, "n": self.n, "k": self.k,
            "s": self.s, "weight": self.scheme.weight(), "seed": self.seed,
            "device": str(self.device),
        }
        if self.executor is not None and self.executor.cache is not None:
            d["decode_cache"] = {"hits": self.executor.cache.hits,
                                 "misses": self.executor.cache.misses}
        return d

    def worker_tile_counts(self) -> np.ndarray:
        """Nonzero packed tiles per worker (the omega-scaling quantity)."""
        if self.executor is None:
            raise ValueError("aggregation-only plan holds no shards")
        return self.executor.worker_tile_counts()

    # -- done-mask plumbing ----------------------------------------------

    def _task_done(self, done):
        """Worker-level done mask -> task-row mask (Delta-partition
        baselines run ``tasks_per_worker`` tasks per worker).  A mask
        already at task granularity (length ``n_tasks``) passes
        through -- that is how partial stragglers are expressed."""
        if done is None:
            return None
        per = self.tasks_per_worker
        if per == 1 or len(done) == self.n_tasks:
            return done
        if isinstance(done, torch.Tensor):
            return torch.repeat_interleave(done.to(torch.bool), per)
        return np.repeat(np.asarray(done, bool), per)

    def _decode_cache(self) -> DecodeCache:
        if self.executor is not None and self.executor.cache is not None:
            return self.executor.cache
        if self._agg_cache is None:
            self._agg_cache = DecodeCache(self.G, self.k,
                                          maxsize=self.cache_size,
                                          device=self.device)
        return self._agg_cache

    # -- per-call operations ----------------------------------------------

    def matvec(self, x, done=None) -> torch.Tensor:
        """A^T x for x (t,) or (batch, t); tolerates any s stragglers."""
        if self.kind != "mv":
            raise ValueError("matvec needs an mv plan; this plan is "
                             f"kind={self.kind!r}")
        if self.executor is None:
            raise ValueError("plan compiled without an operand; pass A to "
                             "compile_plan for matvec")
        with scope("plan.matvec"):
            return self.executor.matvec(x, self._task_done(done))

    def matmat(self, B, done=None) -> torch.Tensor:
        """A^T B through the paired-encode pipeline; returns (r, w)."""
        if self.kind != "mm":
            raise ValueError("matmat needs an mm plan; this plan is "
                             f"kind={self.kind!r}")
        if self.executor is None:
            raise ValueError("plan compiled without an operand; pass A to "
                             "compile_plan for matmat")
        with scope("plan.matmat"):
            sch = self.scheme
            B = as_tensor(B, self.device)
            w = B.shape[1]
            blocks_b = split_block_columns(B, sch.k_B)
            if self.backend == "reference" or tracks_grad(B):
                rb = torch.as_tensor(self._rb, dtype=B.dtype,
                                     device=self.device)
                coded_b = torch.einsum("nk,ktc->ntc", rb, blocks_b)
            else:
                coded_b = encode_blocks(blocks_b, self._sup_b,
                                        self._coef_b, self.backend)
            # (r, w) from the executor: on cuda the decode stores it
            return self.executor.matmat(coded_b, done,
                                        merge=(sch.k_A, sch.k_B, self.r, w))

    def aggregate(self, payloads, done=None):
        """Straggler-resilient sum of the k shard-gradients.

        ``payloads`` is the length-n list of worker payloads (tensors,
        or dicts / lists / tuples of them), each ``sum_q R[i,q] g_q``
        over the worker's support; straggler entries may hold garbage.
        The decode vector ``a`` (``a^T R[rows] = 1^T``) comes from the
        LRU-cached per-pattern inverse.
        """
        if self.kind != "mv":
            raise ValueError("aggregate needs an mv plan; this plan is "
                             f"kind={self.kind!r}")
        with scope("plan.aggregate"):
            task_done = self._task_done(done)
            if task_done is None:
                task_done = np.ones(self.n_tasks, bool)
            dplan = self._decode_cache().plan(task_done)
            # a^T G[rows] = 1^T  <=>  a = (G[rows]^{-1})^T 1 = colsums(hinv)
            a = dplan.hinv_dev.sum(dim=0)
            rows = dplan.rows
            return _tree_map(
                lambda *xs: torch.einsum(
                    "i,i...->...", a,
                    torch.stack([xs[int(i)] for i in rows]).to(a.device,
                                                               a.dtype)),
                *payloads)

    # -- distribution ------------------------------------------------------

    def to_cluster(self, n_workers: int | None = None, *,
                   transport: str | None = None, faults=None,
                   deadline: float | None = None, **kw):
        """Serve this plan from real workers (``repro_torch.cluster``).

        Returns a ``ClusterPlan`` with the same ``matvec / matmat /
        aggregate`` signatures; per-worker ``PlanShard``s are shipped
        once at construction and every call dispatches tasks, collects
        results asynchronously and decodes at the fastest-k task set.
        The workers follow the plan: a ``cuda`` plan is served by card
        workers (one ``bcsr_matmul`` per task, one ``decode_matmul`` per
        round, on the plan's device), any other plan by host workers.
        ``transport`` picks the byte carrier (``memory`` | ``pipe``;
        default: the ``REPRO_CLUSTER_TRANSPORT`` env var, then
        ``memory``).  ``n_workers`` < n hosts several
        virtual workers per physical one (the partial-straggler
        setting).  Extra keywords (``heartbeat_s``, ``suspect_after``)
        tune the liveness protocol.  Shut the cluster down (``with``
        block or ``.shutdown()``) when done -- the transport owns real
        processes and threads.

        A ``ClusterPlan`` is a private single-plan session (one fleet,
        ``max_inflight=1``).  To share one worker set across several
        plans -- and get async futures, pipelined in-flight rounds and
        matvec microbatching -- build a ``repro_torch.api.fleet.
        CodedFleet`` and ``fleet.attach(plan)`` instead.
        """
        from ..cluster import ClusterPlan  # noqa: PLC0415 - optional layer

        return ClusterPlan(self, n_workers, transport=transport,
                           faults=faults, deadline=deadline, **kw)

    # -- online re-tuning --------------------------------------------------

    def retune(self, A=None, *, crossover: float | None = None) -> str:
        """Re-measure sparsity and re-pick the backend.

        Recompiles the encoded/packed state when either the backend
        choice or the operand itself changed.  ``A=None`` re-measures
        the operand the plan was compiled with.  Returns the (possibly
        updated) backend name.
        """
        A = A if A is not None else self._A
        if A is None:
            raise ValueError("plan holds no operand; pass A= to retune")
        A = as_tensor(A, self.device)
        new = choose_backend(A, "auto", crossover=crossover,
                             device=self.device)
        if new != self.backend or A is not self._A:
            self.backend = new
            _attach_operand(self, A, new)
        return self.backend

    # -- cache management --------------------------------------------------

    def prewarm(self, done=None) -> "CodedPlan":
        """Precompute the decode plan for a pattern (default all-alive)."""
        if self.executor is not None and self.executor.cache is None:
            # reference executor: solves per call, never consults a cache
            return self
        task_done = self._task_done(done)
        if task_done is None:
            task_done = np.ones(self.n_tasks, bool)
        self._decode_cache().plan(task_done)
        return self


def compile_plan(A=None, *, scheme="proposed", n=None, s=None,
                 k_A=None, k_B=None, capacities=None, seed: int = 0,
                 backend: str | None = "auto", cache_size: int = 64,
                 device=None) -> CodedPlan:
    """Compile a ``CodedPlan`` (see module docstring).

    ``scheme`` is a registry name (``repro_torch.api.list_schemes()``)
    or an already-built ``MVScheme`` / ``MMScheme``.  ``device`` defaults
    to A's device when A is a tensor, else ``"cuda"``; a CUDA device on a
    machine without one raises.  ``backend="auto"`` (the default) picks
    ``cuda`` on a CUDA device and the density pick elsewhere; the
    ``REPRO_CODED_BACKEND`` env var overrides everything, including auto.
    Without ``A`` the plan is aggregation-only.

    The compile is one ``plan.compile`` range under a recording profiler
    and, with a tracer set (``REPRO_TRACE``), one complete event on the
    host clock.
    """
    tr = default_tracer()
    with scope("plan.compile", tr, cat="plan", track="plan") as span:
        dev = resolve_device(device, A)
        if isinstance(scheme, (MVScheme, MMScheme)):
            sch = scheme
        else:
            sch = make_scheme(scheme, n=n, s=s, k_A=k_A, k_B=k_B,
                              capacities=capacities)
        kind = "mm" if isinstance(sch, MMScheme) else "mv"
        G = np.asarray(system_matrix(sch, seed))
        if A is not None:
            A = as_tensor(A, dev)
        resolved = choose_backend(A, backend, device=dev)

        plan = CodedPlan(scheme=sch, kind=kind, backend=resolved, seed=seed,
                         G=G, device=dev, cache_size=cache_size)
        if A is not None:
            _attach_operand(plan, A, resolved)
        elif kind == "mv":
            plan.prewarm()  # aggregation-only: warm the all-alive pattern
        if tr is not None:
            span.note(kind=kind, backend=resolved, n=sch.n,
                      has_operand=A is not None)
    return plan


def _attach_operand(plan: CodedPlan, A: torch.Tensor, resolved: str) -> None:
    """(Re)build the per-operand state: encode, pack, prewarm.

    Shared by initial compilation and ``plan.retune``.  The attach is
    one ``plan.encode`` span of host time (a profiler range, and a ring
    buffer span with a tracer set): on the card it ends once the encode
    and pack are enqueued, which may be before the device has finished
    them.
    """
    if A.ndim != 2:
        raise ValueError(f"operand must be 2-D (t, r), got {tuple(A.shape)}")
    with scope("plan.encode", default_tracer(), cat="plan", track="plan",
               args={"kind": plan.kind, "backend": resolved,
                     "shape": list(A.shape)}):
        _attach_operand_inner(plan, A, resolved)


def _attach_operand_inner(plan: CodedPlan, A: torch.Tensor,
                          resolved: str) -> None:
    sch, G, seed = plan.scheme, plan.G, plan.seed
    dev = plan.device
    if plan.kind == "mv":
        R = mv_encoding_matrix(sch, seed)
        blocks = split_block_columns(A, sch.k_A)
        if resolved == "reference":
            coded = torch.einsum(
                "nk,ktc->ntc", torch.as_tensor(R, dtype=A.dtype, device=dev),
                blocks)
        else:
            sup, coef = support_tables(sch.supports, R)
            coded = encode_blocks(blocks, sup, coef, resolved)
        plan.executor = CodedExecutor(
            _match_dtype(coded, A), G, sch.k_A, A.shape[1],
            backend=resolved, cache_size=plan.cache_size, device=dev)
    else:
        ra, rb = mm_encoding_matrices(sch, seed)
        blocks_a = split_block_columns(A, sch.k_A)
        if resolved == "reference":
            coded_a = torch.einsum(
                "nk,ktc->ntc", torch.as_tensor(ra, dtype=A.dtype, device=dev),
                blocks_a)
            plan._sup_b = plan._coef_b = None
        else:
            sup_a, coef_a = support_tables(sch.supports_A, ra)
            coded_a = encode_blocks(blocks_a, sup_a, coef_a, resolved)
            sup_b, coef_b = support_tables(sch.supports_B, rb)
            plan._sup_b = torch.as_tensor(sup_b, device=dev)
            plan._coef_b = torch.as_tensor(coef_b, device=dev)
        plan._rb = rb
        plan.executor = CodedExecutor(
            _match_dtype(coded_a, A), G, sch.k, A.shape[1],
            backend=resolved, cache_size=plan.cache_size, device=dev)
    plan.r = A.shape[1]
    if not tracks_grad(A):
        plan._A = A
        plan.prewarm()
