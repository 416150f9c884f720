"""The ``Tracer``: spans and events in a bounded monotonic ring buffer,
and ``scope``: the program's ranges on ``torch.profiler``'s clock.

The ``Tracer`` is a copy of ``repro.obs.trace``'s, framework-neutral.
The port adds one span helper, ``scope``, used by every span site of
the port.  It has two sinks:

- **The profiler.**  While a ``torch.profiler`` session records, every
  scope opens a ``RecordFunctionFast`` range under its name: a host op
  in the profiler's own trace, on its clock, so the device trace's idle
  gaps can be named by the program's code (``bench/devtrace.py``).
  ``PROGRAM_SPANS`` lists the plan API's names, ``MODEL_SPANS`` the
  model's.
- **The ring buffer.**  A scope given a tracer also records one complete
  span there, exactly as ``Tracer.span`` does.  Per-call ranges
  (``plan.matvec``, ``decode_cache.plan``, ``kernel.*``, ...) are never
  given one: the ring buffer stays the request and round view the port
  shares with the reference.

With neither, ``scope`` returns one shared no-op context: one profiler
check and one ``None`` test, nothing allocated.

Design constraints:

- **Near-zero cost when disabled.**  A disabled tracer is not a tracer
  with a flag -- it is ``None``.  Every instrumented hot path holds the
  tracer in a local and guards with ``if tr is not None``: one
  attribute load + one identity check, nothing else.  The ≤2 %
  closed-loop overhead criterion in ``BENCH_obs.json`` is measured
  against exactly that guard.
- **Monotonic timeline.**  All span endpoints are ``time.perf_counter``
  seconds; the tracer also records the ``(wall, mono)`` pair taken at
  construction so any record can be re-anchored to wall-clock time
  (``wall_of``) and joined with the fleet event log, which stamps both.
- **Bounded.**  Records land in a ``deque(maxlen=capacity)`` ring;
  capacity comes from ``REPRO_TRACE_BUF`` (default 4096).  Appends are
  GIL-atomic, so the fleet loop, the router scheduler thread, and
  in-process memory-transport workers can all write without a lock.

Record shape (a plain dict; ``export.chrome_trace`` maps it to the
Chrome trace-event format)::

    {"name": str, "cat": str, "ph": "X"|"i", "track": str,
     "t": float,            # perf_counter seconds (span start / instant)
     "dur": float,          # seconds; present on "X" (complete spans)
     "trace": int,          # 0 = unaffiliated, else a trace id
     "args": dict}          # structured payload; attribution reads it
"""

from __future__ import annotations

import itertools
import os
import time
from collections import deque

from .._env import env_int

ENV_TRACE = "REPRO_TRACE"
ENV_TRACE_BUF = "REPRO_TRACE_BUF"
DEFAULT_BUF = 4096

# every range the program opens under the profiler: the plan API's
# operations, the decode cache, each kernel wrapper's host side
PROGRAM_SPANS = (
    "plan.compile", "plan.encode",
    "plan.matvec", "plan.matmat", "plan.aggregate",
    "decode_cache.plan", "decode_cache.miss",
    "kernel.bcsr_matmul", "kernel.cyclic_encode",
    "kernel.decode_matmul", "kernel.decode_matmul.prepare",
)

# the model's ranges, opened the same way: a prefill and a decode step
# of ``TransformerLM``, latent attention's two forms, the sigmoid-routed
# MoE's routing, held experts and shared expert, and the LM head.  Kept
# apart from ``PROGRAM_SPANS``: the plan API's idle share reads those
# names alone
MODEL_SPANS = (
    "model.prefill", "model.decode_step", "model.head",
    "mla.prefill", "mla.decode", "mla.index", "mla.select",
    "moe.route", "moe.experts", "moe.shared",
)


def trace_buf_capacity() -> int:
    """Ring-buffer capacity: ``REPRO_TRACE_BUF`` or 4096."""
    return env_int(ENV_TRACE_BUF, DEFAULT_BUF)


class _Unbound:
    """Stands for ``torch.autograd.profiler`` until a scope first asks
    whether a profiler records: then torch is imported (so ``attrib``
    and ``export`` load without it) and the module takes its place."""

    @property
    def _is_profiler_enabled(self) -> bool:
        global _profiler, _fast_range
        import torch.autograd.profiler  # noqa: PLC0415

        _fast_range = torch._C._profiler._RecordFunctionFast
        _profiler = torch.autograd.profiler
        return _profiler._is_profiler_enabled


# ``_profiler._is_profiler_enabled``: the flag every torch profiler
# session sets while it records; read as a module attribute, it is the
# cheapest check there is
_profiler = _Unbound()
_fast_range = None              # torch's RecordFunctionFast, once bound


class _NoSpan:
    """The context ``scope`` returns with no profiler and no tracer."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, exc_type, exc, tb):
        return None


NO_SPAN = _NoSpan()


def scope(name: str, tracer: "Tracer | None" = None, *, cat: str = "span",
          track: str = "main", args: dict | None = None):
    """``with scope("plan.matvec"): ...`` -- a range under ``name`` in a
    recording profiler and, with ``tracer``, one complete span in its
    ring buffer (``cat``, ``track`` and ``args`` as ``Tracer.span``
    takes them).  With neither, the shared ``NO_SPAN``."""
    if tracer is not None:
        return _Span(tracer, name, cat, track, 0, {} if args is None
                     else args)
    if _profiler._is_profiler_enabled:
        return _fast_range(name)
    return NO_SPAN


class _Span:
    """Context manager recording one complete ("X") span on exit, and a
    profiler range over the same block while a profiler records."""

    __slots__ = ("_tracer", "_name", "_cat", "_track", "_trace", "_args",
                 "_t0", "_range")

    def __init__(self, tracer, name, cat, track, trace, args):
        self._tracer = tracer
        self._name = name
        self._cat = cat
        self._track = track
        self._trace = trace
        self._args = args

    def __enter__(self):
        self._range = (_fast_range(self._name)
                       if _profiler._is_profiler_enabled else None)
        if self._range is not None:
            self._range.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        t1 = time.perf_counter()
        if self._range is not None:
            self._range.__exit__(exc_type, exc, tb)
        self._tracer.complete(self._name, self._t0, t1, cat=self._cat,
                              track=self._track, trace=self._trace,
                              **self._args)
        return False

    def note(self, **args) -> None:
        """Add args known only inside the block to the recorded span."""
        self._args.update(args)


class Tracer:
    """Span/event sink over a bounded monotonic-clock ring buffer.

    An *instance* is always enabled -- "disabled" is represented by the
    absence of a tracer (``None``), so instrumented code pays only an
    identity check.  ``default_tracer()`` resolves the process-global
    instance when ``REPRO_TRACE=1`` and ``None`` otherwise.
    """

    def __init__(self, capacity: int | None = None):
        cap = capacity if capacity and capacity > 0 else trace_buf_capacity()
        self.capacity = cap
        self._buf: deque[dict] = deque(maxlen=cap)
        self._ids = itertools.count(1)
        # the (wall, mono) anchor pair: lets every perf_counter stamp in
        # the buffer be re-expressed as wall time, and joins span
        # timelines with event logs that stamp both clocks
        self.t0_wall = time.time()
        self.t0_mono = time.perf_counter()

    # -- ids ---------------------------------------------------------------

    def new_trace_id(self) -> int:
        """A fresh nonzero id tying one logical request's records
        together across layers (router -> fleet -> worker)."""
        return next(self._ids)

    # -- recording ---------------------------------------------------------

    def instant(self, name: str, *, cat: str = "event",
                track: str = "main", trace: int = 0, **args) -> None:
        """Record a point-in-time event."""
        self._buf.append({"name": name, "cat": cat, "ph": "i",
                          "track": track, "t": time.perf_counter(),
                          "trace": trace, "args": args})

    def complete(self, name: str, t0: float, t1: float, *,
                 cat: str = "span", track: str = "main", trace: int = 0,
                 **args) -> None:
        """Record a complete span from explicit perf_counter endpoints
        (the fleet reconstructs worker-side spans coordinator-side from
        wire timestamps, so endpoints are often not "now")."""
        self._buf.append({"name": name, "cat": cat, "ph": "X",
                          "track": track, "t": t0,
                          "dur": max(0.0, t1 - t0), "trace": trace,
                          "args": args})

    def span(self, name: str, *, cat: str = "span", track: str = "main",
             trace: int = 0, **args) -> _Span:
        """``with tracer.span("plan.compile"): ...`` -- times the block
        and records one complete span on exit."""
        return _Span(self, name, cat, track, trace, args)

    # -- reading -----------------------------------------------------------

    def events(self) -> list[dict]:
        """Snapshot of the ring buffer, oldest first."""
        return list(self._buf)

    def clear(self) -> None:
        self._buf.clear()

    def __len__(self) -> int:
        return len(self._buf)

    def wall_of(self, t_mono: float) -> float:
        """Re-anchor a perf_counter stamp to wall-clock seconds."""
        return self.t0_wall + (t_mono - self.t0_mono)


_GLOBAL: Tracer | None = None


def default_tracer() -> Tracer | None:
    """The process-global tracer when ``REPRO_TRACE`` is truthy, else
    ``None`` (the disabled representation).  Instrumented constructors
    call this once; hot paths never re-read the environment."""
    global _GLOBAL
    if os.environ.get(ENV_TRACE, "") in ("", "0"):
        return None
    if _GLOBAL is None:
        _GLOBAL = Tracer()
    return _GLOBAL
