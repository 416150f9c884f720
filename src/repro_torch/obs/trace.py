"""The ``Tracer``: spans and events in a bounded monotonic ring buffer.

A copy of ``repro.obs.trace``: framework-neutral, nothing of it changes
in the port.

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


def trace_buf_capacity() -> int:
    """Ring-buffer capacity: ``REPRO_TRACE_BUF`` or 4096."""
    return env_int(ENV_TRACE_BUF, DEFAULT_BUF)


class _Span:
    """Context manager recording one complete ("X") span on exit."""

    __slots__ = ("_tracer", "_name", "_cat", "_track", "_trace", "_args",
                 "_t0")

    def __init__(self, tracer, name, cat, track, trace, args):
        self._tracer = tracer
        self._name = name
        self._cat = cat
        self._track = track
        self._trace = trace
        self._args = args

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        t1 = time.perf_counter()
        self._tracer.complete(self._name, self._t0, t1, cat=self._cat,
                              track=self._track, trace=self._trace,
                              **self._args)
        return False


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
