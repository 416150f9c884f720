"""The device trace of a measured window, from ``torch.profiler``.

A ``--trace 1`` run holds the profiler open over its whole measured
window.  The window is one host range, ``bench.window``; the reduction
keeps what lies inside it:

- ``busy_s``: the union of every device activity (kernels, copies,
  sets), the arithmetic of ``busy_us`` in ``chip_smoke.py``;
- ``window_s``: the range's length;
- ``ops``: seconds per device op name (kernels by their short name);
- ``gaps``: the idle stretches between merged device activity, each
  named by the host op that covered its midpoint (``stats.name_gaps``).

Events are read raw from the profiler's results (no per-event Python
objects are built), so a window of several hundred thousand events
reduces in seconds.  The profiler drops a window's first launches in
some processes (``chip_smoke.trace``), so it opens before the window
and a few small launches prime it; nothing before the window is kept.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch

from stats import busy, gaps, merge, name_gaps

WINDOW = "bench.window"
# the harness's own host ranges (``bench.window``, ``bench.call``)
LABELS = "bench."
PRIMER_LAUNCHES = 20
MARGIN_S = 0.05


def short_name(name: str) -> str:
    """A kernel's name without its return type, namespace or template
    arguments: ``bcsr_narrow_kernel``, not ``void (anonymous
    namespace)::bcsr_narrow_kernel<float, 8>(...)``."""
    base = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    base = base.split("<")[0].split("(")[0].rsplit("::", 1)[-1].strip()
    return base or name


class DeviceTrace:
    """Profile the device over one measured window (see module
    docstring).  ``window()`` is the context the measured loop runs in."""

    def __init__(self, device: torch.device):
        self.device = device
        self._results = None

    def warm(self) -> None:
        """Start and stop the profiler once, so its own start-up (CUPTI)
        falls in set-up and not in the window."""
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            torch.zeros(1, device=self.device).add_(1.0)
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def window(self):
        from torch.profiler import ProfilerActivity, profile, record_function
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        prof.__enter__()
        try:
            time.sleep(MARGIN_S)
            primer = torch.zeros(1, device=self.device)
            for _ in range(PRIMER_LAUNCHES - 1):
                primer.add_(1.0)
            torch.cuda.synchronize(self.device)
            with record_function(WINDOW):
                yield
                torch.cuda.synchronize(self.device)
            time.sleep(MARGIN_S)
        finally:
            prof.__exit__(None, None, None)
        self._results = prof.profiler.kineto_results

    def reduce(self) -> dict:
        """busy_s, window_s, ops and gaps of the traced window."""
        if self._results is None:
            raise RuntimeError("no window was traced")
        return reduce_window(*split_events(self._results.events()))


def split_events(events):
    """Raw profiler events -> (device activities, host ops, window start,
    window end), each activity (start s, end s, name).  A host range's
    shadow on the device timeline (``record_function``'s GPU annotation)
    is no device work and is left out."""
    from torch.autograd import DeviceType
    device, host = [], []
    lo = hi = None
    for e in events:
        name = e.name()
        start = e.start_ns() * 1e-9
        end = start + e.duration_ns() * 1e-9
        on_device = e.device_type() == DeviceType.CUDA
        if name == WINDOW:
            if not on_device:
                lo, hi = start, end
            continue
        if on_device:
            annotation = getattr(e, "is_user_annotation", lambda: False)()
            if not (annotation or name.startswith(LABELS)):
                device.append((start, end, name))
        elif e.device_type() == DeviceType.CPU:
            host.append((start, end, name))
    if lo is None:
        raise RuntimeError(f"the trace holds no {WINDOW!r} range")
    return device, host, lo, hi


def reduce_window(device, host, lo: float, hi: float) -> dict:
    """The reduction of ``DeviceTrace.reduce`` over (start, end, name)
    device activities and host ops (seconds on one clock), kept where
    they lie inside [lo, hi]."""
    device = [a for a in device if a[0] >= lo and a[1] <= hi]
    host = [a for a in host if a[1] >= lo and a[0] <= hi]
    spans = [(a, b) for a, b, _ in device]
    merged = merge(spans, lo, hi)
    ops: dict = defaultdict(float)
    launches: dict = defaultdict(int)
    for a, b, name in device:
        ops[short_name(name)] += b - a
        launches[short_name(name)] += 1
    idle = gaps(merged, lo, hi)
    by_host: dict = defaultdict(float)
    for (a, b), name in zip(idle, name_gaps(idle, host)):
        by_host[name] += b - a
    return {"busy_s": busy(spans, lo, hi), "window_s": hi - lo,
            "ops": sorted(ops.items(), key=lambda kv: -kv[1]),
            "launches": dict(launches),
            "gaps": sorted(by_host.items(), key=lambda kv: -kv[1]),
            "n_gaps": len(idle)}


def idle_share(reduced: dict | None) -> float | None:
    """Per cent of the traced window with no device activity."""
    if reduced is None or reduced["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - reduced["busy_s"] / reduced["window_s"])
