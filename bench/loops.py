"""The loops that drive a system through a measured window.

``closed_loop``: one caller calls back to back; each call is timed on
the device's clock, with events recorded before the call and after its
result and synchronised on, so a ~1 ms call is timed without the host
clock's jitter.  The window's length, over thousands of calls, is on the
host clock.  A generator of ``bench/generators/`` picks a loop and feeds
it; a new arrival process brings its own loop in its own module.
"""

from __future__ import annotations

import time

import torch


class Record:
    """What a window produced: every completed call's latency and item,
    the calls attempted and failed, the first errors, the window's
    bounds on the host clock, and the sampled (item, output) pairs."""

    def __init__(self):
        self.latency_s: list[float] = []
        self.items: list = []
        self.attempted = 0
        self.failed = 0
        self.errors: list[str] = []
        self.window_s = 0.0
        self.t0 = self.t1 = 0.0
        self.samples: list = []

    @property
    def completed_in_window(self) -> int:
        return len(self.latency_s)

    def note_error(self, exc: BaseException) -> None:
        self.failed += 1
        if len(self.errors) < 5:
            self.errors.append(f"{type(exc).__name__}: {exc}")


def closed_loop(call, items, seconds: float, dev: torch.device,
                sampler, window, label: bool = False) -> Record:
    """Call ``call(item)`` for the next item until ``seconds`` have
    passed; ``sampler.offer(item, out)`` sees every result.  ``label``
    (traced runs) wraps each call in a ``bench.call`` host range, so the
    trace tells the program's host time from the loop's."""
    rec = Record()
    on_card = dev.type == "cuda"
    if label:
        from torch.profiler import record_function
        call = _labelled(call, record_function)
    if on_card:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
    with window():
        rec.t0 = time.perf_counter()
        stop = rec.t0 + seconds
        while time.perf_counter() < stop:
            item = next(items)
            rec.attempted += 1
            t = time.perf_counter()
            try:
                if on_card:
                    start.record()
                    out = call(item)
                    end.record()
                    end.synchronize()
                else:
                    out = call(item)
            except Exception as exc:          # a failed call, not a crash
                rec.note_error(exc)
                continue
            rec.latency_s.append(start.elapsed_time(end) * 1e-3 if on_card
                                 else time.perf_counter() - t)
            rec.items.append(item)
            sampler.offer(item, out)
        rec.t1 = time.perf_counter()
    rec.window_s = rec.t1 - rec.t0
    return rec


def _labelled(call, record_function):
    def labelled(item):
        with record_function("bench.call"):
            return call(item)
    return labelled
