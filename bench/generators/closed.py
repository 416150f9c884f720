"""A closed loop: one caller calls the system back to back, each call
waiting for its result, as an engine's decode step waits for its logits.

The mix's data file (``bench/traffic/<mix>.json``, ``"generator":
"closed"``) sets the calls' shapes and stragglers by the parameters of
``schedule.py``, and ``warm_calls``: calls from the warm-up's own
streams of the seed after every width and every mask has run once.
"""

from __future__ import annotations

import schedule
from loops import closed_loop


def items(traffic: dict, system, seed: int, base: int = 0):
    """The calls, one after another, without end; each block of
    ``schedule.BLOCK`` calls is balanced on its own."""
    gen = schedule.rng(seed, base + schedule.STREAM_CALLS)
    i = 0
    while True:
        count = schedule.BLOCK
        widths, rows = schedule.row_block(traffic, system.pool_rows, count,
                                          gen)
        masks = schedule.straggler_block(traffic, system.n, system.s,
                                         count, gen)
        for j in range(count):
            yield {"index": i, "row": int(rows[j]), "width": int(widths[j]),
                   "done": masks[j]}
            i += 1


def warm(system, traffic: dict, seed: int) -> None:
    """Every width with every mask the mix sends, once each, then
    ``warm_calls`` calls of the mix: every shape, kernel and decode the
    window will use is built before it opens."""
    lo, hi = traffic["rows"]
    masks = [None]
    if traffic["stragglers"] == "patterns":
        masks = schedule.patterns(system.n, system.s,
                                  traffic.get("pattern_count"))
    for width in range(lo, hi + 1):
        for done in masks:
            system.call({"index": -1, "row": 0, "width": width,
                         "done": done})
    # the window holds up to check_calls outputs for the comparison: hold
    # as many of the widest now, so that the allocator has their memory
    # cached and the window allocates none from the device
    held = [system.call({"index": -1, "row": 0, "width": hi,
                         "done": masks[i % len(masks)]})
            for i in range(traffic["check_calls"])]
    del held
    calls = items(traffic, system, seed, base=schedule.WARM_BASE)
    for _ in range(traffic["warm_calls"]):
        system.call(next(calls))


def measure(system, traffic: dict, seconds: float, seed: int, dev, window,
            label: bool):
    """The window: the Record of ``loops.closed_loop``, its samples kept
    by a reservoir of ``check_calls`` drawn from the seed."""
    sampler = schedule.Reservoir(traffic["check_calls"], seed)
    rec = closed_loop(system.call, items(traffic, system, seed), seconds,
                      dev, sampler, window, label=label)
    rec.samples = sampler.kept
    return rec
