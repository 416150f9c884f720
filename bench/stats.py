"""Arithmetic the benchmark reports with: percentiles, merged busy time,
idle gaps, and the spread of repeated runs.

``python bench/stats.py RESULT_FILE...`` reads result lines (the JSON
last lines of ``bench/run.py``, one per line, any other lines skipped)
and prints, per workload and metric, the median and the spread: the
distance between the first and third quartiles as
``statistics.quantiles(values, n=4)`` gives them, as a share of the
median.  That is the spread a bound is set from.
"""

from __future__ import annotations

import heapq
import json
import statistics
import sys
from collections import defaultdict


def percentile(values, q: float) -> float:
    """The ``q``-th percentile (0-100) of all ``values``, linear between
    order statistics (numpy's default), over every sample."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def merge(intervals, lo: float | None = None, hi: float | None = None):
    """Union of (start, end) intervals, clipped to [lo, hi], in order."""
    out: list[list[float]] = []
    for start, end in sorted(intervals):
        if lo is not None:
            start = max(start, lo)
        if hi is not None:
            end = min(end, hi)
        if end <= start:
            continue
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return [(a, b) for a, b in out]


def busy(intervals, lo: float | None = None, hi: float | None = None
         ) -> float:
    """Time covered by at least one interval, inside [lo, hi]."""
    return sum(b - a for a, b in merge(intervals, lo, hi))


def gaps(merged, lo: float, hi: float):
    """The idle stretches of [lo, hi] between ``merged`` busy intervals."""
    out, at = [], lo
    for a, b in merged:
        if a > at:
            out.append((at, a))
        at = max(at, b)
    if hi > at:
        out.append((at, hi))
    return out


def name_gaps(gap_list, host_ops):
    """Name each idle gap by what the host was doing at its midpoint: the
    shortest host op (start, end, name) that covers it, or ``"host:
    untraced"`` where no traced op does.  One sweep over both lists."""
    ops = sorted(host_ops)
    mids = sorted(((a + b) / 2, i) for i, (a, b) in enumerate(gap_list))
    names = [None] * len(gap_list)
    heap: list = []
    j = 0
    for mid, i in mids:
        while j < len(ops) and ops[j][0] <= mid:
            start, end, name = ops[j]
            heapq.heappush(heap, (end - start, end, name))
            j += 1
        while heap and heap[0][1] < mid:
            heapq.heappop(heap)
        names[i] = heap[0][2] if heap else "host: untraced"
    return names


def spread(values) -> float:
    """Interquartile distance as a share of the median."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med if med else float("inf")


def summarise(lines) -> dict:
    """{workload: {metric: [values]}} from result lines."""
    runs: dict = defaultdict(lambda: defaultdict(list))
    for line in lines:
        line = line.strip()
        if not line.startswith("{"):
            continue
        try:
            res = json.loads(line)
        except json.JSONDecodeError:
            continue
        cell = res.get("workload")
        if cell is None or "metrics" not in res:
            continue
        for name, m in res["metrics"].items():
            runs[cell][name].append(m["value"])
    return runs


def main(paths) -> None:
    lines = []
    for p in paths:
        with open(p) as f:
            lines.extend(f)
    for cell, metrics in sorted(summarise(lines).items()):
        for name, vals in sorted(metrics.items()):
            row = {"workload": cell, "metric": name, "runs": len(vals),
                   "median": statistics.median(vals),
                   "spread": spread(vals) if len(vals) >= 2 else None,
                   "values": vals}
            print(json.dumps(row))


if __name__ == "__main__":
    main(sys.argv[1:])
