"""The reader of ``device.idle_share.program`` on synthetic reduced
traces: the share of the window in gaps named by the program's ranges,
nothing where there is no trace or no such name, and a prefix for every
range the program opens.

    python -m pytest bench -q
"""

from __future__ import annotations

import pytest

import harness
import test_bench_harness
from devtrace import reduce_window
from repro_torch.obs.trace import PROGRAM_SPANS

NAME = "device.idle_share.program"
read = harness.load_reader(NAME)
PREFIXES = harness.load_module("metrics", NAME).PREFIXES


class _Run:
    def __init__(self, trace):
        self.trace = trace


def test_share_of_the_window_in_gaps_the_program_names():
    # device busy (1, 2) and (6, 7) of [0, 10]; gaps (0, 1), (2, 6),
    # (7, 10), named by the shortest host op over their midpoints
    device = [(1.0, 2.0, "bcsr_narrow_kernel"), (6.0, 7.0, "decode_k")]
    host = [(0.0, 10.0, "bench.call"), (3.0, 5.0, "plan.matvec"),
            (3.5, 4.5, "kernel.bcsr_matmul"), (8.0, 9.0, "aten::empty")]
    red = reduce_window(device, host, 0.0, 10.0)
    assert dict(red["gaps"]) == {"bench.call": 1.0,
                                 "kernel.bcsr_matmul": 4.0,
                                 "aten::empty": 3.0}
    assert read(_Run(red)) == pytest.approx(40.0)
    host[1] = (3.0, 5.0, "decode_cache.plan")
    host[2] = (0.2, 0.8, "plan.matvec")
    red = reduce_window(device, host, 0.0, 10.0)
    assert read(_Run(red)) == pytest.approx(50.0)


def test_nothing_without_a_trace_or_a_program_range():
    assert read(_Run(None)) is None
    red = reduce_window([(1.0, 2.0, "k")], [(0.0, 10.0, "bench.call")],
                        0.0, 10.0)
    assert read(_Run(red)) is None
    assert read(_Run(dict(red, window_s=0.0))) is None


@pytest.mark.parametrize("span", PROGRAM_SPANS)
def test_every_program_range_has_a_reader_prefix(span):
    assert span.startswith(PREFIXES)


def test_the_entry_keeps_the_contract():
    test_bench_harness.test_names_units_and_keys_keep_the_contract()
    entry = next(m for m in test_bench_harness.BENCHMARK["per_layer"]
                 if m["name"] == NAME)
    assert entry == {
        "name": NAME, "unit": "%", "better": "lower",
        "source": "program_span",
        "layer": "plan API, executor; kernels (host side)",
        "moves": "calls_per_s",
        "workloads": ["kimi-k2-instruct-head.decode-masked"]}
