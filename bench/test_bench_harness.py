"""The benchmark harness on the CPU: resolution, traffic, arithmetic,
references, the closed loop on a tiny plan, and the refusals without a
card or without the program.

    python -m pytest bench -q
"""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import harness
import schedule
import stats
from devtrace import idle_share, reduce_window, short_name, split_events
from generators import closed
from reference import code as ref_code
from reference import head as ref_head

ROOT = Path(__file__).resolve().parents[1]
BENCHMARK = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCHMARK["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SEED = 2**31 + 7


# -- BENCHMARK.json -----------------------------------------------------------


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_cell_resolves_to_its_files(cell, trace):
    spec = harness.resolve(BENCHMARK, cell, trace)
    cfg = spec["config"]
    system = harness.load_module("systems", cfg["system"]).System
    for attr in ("call", "counters", "work", "kernel_bounds", "kernel_rows",
                 "release", "control", "check"):
        assert hasattr(system, attr), attr
    gen = harness.load_module("generators", spec["traffic"]["generator"])
    assert callable(gen.warm) and callable(gen.measure)
    assert spec["metrics"], f"{cell} reports no metric (trace={trace})"
    for m in spec["metrics"]:
        assert callable(harness.load_reader(m["name"]))
    names = {m["name"] for m in spec["metrics"]}
    if not trace:
        assert "setup_s" in names and len(names) >= 2
    assert set(cfg["correct"]) and all(
        isinstance(v, float) and v > 0 for v in cfg["correct"].values())


def test_names_units_and_keys_keep_the_contract():
    assert set(BENCHMARK) == {"command", "paths", "run_seconds", "configs",
                              "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCHMARK["run_seconds"] <= 51
    for c in BENCHMARK["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and all(NAME.match(k)
                                              for k in c["reduced"])
        assert c["file"].startswith("bench/") and (ROOT / c["file"]).is_file()
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["source"] == c["source"]
        # a key cut from the published configuration says what it was
        assert set(c["reduced"]) <= set(cfg["published"])
        assert all(cfg[k] != cfg["published"][k] for k in c["reduced"])
    for w in BENCHMARK["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in BENCHMARK["end_to_end"] + BENCHMARK["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in BENCHMARK["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in BENCHMARK["end_to_end"]}
    for m in BENCHMARK["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= set(CELLS)
    metrics = BENCHMARK["end_to_end"] + BENCHMARK["per_layer"]
    names = [m["name"] for m in metrics]
    assert len(names) == len(set(names))
    assert len(json.dumps(BENCHMARK)) < 64 * 1024


# -- traffic ------------------------------------------------------------------


class _Pool:
    """What a generator asks of a system."""
    n, s, pool_rows = 6, 2, 256


def _take(traffic, seed, count=2 * schedule.BLOCK):
    calls = closed.items(traffic, _Pool, seed)
    return [next(calls) for _ in range(count)]


def _key(item):
    done = item["done"]
    return (item["row"], item["width"],
            None if done is None else tuple(np.flatnonzero(~done)))


def test_closed_traffic_is_fixed_by_the_seed():
    traffic = schedule.load("decode-masked")
    a, b, c = _take(traffic, SEED), _take(traffic, SEED), \
        _take(traffic, SEED + 1)
    assert [_key(x) for x in a] == [_key(x) for x in b]
    assert [_key(x) for x in a] != [_key(x) for x in c]
    assert [x["index"] for x in a] == list(range(len(a)))
    lo, hi = traffic["rows"]
    for items in (a, c):
        # each block: every width and every pattern equally often, so
        # every seed sends the same set of sizes and masks, in its order
        for start in range(0, len(items), schedule.BLOCK):
            block = items[start:start + schedule.BLOCK]
            widths = np.bincount([x["width"] for x in block])[lo:]
            assert len(widths) == hi - lo + 1
            assert widths.max() - widths.min() <= 1
            pats = [_key(x)[2] for x in block]
            counts = {p: pats.count(p) for p in set(pats)}
            assert len(counts) == 15 and all(len(p) == 2 for p in counts)
            assert max(counts.values()) - min(counts.values()) <= 1
        assert all(0 <= x["row"] <= 256 - hi for x in items)


def test_straggler_modes():
    gen = np.random.default_rng(0)
    assert schedule.straggler_block({"stragglers": "race"}, 6, 2, 5,
                                    gen) == [None] * 5
    rand = schedule.straggler_block({"stragglers": "random"}, 20, 4, 64,
                                    gen)
    assert all((~m).sum() == 4 and m.shape == (20,) for m in rand)
    few = {"stragglers": "patterns", "pattern_count": 8}
    sets = [{tuple(np.flatnonzero(~m)) for m in schedule.straggler_block(
        few, 20, 4, 256, np.random.default_rng(seed))} for seed in (1, 2)]
    # the same 8 patterns whatever the seed
    assert sets[0] == sets[1] and len(sets[0]) == 8
    with pytest.raises(ValueError):
        schedule.straggler_block({"stragglers": "bursts"}, 6, 2, 1, gen)


def test_reservoir_is_fixed_by_the_seed():
    def fill(seed):
        r = schedule.Reservoir(8, seed)
        for i in range(1000):
            r.offer({"index": i}, i)
        return sorted(out for _, out in r.kept)
    assert fill(SEED) == fill(SEED) != fill(SEED + 1)
    assert len(fill(SEED)) == 8


# -- arithmetic ---------------------------------------------------------------


def test_percentile_is_numpy_linear():
    rng = np.random.default_rng(0)
    xs = rng.exponential(size=1001).tolist()
    for q in (50, 95, 99):
        assert stats.percentile(xs, q) == pytest.approx(np.percentile(xs, q))
    assert stats.percentile([3.0], 95) == 3.0


def test_busy_gaps_and_idle_share_on_synthetic_intervals():
    acts = [(0.0, 2.0), (1.0, 3.0), (5.0, 6.0), (9.0, 12.0)]
    assert stats.merge(acts, 0.0, 10.0) == [(0.0, 3.0), (5.0, 6.0),
                                            (9.0, 10.0)]
    assert stats.busy(acts, 0.0, 10.0) == 5.0
    assert stats.gaps(stats.merge(acts, 0, 10), 0.0, 10.0) == [(3.0, 5.0),
                                                            (6.0, 9.0)]
    device = [(1.0, 2.0, "void ns::k<float>(int)"), (1.5, 3.0, "k2"),
              (6.0, 8.0, "Memcpy HtoD")]
    host = [(2.5, 6.5, "outer"), (3.5, 4.5, "aten::copy_"),
            (8.5, 11.0, "cudaDeviceSynchronize")]
    red = reduce_window(device, host, 0.0, 10.0)
    assert red["busy_s"] == pytest.approx(4.0)
    assert idle_share(red) == pytest.approx(60.0)
    gaps = dict(red["gaps"])
    # gaps (0,1), (3,6), (8,10): midpoints 0.5 (nothing), 4.5 (the copy
    # inside 'outer'), 9 (the synchronise)
    assert gaps == {"host: untraced": 1.0, "aten::copy_": 3.0,
                    "cudaDeviceSynchronize": 2.0}
    assert dict(red["ops"])["k"] == pytest.approx(1.0)
    long = "void (anonymous namespace)::bcsr_narrow_kernel<float, 8>(x)"
    assert short_name(long) == "bcsr_narrow_kernel"


class _Event:
    """A profiler event as ``split_events`` reads it."""

    def __init__(self, name, device, start_s, dur_s, annotation=False):
        from torch.autograd import DeviceType
        self._name, self._annotation = name, annotation
        self._type = DeviceType.CUDA if device else DeviceType.CPU
        self._start, self._dur = int(start_s * 1e9), int(dur_s * 1e9)

    def name(self):
        return self._name

    def device_type(self):
        return self._type

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._dur

    def is_user_annotation(self):
        return self._annotation


def test_range_shadows_on_the_device_are_no_work():
    events = [_Event("bench.window", False, 1.0, 10.0, True),
              _Event("bench.window", True, 1.0, 10.0, True),
              _Event("bench.call", False, 2.0, 3.0, True),
              _Event("bench.call", True, 2.0, 3.0, True),
              _Event("some_range", True, 2.0, 3.0, True),
              _Event("bcsr_wide_kernel", True, 2.5, 1.0),
              _Event("aten::add_", False, 2.1, 0.1)]
    device, host, lo, hi = split_events(events)
    assert (lo, hi) == (1.0, 11.0)
    assert [a[2] for a in device] == ["bcsr_wide_kernel"]
    assert sorted(a[2] for a in host) == ["aten::add_", "bench.call"]
    red = reduce_window(device, host, lo, hi)
    assert red["busy_s"] == pytest.approx(1.0)
    assert idle_share(red) == pytest.approx(90.0)


def test_spread_is_quartile_distance_over_median():
    assert stats.spread([1.0, 2.0, 3.0, 4.0, 5.0]) == pytest.approx(3.0 / 3.0)
    line = json.dumps({"workload": "w", "metrics": {"m": {"value": 2.0}}})
    got = stats.summarise([line, "noise", line])["w"]
    assert dict(got) == {"m": [2.0, 2.0]}


def test_work_and_its_readers_on_a_hand_counted_head(tiny):
    cfg = json.loads((tiny / BENCHMARK["configs"][0]["file"]).read_text())
    system = harness.load_module("systems", cfg["system"]).System(
        cfg, SEED, torch.device("cpu"))
    d, vocab = cfg["hidden_size"], cfg["vocab_size"]
    got = system.work({"width": 3})
    assert got["flops"] == 2 * d * vocab * 3
    nbytes = d * vocab * 4 + 3 * d * 4 + 3 * vocab * 4   # the tiny head: f32
    assert got["bytes"] == nbytes
    assert got["least_s"] == pytest.approx(max(nbytes / 3.35e12,
                                               2 * d * vocab * 3 / 67e12))

    class Rec:
        completed_in_window = 1000

    work = harness.total_work(system, [{"width": 3}] * 1000)
    assert work["flops"] == pytest.approx(1000 * got["flops"])
    run = harness.Run(work=work, record=Rec(),
                      trace={"busy_s": 2.0, "window_s": 4.0})
    mfu = harness.load_reader("mfu")(run)
    assert mfu == pytest.approx(100 * work["flops"] / (4.0 * 989e12))
    roof = harness.load_reader("coded_head_roofline")(run)
    assert roof == pytest.approx(100 * 1000 * got["least_s"] / 2.0)
    for name in ("mfu", "coded_head_roofline", "device.idle_share"):
        assert harness.load_reader(name)(harness.Run(
            work=work, record=Rec(), trace=None)) is None


# -- references ---------------------------------------------------------------


def test_reference_matches_numpy_float64():
    rng = np.random.default_rng(1)
    head = torch.from_numpy(rng.standard_normal((64, 50)).astype(
        np.float32)).to(torch.bfloat16)
    x = rng.standard_normal((3, 64)).astype(np.float32)
    want = x.astype(np.float64) @ head.double().numpy()
    got = ref_head.Logits(head)(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)
    same = torch.from_numpy(want)
    assert ref_head.rel_err(same, same) == 0
    assert ref_head.rel_err(same * (1 + 1e-3), same) == pytest.approx(1e-3)


def test_fp8_control_keeps_three_mantissa_bits():
    x = torch.tensor([448.0, 1.0 + 2.0 ** -3, 1.0 + 2.0 ** -5])
    got = ref_head.to_fp8(x)
    assert got.tolist() == [448.0, 1.0 + 2.0 ** -3, 1.0]


@pytest.mark.parametrize("n,k", [(6, 4), (5, 4), (8, 5), (20, 16), (4, 4)])
def test_the_benchmarks_code_is_the_papers_code_the_program_builds(n, k):
    """``reference/code.py`` builds Alg. 1 from its description; it has to
    be the code the program compiles, coefficient for coefficient."""
    from repro_torch.api.schemes import make_scheme
    from repro_torch.core.decoding import system_matrix
    want = system_matrix(make_scheme("proposed", n=n, k_A=k), 0)
    np.testing.assert_array_equal(ref_code.system_matrix(n, k, 0), want)


def test_amplification_on_hand_cases():
    eye = np.eye(3)
    assert ref_code.amplification(eye, [True, True, True]) == 1.0
    # rows 0 and 2 of [[1, 0], [1, 1], [1, -1]]: inverse [[1, 0], [1, -1]],
    # |inv| |G| = [[1, 0], [2, 1]]: the largest row sum is 3
    g = np.array([[1.0, 0.0], [1.0, 1.0], [1.0, -1.0]])
    assert ref_code.amplification(g, [True, False, True]) == \
        pytest.approx(3.0)
    assert list(ref_code.decode_rows([False, True, True, True], 2)) == [1, 2]
    assert ref_code.weight(6, 4) == 2


# -- the closed loop on a tiny CPU plan ---------------------------------------


def tiny_root(tmp: Path) -> Path:
    """BENCHMARK.json's cells at a size the CPU holds, in a checkout-like
    tree: the same systems, mixes and readers, small widths.  The tiny
    head is f32, so a sound run reads far inside the limits set for bf16
    at the cells' own size; the control and the faults read above them."""
    (tmp / "bench" / "configs").mkdir(parents=True)
    (tmp / "bench" / "traffic").mkdir(parents=True)
    for c in BENCHMARK["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        cfg.update(hidden_size=64, vocab_size=512, hidden_pool=16,
                   torch_dtype="float32")
        (tmp / c["file"]).write_text(json.dumps(cfg))
    for w in BENCHMARK["workloads"]:
        traffic = schedule.load(w["traffic"])
        traffic.update(warm_calls=8, check_calls=512)
        (tmp / "bench" / "traffic" / f"{w['traffic']}.json").write_text(
            json.dumps(traffic))
    return tmp


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("tiny"))


@pytest.mark.parametrize("cell", CELLS)
def test_loop_completes_one_second_on_a_tiny_cpu_plan(tiny, cell):
    res = harness.run_cell(cell, SEED, 1.0, False, root=tiny, device="cpu",
                           bench=BENCHMARK)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    e2e = {m["name"] for m in BENCHMARK["end_to_end"]}
    assert set(res["metrics"]) == e2e
    assert res["metrics"]["calls_per_s"]["value"] > 0
    got = {k: m["value"] for k, m in res["metrics"].items()}
    assert got["p95_ms"] >= got["p50_ms"]
    assert res["checks"]["checked_calls"]["value"] == 512
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_on_the_cpu_reads_the_program_counters(tiny, cell):
    res = harness.run_cell(cell, SEED, 0.5, True, root=tiny, device="cpu",
                           bench=BENCHMARK)
    assert res["correct"], res["checks"]
    # every pattern was warmed up, so every call of the window hits
    assert res["metrics"]["decode_cache.hit_rate"]["value"] == 100.0
    # the device's readers find no trace on the CPU and stay silent
    assert set(res["metrics"]) == {"decode_cache.hit_rate"}


def _run(cwd: Path, cell: str):
    return subprocess.run(
        [sys.executable, str(cwd / "bench" / "run.py"), "--workload", cell,
         "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=cwd)


def test_run_exits_nonzero_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    proc = _run(ROOT, CELLS[0])
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "no CUDA device" in proc.stderr


def test_run_exits_nonzero_without_the_program(tmp_path):
    """A directory that holds only BENCHMARK.json and the files under
    ``paths`` gives no result."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    for path in BENCHMARK["paths"]:
        shutil.copytree(ROOT / path, tmp_path / path,
                        ignore=shutil.ignore_patterns("__pycache__"))
    proc = _run(tmp_path, CELLS[0])
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "no program" in proc.stderr
