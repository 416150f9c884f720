"""The comparison that decides ``correct`` fails what it must.

- The control, the plain reference one precision step below the
  configuration's (fp8 for the bf16 head), put in the program's place in
  the timed path, comes out not correct through the harness's own run
  and comparison: on the CPU at a size a test run holds, and on the card
  (marker ``cuda``) at the cell's own size on three seeds.
- A run with the timed path broken underneath comes out not correct:
  an answer altered where it is produced (the decode's output); a wrong
  answer whenever one worker straggles (a third of the calls); one call
  in 64 wrong; half of each call's rows left out.  The look for a card
  is skipped; the rest of the run is the harness's own.
"""

from __future__ import annotations

import sys

import pytest
import torch

import harness
from test_bench_harness import BENCHMARK, CELLS, SEED, tiny_root

CONFIG = {w["name"]: w["config"] for w in BENCHMARK["workloads"]}


def system_class(cell: str, root=None):
    import json
    from pathlib import Path
    entry = next(c for c in BENCHMARK["configs"] if c["name"] == CONFIG[cell])
    cfg = json.loads((Path(root or harness.ROOT) / entry["file"]).read_text())
    return harness.load_module("systems", cfg["system"]).System


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("tiny"))


def run_tiny(tiny, cell, seed=SEED):
    return harness.run_cell(cell, seed, 0.5, False, root=tiny, device="cpu",
                            bench=BENCHMARK)


def over(res) -> list[str]:
    """The compared numbers of a run that read above their limits."""
    return [name for name, c in res["checks"].items()
            if "limit" in c and c["value"] > c["limit"]]


def in_place_of_the_program(monkeypatch, cell, answer, root=None,
                            program=True):
    """The system's timed call answers with ``answer(system, item, out)``
    instead of the program's ``out`` (None where ``program`` is False:
    the program is not called)."""
    System = system_class(cell, root)
    call = System.call

    def broken(self, item):
        return answer(self, item, call(self, item) if program else None)
    monkeypatch.setattr(System, "call", broken)


# -- the control --------------------------------------------------------------


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", [SEED, SEED + 1, SEED + 2])
def test_control_in_the_programs_place_is_not_correct(tiny, cell, seed,
                                                      monkeypatch):
    in_place_of_the_program(monkeypatch, cell,
                            lambda system, item, out: system.control(item),
                            tiny, program=False)
    res = run_tiny(tiny, cell, seed)
    assert not res["correct"]
    assert "head_rel_err_median" in over(res)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", [SEED, SEED + 1, SEED + 2])
def test_control_is_not_correct_at_the_cells_size_on_the_card(card, cell,
                                                              seed,
                                                              monkeypatch):
    harness.set_environment()
    in_place_of_the_program(monkeypatch, cell,
                            lambda system, item, out: system.control(item),
                            program=False)
    res = harness.run_cell(cell, seed, 2.0, False)
    print(res["checks"], file=sys.stderr)
    assert not res["correct"]
    assert over(res)


# -- faults in the timed path -------------------------------------------------


def altered(fn):
    """``fn`` with its result's first element moved by its largest value:
    an answer altered where it is produced."""
    def wrapper(*args, **kw):
        out = fn(*args, **kw).clone()
        flat = out.view(-1)
        flat[0] += flat.abs().max() + 1.0
        return out
    return wrapper


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(tiny, cell):
    res = run_tiny(tiny, cell)
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_answer_altered_in_the_decode_is_not_correct(tiny, cell,
                                                     monkeypatch):
    import repro_torch.runtime.executor as ex
    # the package re-exports the function under its module's name
    dm = sys.modules["repro_torch.kernels.decode_matmul"]
    monkeypatch.setattr(dm, "decode_matmul", altered(dm.decode_matmul))
    monkeypatch.setattr(ex, "decode_matmul", altered(ex.decode_matmul))
    res = run_tiny(tiny, cell)
    assert not res["correct"]
    assert over(res)


def _wrong(out):
    return altered(lambda: out)()


@pytest.mark.parametrize("cell", CELLS)
def test_wrong_whenever_one_worker_straggles_is_not_correct(tiny, cell,
                                                            monkeypatch):
    in_place_of_the_program(
        monkeypatch, cell, lambda system, item, out:
        _wrong(out) if not item["done"][0] else out, tiny)
    res = run_tiny(tiny, cell)
    assert not res["correct"]
    assert "head_err_per_amplification_max" in over(res)


@pytest.mark.parametrize("cell", CELLS)
def test_one_call_in_64_wrong_is_not_correct(tiny, cell, monkeypatch):
    in_place_of_the_program(
        monkeypatch, cell, lambda system, item, out:
        _wrong(out) if item["index"] % 64 == 7 else out, tiny)
    res = run_tiny(tiny, cell)
    assert not res["correct"]
    assert over(res) == ["head_err_per_amplification_max"]


@pytest.mark.parametrize("cell", CELLS)
def test_half_the_rows_left_out_is_not_correct(tiny, cell, monkeypatch):
    def first_half(system, item, out):
        half = (out.shape[0] + 1) // 2
        return torch.cat([out[:half], out[:out.shape[0] - half]])
    in_place_of_the_program(monkeypatch, cell, first_half, tiny)
    res = run_tiny(tiny, cell)
    assert not res["correct"]
    assert over(res)
