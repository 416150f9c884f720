"""The port's observability (``repro_torch.obs``: trace, attrib, export,
and the tracer spans of ``compile_plan``) against the JAX package's:
the plan spans, traced rounds whose segments telescope to the round
wall on every transport, attribution equal in both packages on one
event list and naming a slowed worker, Chrome-trace and Prometheus
exports, ``python -m repro_torch.obs`` on the CPU, and the fleet's
re-encode cut following ``observed_rates()``.

Host workers throughout (``device="cpu"``); ``chip_smoke.py`` traces
card workers."""

import dataclasses
import json
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.obs.trace as ref_trace_mod
import repro_torch.obs.trace as trace_mod
from repro.api import compile_plan as ref_compile
from repro.obs import attribute as ref_attribute
from repro.obs import chrome_trace as ref_chrome_trace
from repro_torch.api import compile_plan
from repro_torch.cluster.faults import adversarial_faults
from repro_torch.cluster.fleet import CodedFleet
from repro_torch.obs import (
    Tracer,
    attribute,
    chrome_trace,
    prometheus_text,
    write_chrome_trace,
)
from repro_torch.obs.__main__ import main as obs_main

LOOSE = dict(rtol=5e-3, atol=5e-3)
SEGMENTS = {"coord_queue", "wire_out", "worker_queue", "compute",
            "wire_back", "decode_wait", "decode"}


def block_sparse(rng, t, r, zeros, bs=8):
    mask = rng.random((t // bs, r // bs)) >= zeros
    a = rng.standard_normal((t, r)).astype(np.float32)
    return a * np.kron(mask, np.ones((bs, bs), np.float32))


def wait_until(pred, timeout=10.0):
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < timeout:
        if pred():
            return True
        time.sleep(0.02)
    return pred()


@pytest.fixture(scope="module")
def operand():
    rng = np.random.default_rng(5)
    A = block_sparse(rng, 128, 96, 0.9)
    xs = [rng.standard_normal((4, 128)).astype(np.float32)
          for _ in range(6)]
    return A, xs


def port_plan(A, backend="packed", **kw):
    kw = kw or {"n": 6, "s": 2}
    return compile_plan(torch.from_numpy(A), scheme="proposed",
                        backend=backend, device="cpu", **kw)


# ---------------------------------------------------------------------------
# the plan spans (compile and retune)
# ---------------------------------------------------------------------------


def plan_events(package_compile, to_array, backend, monkeypatch, mod):
    """Compile one mv and one mm plan and retune the mv plan to a new
    operand under a fresh process-global tracer; its events, stripped of
    their times."""
    monkeypatch.setattr(mod, "_GLOBAL", None)
    rng = np.random.default_rng(3)
    A = block_sparse(rng, 128, 96, 0.8)
    A2 = block_sparse(rng, 128, 96, 0.8)
    kw = {} if to_array is jnp.asarray else {"device": "cpu"}
    plan = package_compile(to_array(A), scheme="proposed", n=6, s=2,
                           backend=backend, **kw)
    package_compile(to_array(A), scheme="proposed", n=6, k_A=2, k_B=2,
                    backend=backend, **kw)
    package_compile(scheme="proposed", n=6, s=2, **kw)    # aggregation
    plan.retune(to_array(A2))
    events = mod.default_tracer().events()
    assert all(e["dur"] >= 0 for e in events)
    return [{k: e[k] for k in ("name", "cat", "ph", "track", "args")}
            for e in events]


@pytest.mark.parametrize("backend", ["packed", "cuda"])
def test_compile_and_retune_record_the_reference_spans(backend,
                                                       monkeypatch):
    """With ``REPRO_TRACE`` set, ``compile_plan`` records one
    ``plan.compile`` complete event and every operand attach (retune
    included) one ``plan.encode`` span, with the JAX package's names,
    categories, tracks and args; the port's ``cuda`` backend differs
    from the reference's ``packed`` by the backend name alone."""
    monkeypatch.setenv("REPRO_TRACE", "1")
    ref = plan_events(ref_compile, jnp.asarray, "packed", monkeypatch,
                      ref_trace_mod)
    ours = plan_events(compile_plan, torch.from_numpy, backend,
                       monkeypatch, trace_mod)
    assert [e["name"] for e in ref] == [
        "plan.encode", "plan.compile", "plan.encode", "plan.compile",
        "plan.compile", "plan.encode"]
    for e in ours:
        if e["args"].get("backend") == backend:
            e["args"]["backend"] = "packed"
    # the aggregation-only plan picks its backend without an operand
    agg = [e for e in ours if e["name"] == "plan.compile"
           and not e["args"]["has_operand"]]
    assert len(agg) == 1
    agg[0]["args"]["backend"] = next(
        e["args"]["backend"] for e in ref if e["name"] == "plan.compile"
        and not e["args"]["has_operand"])
    assert ours == ref


def test_untraced_compile_records_nothing(monkeypatch):
    monkeypatch.delenv("REPRO_TRACE", raising=False)
    monkeypatch.setattr(trace_mod, "_GLOBAL", None)
    plan = port_plan(np.ones((16, 12), np.float32))
    plan.retune(torch.ones(16, 12))
    assert trace_mod._GLOBAL is None


# ---------------------------------------------------------------------------
# traced rounds and attribution
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("transport", ["memory", "pipe", "tcp"])
def test_segments_sum_to_round_wall(operand, transport):
    """Each traced round's critical-chain segments telescope to its
    wall (within the reference's 10% or 2 ms, on the typical round: the
    clock offset of a child is one hello's latency), and every span of
    a round shares its trace id."""
    A, xs = operand
    tr = Tracer(capacity=4096)
    with CodedFleet(6, transport=transport, tracer=tr,
                    device="cpu") as fleet:
        h = fleet.attach(port_plan(A))
        h.matvec(xs[0])                             # warm
        for x in xs:
            h.matvec(x)
    rounds = [e for e in tr.events() if e["cat"] == "round"]
    assert len(rounds) >= len(xs)
    devs = []
    for e in rounds[1:]:
        segs = e["args"]["segments"]
        assert set(segs) == SEGMENTS
        wall = e["dur"]
        devs.append(abs(sum(segs.values()) - wall) - max(0.10 * wall, 2e-3))
    assert float(np.median(devs)) <= 0.0, devs
    for e in rounds:
        kin = {v["name"] for v in tr.events() if v["trace"] == e["trace"]}
        assert kin >= {"fleet.launch", "compute", "decode", "round"}


@pytest.fixture(scope="module")
def slowed_events(operand):
    """A traced memory fleet with worker 3 slowed 60x: its events, and
    the capacities the fleet derives from their rates."""
    A, xs = operand
    tr = Tracer()
    faults = adversarial_faults([3], slowdown=60.0, time_scale=2e-3)
    with CodedFleet(6, faults=faults, tracer=tr, device="cpu") as fleet:
        h = fleet.attach(port_plan(A))
        for x in xs * 2:
            h.matvec(x)
            # healthy workers drain their inboxes between rounds
            time.sleep(0.01)
        events = tr.events()
        rates = attribute(events).compute_rates()
        assert fleet.observed_rates() == rates
        caps = dict(zip(sorted(rates), fleet.worker_capacities(
            sorted(rates), rates=rates)))
    return events, caps


def test_attribution_names_the_slowed_worker(slowed_events):
    events, caps = slowed_events
    rep = attribute(events)
    assert len(rep.rounds) == 12
    assert rep.suspects()[0] == 3
    s = rep.workers[3]
    assert s.decoded_without + s.wasted_tasks > 0
    if 3 in caps:
        assert caps[3] == min(caps.values())
    assert sum(w.decoded_without + w.wasted_tasks
               for w in rep.workers.values()) >= len(rep.rounds)


def test_attribution_equals_the_reference_on_one_event_list(slowed_events):
    """The JAX package's ``attribute`` over the port's event list gives
    the same report, field for field."""
    events, _ = slowed_events
    ours, ref = attribute(events), ref_attribute(events)
    assert [dataclasses.asdict(r) for r in ours.rounds] == \
        [dataclasses.asdict(r) for r in ref.rounds]
    assert {w: dataclasses.asdict(s) for w, s in ours.workers.items()} == \
        {w: dataclasses.asdict(s) for w, s in ref.workers.items()}
    assert ours.suspects() == ref.suspects()
    assert ours.compute_rates() == ref.compute_rates()
    assert ours.phase_totals() == ref.phase_totals()
    assert ours.wasted_work() == ref.wasted_work()
    assert ours.table() == ref.table()
    assert chrome_trace(events, process_name="p") == \
        ref_chrome_trace(events, process_name="p")
    empty = attribute([])
    assert (empty.rounds, empty.workers, empty.suspects(),
            empty.compute_rates()) == ([], {}, [], {})


# ---------------------------------------------------------------------------
# export and the demo
# ---------------------------------------------------------------------------


def test_chrome_trace_and_prometheus_text(operand, tmp_path):
    A, xs = operand
    tr = Tracer()
    with CodedFleet(6, tracer=tr, device="cpu") as fleet:
        h = fleet.attach(port_plan(A))
        h.matvec(xs[0])
        fleet._log_event("probe")           # the log-merge path
        path = tmp_path / "trace.json"
        n = write_chrome_trace(str(path), tr, fleet=fleet)
        text = prometheus_text(fleet=fleet, tracer=tr)
    doc = json.loads(path.read_text())
    assert len(doc["traceEvents"]) == n > 0
    assert {e["ph"] for e in doc["traceEvents"]} <= {"M", "X", "i"}
    for e in doc["traceEvents"]:
        assert "ts" in e or e["ph"] == "M"
        if e["ph"] == "X":
            assert e["dur"] >= 0.0
    names = {e["args"]["name"] for e in doc["traceEvents"]
             if e["ph"] == "M" and e["name"] == "thread_name"}
    assert {"fleet", "fleet-log"} <= names
    assert json.loads(json.dumps(chrome_trace([])))["traceEvents"]
    assert "repro_fleet_n_live 6" in text
    assert "repro_trace_buffer_capacity" in text
    for line in text.strip().splitlines():
        float(line.rsplit(" ", 1)[1])


def test_obs_demo_runs_on_the_cpu(tmp_path, capsys):
    out = tmp_path / "demo.json"
    assert obs_main(["--device", "cpu", "--rounds", "3",
                     "--out", str(out)]) == 0
    text = capsys.readouterr().out
    assert "3 traced rounds on 'memory' transport, workers on cpu" in text
    assert "# prometheus" in text and "repro_fleet_n_live 8" in text
    assert json.loads(out.read_text())["traceEvents"]


# ---------------------------------------------------------------------------
# the re-encode cut follows the traced rates
# ---------------------------------------------------------------------------


def round_record(compute_s: dict) -> dict:
    """One traced round as the fleet records it, with the given pure
    compute seconds per worker (one work unit each)."""
    tasks = [{"worker": w, "row": w, "used": True, "work": 1.0,
              "start": 0.0, "finish": dt} for w, dt in compute_s.items()]
    return {"name": "round", "cat": "round", "ph": "X", "track": "fleet",
            "t": 0.0, "dur": max(compute_s.values()), "trace": 1,
            "args": {"plan": 1, "round": 1, "op": "matvec",
                     "segments": {}, "tasks": tasks}}


def test_reencode_cut_follows_observed_rates(operand):
    """A traced fleet's worker loss re-encodes for the survivors with
    ``proposed-hetero`` over ``worker_capacities(rates=observed_rates())``
    -- here rates recorded by the tracer alone (no heartbeat EWMAs),
    so the slow worker owns the fewest rows of the new encoding.
    Untraced, ``observed_rates()`` is None."""
    A, xs = operand
    with CodedFleet(3, device="cpu") as fleet:
        assert fleet.observed_rates() is None
    tr = Tracer()
    plan = port_plan(A, n=12, s=4)
    with CodedFleet(6, tracer=tr, device="cpu") as fleet:
        h = fleet.attach(plan)
        assert fleet.observed_rates() is None       # nothing recorded yet
        assert not fleet._rate
        tr._buf.append(round_record({0: 4.0, 1: 1.0, 2: 1.0, 3: 1.0,
                                     4: 1.0, 5: 1.0}))
        rates = fleet.observed_rates()
        assert rates == {0: 0.25, 1: 1.0, 2: 1.0, 3: 1.0, 4: 1.0, 5: 1.0}
        caps = fleet.worker_capacities([0, 1, 2, 3, 4], rates=rates)
        assert caps == [1, 4, 4, 4, 4]
        assert fleet.worker_capacities([0, 1, 2, 3, 4]) == [1] * 5
        pid0 = h.plan_id
        fleet.remove_worker(5, drain=True)
        assert wait_until(lambda: h.plan_id != pid0)
        assert h.plan.scheme.name == "proposed-hetero"
        virt = [max(1, round(c * 10 / sum(caps))) for c in caps]
        assert h.plan.n == sum(virt)
        owned = {w: 0 for w in fleet.live_workers()}
        for o in h._ps.owner.values():
            owned[o] += 1
        assert owned == dict(zip(range(5), virt))
        np.testing.assert_allclose(h.matvec(xs[1]).numpy(), xs[1] @ A,
                                   **LOOSE)
    assert wait_until(lambda: not [t for t in threading.enumerate()
                                   if t.name.startswith("coded-fleet")])
