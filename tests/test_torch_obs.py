"""The port's observability (``repro_torch.obs``: trace, attrib, export,
and the tracer spans of ``compile_plan``) against the JAX package's:
the plan spans, traced rounds whose segments telescope to the round
wall on every transport, attribution equal in both packages on one
event list and naming a slowed worker, Chrome-trace and Prometheus
exports, ``python -m repro_torch.obs`` on the CPU, and the fleet's
re-encode cut following ``observed_rates()``.  The port's own: the
per-call ranges (``obs.trace.scope``) under a CPU ``torch.profiler``,
kept out of the ring buffer, and the export on the profiler's clock.

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
# the program's ranges on the profiler's clock
# ---------------------------------------------------------------------------


def profiled(fn):
    """Run ``fn`` under a CPU ``torch.profiler``; its host events as
    (name, start ns, end ns, user annotation) and ``fn``'s result."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    events = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(),
               e.is_user_annotation())
              for e in prof.profiler.kineto_results.events()]
    return events, out


def program_ranges(events):
    return [e for e in events if e[0] in trace_mod.PROGRAM_SPANS]


def inside(child, parent) -> bool:
    return parent[1] <= child[1] and child[2] <= parent[2]


MASK = np.array([1, 1, 0, 1, 0, 1], bool)


def cuda_calls(operand):
    """One call of each per-call operation of ``cuda``-backend plans on
    CPU tensors (the kernels' plain versions), by operation name."""
    A, xs = operand
    mv = port_plan(A, backend="cuda")
    mm = port_plan(A, backend="cuda", n=6, k_A=2, k_B=2)
    B = torch.from_numpy(xs[0].T.copy())
    payloads = [torch.full((3,), float(i)) for i in range(6)]
    return {"matvec": lambda: mv.matvec(torch.from_numpy(xs[0]), MASK),
            "matmat": lambda: mm.matmat(B, MASK),
            "aggregate": lambda: mv.aggregate(payloads, MASK)}


@pytest.mark.parametrize("op, children", [
    ("matvec", {"decode_cache.plan", "kernel.bcsr_matmul",
                "kernel.decode_matmul"}),
    ("matmat", {"kernel.cyclic_encode", "decode_cache.plan",
                "kernel.bcsr_matmul", "kernel.decode_matmul"}),
    ("aggregate", {"decode_cache.plan"}),
])
def test_a_call_records_its_ranges_inside_the_operation(operand, op,
                                                        children):
    """Under a profiler, one call of a ``cuda``-backend plan records
    ``plan.<op>`` once, enclosing the decode cache's and each kernel
    wrapper's range."""
    call = cuda_calls(operand)[op]
    call()                              # the pattern's miss comes first
    events, _ = profiled(call)
    ranges = program_ranges(events)
    outer = [e for e in ranges if e[0] == f"plan.{op}"]
    assert len(outer) == 1
    inner = [e for e in ranges if e is not outer[0]]
    assert {e[0] for e in inner} == children
    assert all(inside(e, outer[0]) for e in inner)


@pytest.mark.parametrize("pattern, misses", [("new", 1), ("repeated", 0)])
def test_a_decode_miss_records_one_range(operand, pattern, misses):
    """A straggler pattern the cache has not seen records one
    ``decode_cache.miss`` inside ``decode_cache.plan``; a repeated one
    records none."""
    A, xs = operand
    plan = port_plan(A, backend="cuda")
    x = torch.from_numpy(xs[0])
    if pattern == "repeated":
        plan.matvec(x, MASK)
    cache = plan.executor.cache
    before = cache.misses
    events, _ = profiled(lambda: plan.matvec(x, MASK))
    miss = [e for e in events if e[0] == "decode_cache.miss"]
    lookup = [e for e in events if e[0] == "decode_cache.plan"]
    assert len(miss) == cache.misses - before == misses
    assert len(lookup) == 1 and all(inside(e, lookup[0]) for e in miss)


def test_untraced_scope_is_the_shared_no_op(operand, monkeypatch):
    """With no profiler and no tracer, every scope is one shared no-op
    context, and a call never builds the process-global tracer."""
    monkeypatch.delenv("REPRO_TRACE", raising=False)
    monkeypatch.setattr(trace_mod, "_GLOBAL", None)
    assert trace_mod.scope("plan.matvec") is trace_mod.NO_SPAN
    assert trace_mod.scope("kernel.bcsr_matmul", None) is trace_mod.NO_SPAN
    cuda_calls(operand)["matvec"]()
    assert trace_mod._GLOBAL is None


@pytest.mark.parametrize("under_profiler", [False, True])
def test_per_call_ranges_stay_out_of_the_ring_buffer(operand, monkeypatch,
                                                     under_profiler):
    """With ``REPRO_TRACE=1`` the compile records its spans, and the
    calls after it add nothing to the ring buffer, profiled or not."""
    monkeypatch.setenv("REPRO_TRACE", "1")
    monkeypatch.setattr(trace_mod, "_GLOBAL", None)
    calls = cuda_calls(operand)
    tr = trace_mod.default_tracer()
    held = tr.events()
    assert {e["name"] for e in held} == {"plan.compile", "plan.encode"}

    def run():
        for call in calls.values():
            call()
    if under_profiler:
        profiled(run)
    else:
        run()
    assert tr.events() == held


def test_program_ranges_are_host_ops_not_annotations(operand, monkeypatch):
    """Every program range, the compile's with a tracer set too, is a
    plain host op (``bench/devtrace.py`` names idle gaps by those), and
    every name begins with a prefix the benchmark's reader selects."""
    monkeypatch.setenv("REPRO_TRACE", "1")
    monkeypatch.setattr(trace_mod, "_GLOBAL", None)

    def run():
        for call in cuda_calls(operand).values():
            call()
    events, _ = profiled(run)
    ranges = program_ranges(events)
    assert {e[0] for e in ranges} == set(trace_mod.PROGRAM_SPANS) - {
        "kernel.decode_matmul.prepare"}         # a layout check: cuda only
    assert not any(e[3] for e in ranges)
    assert all(name.startswith(("plan.", "decode_cache.", "kernel."))
               for name in trace_mod.PROGRAM_SPANS)


def test_ring_buffer_export_shares_the_profilers_clock(operand, tmp_path,
                                                       monkeypatch):
    """``write_chrome_trace`` stamps epoch microseconds: a span recorded
    in both sinks starts within 1 ms in the file and in the profiler's
    trace of the same process."""
    A, _ = operand
    monkeypatch.setenv("REPRO_TRACE", "1")
    monkeypatch.setattr(trace_mod, "_GLOBAL", None)
    events, _ = profiled(lambda: port_plan(A, backend="cuda"))
    path = tmp_path / "trace.json"
    write_chrome_trace(str(path), trace_mod.default_tracer())
    doc = json.loads(path.read_text())
    for name in ("plan.compile", "plan.encode"):
        ts = [e["ts"] for e in doc["traceEvents"] if e["name"] == name]
        starts = [e[1] * 1e-3 for e in events if e[0] == name]
        assert len(ts) == len(starts) == 1
        assert abs(ts[0] - starts[0]) < 1e3, (ts, starts)


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


# ---------------------------------------------------------------------------
# the model's ranges and the held-expert counter
# ---------------------------------------------------------------------------


def _latent_model(all_held: bool = False):
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_model
    cfg = get_smoke_config("kimi-k2-instruct")
    if all_held:
        cfg = cfg.with_(moe=dataclasses.replace(cfg.moe, n_held=None))
    model = build_model(cfg, torch.float32, device="cpu")
    model.init(torch.Generator().manual_seed(0))
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (3, 9)))
    return cfg, model, toks


def test_a_decode_step_opens_every_model_range():
    """Under a profiler a prefill opens ``model.prefill``, ``mla.prefill``
    and the MoE's ranges inside it; a decode step opens
    ``model.decode_step`` enclosing ``mla.decode``, ``moe.route``,
    ``moe.experts``, ``moe.shared`` and ``model.head``: every name of
    ``MODEL_SPANS`` between the two, each a plain host op."""
    _, model, toks = _latent_model()
    with torch.inference_mode():
        pre, (_, cache) = profiled(lambda: model.prefill(toks[:, :8], 16))
        dec, _ = profiled(lambda: model.decode_step(cache, toks[:, 8:9]))
    spans = set(trace_mod.MODEL_SPANS)
    for events, outer, layers in ((pre, "model.prefill", "mla.prefill"),
                                  (dec, "model.decode_step", "mla.decode")):
        ranges = [e for e in events if e[0] in spans]
        top = [e for e in ranges if e[0] == outer]
        assert len(top) == 1
        names = {e[0] for e in ranges}
        assert {layers, "moe.route", "moe.experts", "moe.shared",
                "model.head"} <= names
        assert all(inside(e, top[0]) for e in ranges)
        assert not any(e[3] for e in ranges)
    seen = {e[0] for e in pre + dec}
    assert spans <= seen
    assert not spans & set(trace_mod.PROGRAM_SPANS)


def test_held_counter_counts_every_routed_slot():
    """With every expert held, a decode step of 3 rows adds 3 x top_k to
    each MoE layer's counter; a dense layer has none."""
    cfg, model, toks = _latent_model(all_held=True)
    with torch.inference_mode():
        _, cache = model.prefill(toks[:, :8], 16)
        before = [blk.held_tokens.clone() for blk in model.layers[1:]]
        model.decode_step(cache, toks[:, 8:9])
    assert not hasattr(model.layers[0], "held_tokens")
    for blk, was in zip(model.layers[1:], before):
        assert int((blk.held_tokens - was).sum()) == 3 * cfg.moe.top_k
        assert blk.held_tokens.device == model.device
        assert not any(k.endswith("held_tokens")
                       for k in model.state_dict())


def test_model_scopes_are_the_shared_no_op_untraced(monkeypatch):
    monkeypatch.delenv("REPRO_TRACE", raising=False)
    for name in trace_mod.MODEL_SPANS:
        assert trace_mod.scope(name) is trace_mod.NO_SPAN
