"""The port's autoscaling (``repro_torch.scale``) against itself and the
JAX package's ``repro.scale``.

The controller cases are deterministic: a fake pool, a scripted sensor
and explicit ``step(now=...)`` ticks, with a clock that fails if it is
read.  Both packages' policies give the same targets on a grid of
snapshots, their controllers the same decision logs for the same fake
pool and snapshot script, and their knobs the same error messages.
Then the loop closes on live targets: a ``LocalPool`` growing a fleet
whose re-encode turns new workers into capacity (``grow_encodings``:
``k`` grows, ``s`` holds; on ``packed`` and on ``cuda``-on-CPU), a
``ReplicaPool`` growing a router endpoint under a paused backlog, and a
``RemotePool`` dialing ``--connect --device cpu`` workers into a tcp
coordinator.  Every value served across a scale event is held against
the plan that served it.  Every wait has its own timeout.
"""

import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.scale as ref_scale
import repro.scale.policy as ref_policy
from repro.obs import Tracer as RefTracer
from repro_torch.api import CodedFleet, compile_plan
from repro_torch.cluster.fleet import wait_settled
from repro_torch.obs import Tracer
from repro_torch.scale import (
    Autoscaler,
    LatencySloPolicy,
    LocalPool,
    ProvisionError,
    QueueDepthPolicy,
    RemotePool,
    ReplicaPool,
    ScaleController,
    ScaleSnapshot,
    SchedulePolicy,
    WorkerPool,
)
from repro_torch.scale import policy as port_policy
from repro_torch.serve import Router

ROOT = Path(__file__).resolve().parents[1]
LOOSE = dict(rtol=1e-3, atol=1e-3)


def block_sparse(rng, t, r, zeros, bs=8):
    mask = rng.random((t // bs, r // bs)) >= zeros
    a = rng.standard_normal((t, r)).astype(np.float32)
    return a * np.kron(mask, np.ones((bs, bs), np.float32))


@pytest.fixture(scope="module")
def operands():
    rng = np.random.default_rng(11)
    A = torch.from_numpy(block_sparse(rng, 256, 144, 0.98))
    xs = [torch.from_numpy(rng.standard_normal(256).astype(np.float32))
          for _ in range(8)]
    return A, xs


def port_plan(A, backend="packed", **kw):
    kw = {"scheme": "proposed", "n": 4, "s": 1, **kw}
    return compile_plan(A, backend=backend, device="cpu", **kw)


def snap(t=0.0, size=1, backlog=0.0, inflight=0.0, lat=None, floor=1,
         pkg=None):
    cls = ScaleSnapshot if pkg is None else pkg.ScaleSnapshot
    return cls(t=t, size=size, backlog=backlog, inflight=inflight,
               lat_ewma_ms=lat, floor=floor)


def wait_until(pred, timeout=15.0):
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < timeout:
        if pred():
            return True
        time.sleep(0.02)
    return pred()


# ---------------------------------------------------------------------------
# policies (pure: one snapshot in, a desired size out)
# ---------------------------------------------------------------------------


def test_queue_depth_scales_to_backlog():
    p = QueueDepthPolicy(high=8, low=1)
    assert p.target(snap(size=1, backlog=40)) == 5     # ceil(40/8)
    assert p.target(snap(size=5, backlog=20)) is None
    assert p.target(snap(size=5, backlog=0)) == 4
    assert p.target(snap(size=5, backlog=0, inflight=3)) is None


def test_queue_depth_validates_watermarks():
    with pytest.raises(ValueError, match="below"):
        QueueDepthPolicy(high=4, low=4)


def test_latency_slo():
    p = LatencySloPolicy(slo_ms=100.0, shrink_frac=0.5, low=1)
    assert p.target(snap(size=2, lat=250.0, backlog=9)) == 3
    assert p.target(snap(size=3, lat=80.0, backlog=0)) is None
    assert p.target(snap(size=3, lat=20.0, backlog=0)) == 2
    assert p.target(snap(size=3, lat=None, backlog=0)) == 2
    with pytest.raises(ValueError, match="slo_ms"):
        LatencySloPolicy(slo_ms=0)


def test_schedule_policy_steps_on_snapshot_time():
    p = SchedulePolicy([(0, 2), (10, 6), (20, 3)])
    assert p.target(snap(t=100.0)) == 2                 # t0 anchors here
    assert p.target(snap(t=105.0)) == 2
    assert p.target(snap(t=110.0)) == 6
    assert p.target(snap(t=125.0)) == 3
    with pytest.raises(ValueError):
        SchedulePolicy([])


def test_policy_targets_equal_reference_on_a_grid():
    """Every policy's target, and its description, equal the JAX
    package's over a grid of snapshots."""
    grid = [dict(t=float(t), size=size, backlog=float(b),
                 inflight=float(i), lat=lat)
            for t in (0, 3, 12) for size in (1, 3, 8)
            for b in (0, 1, 7, 9, 40, 200) for i in (0, 2)
            for lat in (None, 10.0, 60.0, 150.0)]
    makers = [
        lambda m: m.QueueDepthPolicy(high=8, low=1),
        lambda m: m.QueueDepthPolicy(high=3, low=0),
        lambda m: m.LatencySloPolicy(slo_ms=100.0),
        lambda m: m.LatencySloPolicy(slo_ms=50.0, shrink_frac=0.3, low=2),
        lambda m: m.SchedulePolicy([(0, 2), (5, 6), (10, 3)]),
    ]
    for make in makers:
        port, ref = make(port_policy), make(ref_policy)
        assert port.describe() == ref.describe()
        for g in grid:
            assert port.target(snap(**g)) == ref.target(
                snap(**g, pkg=ref_policy)), (port.describe(), g)


@pytest.mark.parametrize("var,value,fn", [
    ("REPRO_SCALE_HIGH", "bogus", "default_high_watermark"),
    ("REPRO_SCALE_LOW", "-1", "default_low_watermark"),
    ("REPRO_SCALE_MAX_WORKERS", "-3", "default_max_members"),
    ("REPRO_SCALE_MIN_WORKERS", "0", "default_min_members"),
    ("REPRO_SCALE_INTERVAL_MS", "1.5", "default_interval_ms"),
    ("REPRO_SCALE_COOLDOWN_MS", "x", "default_cooldown_ms"),
])
def test_env_knobs_strictly_parsed(monkeypatch, var, value, fn):
    """Garbage fails naming the variable, with the JAX package's message;
    legitimate values parse (the low watermark may be 0)."""
    monkeypatch.setenv(var, value)
    errors = []
    for mod in (ref_policy, port_policy):
        with pytest.raises(ValueError, match=var) as ei:
            getattr(mod, fn)()
        errors.append(str(ei.value))
    assert errors[0] == errors[1]
    monkeypatch.setenv("REPRO_SCALE_HIGH", "12")
    monkeypatch.setenv("REPRO_SCALE_LOW", "0")
    assert port_policy.default_high_watermark() == 12
    assert port_policy.default_low_watermark() == 0


# ---------------------------------------------------------------------------
# the controller, driven tick by tick with a fake clock + pool
# ---------------------------------------------------------------------------


def fake_pool_cls(base):
    class FakePool(base):
        kind = "fake"

        def __init__(self, size=1, fail_provision=False):
            super().__init__()
            self._members = list(range(size))
            self._next = size
            self.fail_provision = fail_provision

        def members(self):
            return list(self._members)

        def provision(self):
            if self.fail_provision:
                self._count("provision_failures")
                raise self.error("scripted provision failure")
            w, self._next = self._next, self._next + 1
            self._members.append(w)
            self._count("provisioned")
            return w

        def decommission(self, member):
            self._members.remove(member)
            self._count("decommissioned")

    return FakePool


FakePool = fake_pool_cls(WorkerPool)
FakePool.error = ProvisionError


def make_controller(pool, policy, signal, pkg=None, **kw):
    """Controller whose sensor reads the mutable ``signal`` dict and
    whose clock fails if consulted: every tick passes ``now=``."""
    snap_cls = ScaleSnapshot if pkg is None else pkg.ScaleSnapshot
    ctl_cls = ScaleController if pkg is None else pkg.ScaleController

    def sensor(now):
        return snap_cls(t=now, size=pool.size(), **signal)

    def no_clock():
        raise AssertionError("controller consulted the wall clock")

    kw.setdefault("cooldown_s", 1.0)
    return ctl_cls(pool, policy, sensor, clock=no_clock, **kw)


def test_burst_up_then_cooldown():
    pool = FakePool(size=1)
    c = make_controller(pool, QueueDepthPolicy(high=8, low=1),
                        {"backlog": 40.0}, min_members=1, max_members=8,
                        max_step_up=2)
    d = c.step(now=0.0)
    assert (d.action, d.target, d.applied) == ("up", 5, 2)
    assert pool.size() == 3
    d = c.step(now=0.5)
    assert (d.action, d.reason) == ("hold", "cooldown")
    assert pool.size() == 3
    d = c.step(now=1.5)
    assert (d.action, d.applied) == ("up", 2)
    assert pool.size() == 5


def test_scale_down_one_member_per_tick_newest_first():
    pool = FakePool(size=4)
    c = make_controller(pool, QueueDepthPolicy(high=8, low=1),
                        {"backlog": 0.0}, min_members=1, max_members=8)
    d = c.step(now=0.0)
    assert (d.action, d.applied) == ("down", -1)
    assert pool.members() == [0, 1, 2]
    c.step(now=10.0)
    assert pool.members() == [0, 1]


def test_clamps_to_min_and_max():
    pool = FakePool(size=2)
    sig = {"backlog": 10_000.0}
    c = make_controller(pool, QueueDepthPolicy(high=8, low=1), sig,
                        min_members=2, max_members=4, max_step_up=8)
    d = c.step(now=0.0)
    assert d.target == 4 and pool.size() == 4
    sig["backlog"] = 0.0
    c.step(now=10.0)
    c.step(now=20.0)
    d = c.step(now=30.0)
    assert pool.size() == 2
    assert (d.action, d.reason) == ("hold", "at-target")


def test_floor_restore_outranks_policy_and_cooldown_reason():
    pool = FakePool(size=1)
    c = make_controller(pool, QueueDepthPolicy(high=8, low=1),
                        {"backlog": 0.0, "floor": 3}, min_members=1,
                        max_members=8, max_step_up=4)
    d = c.step(now=0.0)
    assert (d.action, d.reason, d.applied) == ("up", "floor", 2)
    assert pool.size() == 3


def test_provision_failure_is_logged_not_fatal():
    pool = FakePool(size=1, fail_provision=True)
    c = make_controller(pool, QueueDepthPolicy(high=8, low=1),
                        {"backlog": 100.0}, min_members=1, max_members=8)
    d = c.step(now=0.0)
    assert d.action == "up" and not d.ok
    assert "scripted provision failure" in d.error
    assert c.counters["errors"] == 1
    pool.fail_provision = False
    d = c.step(now=5.0)
    assert d.ok and d.applied > 0


def test_every_action_lands_in_tracer_and_decision_log():
    tr = Tracer(capacity=64)
    pool = FakePool(size=1)
    sig = {"backlog": 40.0}
    c = make_controller(pool, QueueDepthPolicy(high=8, low=1), sig,
                        min_members=1, max_members=8, max_step_up=8,
                        tracer=tr)
    c.step(now=0.0)
    sig["backlog"] = 0.0
    c.step(now=10.0)
    c.step(now=10.5)                           # cooldown hold
    log = c.decision_log()
    assert [d["action"] for d in log] == ["up", "down", "hold"]
    marks = [e for e in tr.events() if e["name"] == "scale.decision"]
    assert [m["args"]["action"] for m in marks] == ["up", "down"]
    assert marks[0]["args"]["applied"] == 4
    m = c.metrics()
    assert m["counters"]["ups"] == 1 and m["counters"]["downs"] == 1
    assert m["last_decision"]["reason"] == "cooldown"
    assert m["pool"]["kind"] == "fake"


def test_schedule_policy_full_sequence():
    pool = FakePool(size=2)
    c = make_controller(pool, SchedulePolicy([(0, 2), (5, 6), (9, 4)]), {},
                        min_members=1, max_members=8, max_step_up=8,
                        cooldown_s=0.0)
    assert c.step(now=0.0).action == "hold"
    assert c.step(now=5.0).applied == 4
    assert c.step(now=9.0).applied == -1
    assert c.step(now=9.1).applied == -1
    assert pool.size() == 4
    assert c.step(now=9.2).action == "hold"


SCRIPTS = {
    # (pool size, policy, controller kwargs, [(now, signal), ...])
    "queue-depth": (1, lambda m: m.QueueDepthPolicy(high=8, low=1),
                    dict(min_members=1, max_members=8, max_step_up=2),
                    [(0.0, {"backlog": 40.0}), (0.5, {"backlog": 40.0}),
                     (1.5, {"backlog": 40.0}), (3.0, {"backlog": 9.0}),
                     (4.5, {"backlog": 0.0, "inflight": 2.0}),
                     (6.0, {"backlog": 0.0}), (6.5, {"backlog": 0.0}),
                     (8.0, {"backlog": 0.0, "floor": 6})]),
    "latency": (2, lambda m: m.LatencySloPolicy(slo_ms=100.0),
                dict(min_members=2, max_members=5),
                [(0.0, {"lat_ewma_ms": 250.0}), (2.0, {"lat_ewma_ms": 250.0}),
                 (4.0, {"lat_ewma_ms": 90.0}), (6.0, {"lat_ewma_ms": 10.0}),
                 (8.0, {"lat_ewma_ms": None}), (10.0, {})]),
    "schedule": (2, lambda m: m.SchedulePolicy([(0, 2), (5, 6), (9, 4)]),
                 dict(min_members=1, max_members=8, max_step_up=8,
                      cooldown_s=0.0),
                 [(0.0, {}), (5.0, {}), (9.0, {}), (9.1, {}), (9.2, {})]),
}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_decision_logs_equal_reference(name):
    """One fake pool and snapshot script through both packages'
    controllers: the same decision logs, the same pool, and the same
    ``scale.decision`` instants in their tracers."""
    size, policy, kw, script = SCRIPTS[name]
    logs = []
    for pkg, tracer in ((ref_scale, RefTracer), (None, Tracer)):
        mod = ref_policy if pkg is not None else port_policy
        pool = fake_pool_cls(WorkerPool if pkg is None
                             else pkg.WorkerPool)(size=size)
        pool.error = ProvisionError if pkg is None else pkg.ProvisionError
        sig: dict = {}
        tr = tracer(capacity=64)
        c = make_controller(pool, policy(mod), sig, pkg=pkg, tracer=tr,
                            **{"cooldown_s": 1.0, **kw})
        for now, s in script:
            sig.clear()
            sig.update(s)
            c.step(now=now)
        logs.append((c.decision_log(), pool.members(), c.counters,
                     [e["args"] for e in tr.events()
                      if e["name"] == "scale.decision"]))
    assert logs[0] == logs[1]
    assert any(d["action"] != "hold" for d in logs[0][0])


# ---------------------------------------------------------------------------
# pools + Autoscaler against live targets
# ---------------------------------------------------------------------------


def test_provision_decommission_roundtrip(operands):
    A, xs = operands
    with CodedFleet(4, device="cpu") as fleet:
        fleet.attach(port_plan(A))
        pool = LocalPool(fleet)
        w = pool.provision()
        assert w in fleet.live_workers() and pool.size() == 5
        pool.decommission(w)
        assert w not in fleet.live_workers() and pool.size() == 4
        m = pool.metrics()
        assert m["provisioned"] == 1 and m["decommissioned"] == 1


@pytest.mark.parametrize("backend", ["packed", "cuda"])
def test_autoscaler_grows_encoding_into_capacity(operands, backend):
    """A scale-up re-encodes to a larger code (n' > n, k' > k, s' >= s:
    the growth policy, whatever cut the measured rates give), the served
    values are the plan actually chosen (``handle.plan`` in process,
    under the same masks: bitwise on host workers), and scaling back
    reuses the first compile: bitwise the pre-growth results."""
    A, xs = operands
    plan = port_plan(A, backend)
    with CodedFleet(4, device="cpu", grow_encodings=True,
                    backend="cuda" if backend == "cuda" else None) as fleet:
        h = fleet.attach(plan)
        all4 = np.ones(4, bool)
        before = [h.matvec(x, all4) for x in xs[:2]]
        scaler = Autoscaler(fleet, policy=SchedulePolicy([(0, 4), (1, 6),
                                                          (3, 4)]),
                            min_members=2, max_members=8, cooldown_s=0.0)
        assert scaler.step(now=0.0).action == "hold"
        d = scaler.step(now=2.0)
        assert (d.action, d.applied) == ("up", 2)
        assert len(fleet.live_workers()) == 6
        wait_settled(h, 6)
        grown = h.plan
        assert grown.n > plan.n and grown.k > plan.k and grown.s >= plan.s
        for i, x in enumerate(xs[:3]):
            done = np.ones(grown.n, bool)
            done[[i, grown.n - 1 - i][: grown.s]] = False
            got, want = h.matvec(x, done), grown.matvec(x, done)
            if backend == "packed":
                assert torch.equal(got, want)
            else:
                # the plain versions sum the re-tiled worker shards and
                # the in-process tiles in other orders, and the decode
                # multiplies that by cond(G[rows]): held to 1e-3 of the
                # output's scale here, bitwise on the card
                assert (got - want).abs().max() <= 1e-3 * want.abs().max()
            np.testing.assert_allclose(h.matvec(x, done).numpy(),
                                       (x @ A).numpy(), **LOOSE)
        for now in (3.0, 3.5):
            assert scaler.step(now=now).applied == -1
        wait_settled(h, 4)
        assert h.plan is plan           # the first compile, reused
        for x, want in zip(xs[:2], before):
            assert torch.equal(h.matvec(x, all4), want)
        scaler.close()


def test_autoscaler_start_close_lifecycle(operands):
    A, xs = operands
    with CodedFleet(4, device="cpu") as fleet:
        fleet.attach(port_plan(A))
        with Autoscaler(fleet, policy=QueueDepthPolicy(high=8, low=1),
                        interval_s=0.02) as scaler:
            assert wait_until(
                lambda: scaler.metrics()["counters"]["ticks"] >= 3)
        with pytest.raises(RuntimeError, match="closed"):
            scaler.controller.start()


def test_autoscaler_rejects_unknown_target():
    with pytest.raises(TypeError, match="autoscale"):
        Autoscaler(object())


def test_backlog_scales_replicas_up_and_down(operands):
    A, xs = operands
    plan = port_plan(A, n=6, s=2)
    with Router() as router:
        router.register("head", plan, replicas=1, n_workers=6)
        scaler = Autoscaler(router, endpoint="head",
                            policy=QueueDepthPolicy(high=8, low=1),
                            n_workers=6, min_members=1, max_members=3,
                            cooldown_s=0.0)
        router.pause()
        futs = [router.submit("head", xs[i % len(xs)]) for i in range(30)]
        d = scaler.step(now=0.0)
        assert d.action == "up" and scaler.pool.size() == 3
        reps = router._endpoints["head"].replicas
        assert [(r.fleet.backend, r.fleet.device.type) for r in reps] == \
            [("packed", "cpu")] * 3
        router.resume()
        vals = [f.result(60) for f in futs]
        for i in (0, 13, 29):
            assert torch.equal(vals[i], plan.matvec(xs[i % len(xs)],
                                                    futs[i].report.pattern))
        for now in (1.0, 2.0, 3.0):
            scaler.step(now=now)
        assert scaler.pool.size() == 1
        assert all(f.done() for f in futs)
        scaler.close()


def test_last_replica_is_protected(operands):
    A, xs = operands
    with Router() as router:
        router.register("head", port_plan(A, n=6, s=2), replicas=1,
                        n_workers=6)
        pool = ReplicaPool(router, "head", n_workers=6)
        with pytest.raises(ProvisionError, match="last live replica"):
            pool.decommission(pool.members()[0])


def test_remote_pool_dials_standalone_workers(operands):
    """``--connect --device cpu`` workers dial a coordinator that spawns
    none; the pool provisions a third and retires it, the plan serving
    bitwise its in-process self throughout."""
    A, xs = operands
    plan = port_plan(A)
    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    port = probe.getsockname()[1]
    probe.close()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src")] + [p for p in os.environ.get(
            "PYTHONPATH", "").split(os.pathsep) if p]))
    procs = []

    def launch(worker_id, port_):
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "repro_torch.cluster.worker",
             "--connect", f"127.0.0.1:{port_}", "--id", str(worker_id),
             "--device", "cpu"], env=env, stdout=subprocess.DEVNULL))

    for w in range(2):
        launch(w, port)
    try:
        with CodedFleet(2, transport="tcp", device="cpu",
                        transport_opts={"spawn": False, "port": port}
                        ) as fleet:
            h = fleet.attach(plan)
            done = np.ones(4, bool)
            ref = h.matvec(xs[0], done)
            assert torch.equal(ref, plan.matvec(xs[0], done))
            pool = RemotePool(fleet, launch)
            w = pool.provision()
            assert w == 2 and pool.size() == 3
            assert torch.equal(h.matvec(xs[1], done),
                               plan.matvec(xs[1], done))
            pool.decommission(w)
            assert pool.size() == 2
            assert torch.equal(h.matvec(xs[0], done), ref)
    finally:
        for p in procs:
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()


def test_remote_pool_rejects_non_tcp_fleet():
    with CodedFleet(2, device="cpu") as fleet:
        with pytest.raises(ValueError, match="tcp"):
            RemotePool(fleet, lambda w, p: None)


def test_autoscaler_sensors_read_the_same_fields_as_the_reference():
    """``fleet_sensor`` and ``router_sensor`` read only fields the port's
    metrics carry, with the JAX package's meaning."""
    from repro_torch.scale import fleet_sensor, router_sensor

    rng = np.random.default_rng(0)
    A = torch.from_numpy(block_sparse(rng, 64, 48, 0.5))
    plan = port_plan(A, n=6, s=2)
    with CodedFleet(6, device="cpu", min_workers=2) as fleet, \
            Router() as router:
        fleet.attach(plan)
        s = fleet_sensor(fleet)(1.0)
        assert (s.t, s.size, s.backlog, s.inflight, s.floor) == \
            (1.0, 6, 0, 0, 2)
        assert s.extra == {"transport": "memory"}
        router.register("head", plan, replicas=2, n_workers=6)
        router.pause()
        futs = [router.submit("head", torch.ones(3, 64)) for _ in range(2)]
        r = router_sensor(router, "head")(2.0)
        assert (r.size, r.backlog, r.inflight, r.floor) == (2, 6, 0, 1)
        assert r.extra == {"width": 1, "depth_ewma": 0.0}
        router.resume()
        [f.result(30) for f in futs]


def test_jax_package_grows_like_the_port(operands):
    """The JAX package's autoscaled fleet under the same schedule grows
    to the same (n, k, s) the port's does when no rates are measured
    (a uniform cut); both serve within tolerance of A^T x."""
    from repro.api import CodedFleet as RefFleet
    from repro.api import compile_plan as ref_compile

    A, xs = operands
    shapes = []
    for fleet_cls, plan in (
            (RefFleet, ref_compile(jnp.asarray(A.numpy()), scheme="proposed",
                                   n=4, s=1, backend="packed")),
            (lambda *a, **k: CodedFleet(*a, device="cpu", **k),
             port_plan(A))):
        with fleet_cls(4, grow_encodings=True) as fleet:
            h = fleet.attach(plan)
            fleet._rate.clear()
            scaler = (ref_scale.Autoscaler if fleet_cls is RefFleet
                      else Autoscaler)(
                fleet, policy=(ref_scale.SchedulePolicy
                               if fleet_cls is RefFleet
                               else SchedulePolicy)([(0, 4), (1, 5)]),
                min_members=2, max_members=8, cooldown_s=0.0)
            scaler.step(now=0.0)
            fleet._rate.clear()
            fleet.worker_capacities = lambda ws=None, levels=4, rates=None: \
                [1] * len(ws if ws is not None else fleet.live_workers())
            scaler.step(now=2.0)
            wait_settled(h, 5)
            shapes.append((h.plan.n, h.plan.k, h.plan.s))
            np.testing.assert_allclose(np.asarray(h.matvec(
                np.asarray(xs[0].numpy()))), (xs[0] @ A).numpy(), **LOOSE)
            scaler.close()
    assert shapes[0] == shapes[1] == [(5, 4, 1)][0]
