"""The port's serve front door (``repro_torch.serve.Router``) against
itself and against the JAX package's router.

The JAX package's router cases, on host fleets (``packed``; the parity
cases also on ``cuda``-on-CPU, whose workers run ``bcsr_matmul``'s plain
version): routed calls bitwise the same call on a direct handle, the
weighted-fair stride, tenant isolation, the adaptive width, live config
push, non-blocking dispatch, the engine's router mode and shutdown
hygiene.  Where the JAX package's cases are paced by wall-clock windows
(service ratios, the width ramp, load balance), these hold exact,
deterministic sequences instead: a paused burst gives the same dispatch
log (tenant, calls, columns, width) in both packages, and that log
follows the stride the weights give.  Every wait has its own timeout.
"""

import itertools
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as ref_api
import repro.configs as ref_configs
import repro.models as ref_models
import repro.serve as ref_serve
import repro_torch.configs as port_configs
import repro_torch.serve as port_serve
from repro_torch.api import CodedFleet, FleetDegraded, compile_plan
from repro_torch.convert import model_params_from_reference
from repro_torch.models import build_model
from repro_torch.serve import Router, ServeEngine
from repro_torch.serve.router import default_balancer, default_queue_cap

TOL = dict(rtol=2e-5, atol=2e-5)
LOOSE = dict(rtol=5e-3, atol=5e-3)
CPU = torch.device("cpu")
FLEET_THREADS = ("repro-router-sched", "coded-fleet", "cluster-worker",
                 "cluster-beat")


def block_sparse(rng, t, r, zeros, bs=8):
    mask = rng.random((t // bs, r // bs)) >= zeros
    a = rng.standard_normal((t, r)).astype(np.float32)
    return a * np.kron(mask, np.ones((bs, bs), np.float32))


@pytest.fixture(scope="module")
def operands():
    rng = np.random.default_rng(7)
    A = block_sparse(rng, 256, 144, 0.98)
    xs = rng.standard_normal((10, 4, 256)).astype(np.float32)
    return torch.from_numpy(A), torch.from_numpy(xs)


def port_plan(A, backend="packed", **kw):
    kw = {"scheme": "proposed", "n": 6, "s": 2, **kw}
    return compile_plan(A, backend=backend, device="cpu", **kw)


@pytest.fixture(scope="module")
def plan(operands):
    return port_plan(operands[0])


def host_fleet(n, backend="packed", **kw):
    """A fleet whose workers fit a host plan of ``backend``."""
    return CodedFleet(n, device="cpu",
                      backend="cuda" if backend == "cuda" else None, **kw)


def assert_replays(got, want, backend):
    """Host workers replay bitwise; card workers on the CPU run the plain
    version of ``bcsr_matmul``, whose einsum may sum in another order at
    another width, so there f32 tolerance (bitwise is the card's, in
    ``test_torch_cuda.py``)."""
    if backend == "packed":
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, **TOL)


def leftover_threads():
    return [t.name for t in threading.enumerate()
            if t.name.startswith(FLEET_THREADS)]


def wait_until(pred, timeout=10.0):
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < timeout:
        if pred():
            return True
        time.sleep(0.01)
    return pred()


def ref_xs(xs):
    return jnp.asarray(xs.numpy())


def burst_log(router_cls, plan, xs, *, weights, calls, **register):
    """Pause, queue ``calls`` per tenant (tenants in ``weights`` order),
    resume, drain; -> (the dispatch log as (tenant, calls, cols, width),
    the results, per-tenant counters).  The same function drives both
    packages' routers."""
    with router_cls(batch_wait_s=0.002) as router:
        router.register("head", plan, replicas=1, n_workers=6, **register)
        for name, w in weights.items():
            router.set_tenant(name, weight=w)
        router.pause()
        futs = [router.submit("head", xs[i % len(xs)], tenant=name)
                for i in range(calls) for name in weights]
        router.resume()
        outs = [f.result(60) for f in futs]
        log = router.dispatch_log("head")
        m = router.metrics()["endpoints"]["head"]
    seq = [(e["tenant"], e["calls"], e["cols"], e["width"]) for e in log]
    counters = {t: v["counters"] for t, v in m["tenants"].items()}
    return seq, outs, futs, counters, m


def stride_order(weights, seq):
    """The tenant each dispatch of ``seq`` must go to under weighted-fair
    stride with these batch widths: the smallest pass among tenants with
    calls still queued (ties by name), each dispatch adding its columns
    over the weight.  Written from the rule, not from the router."""
    left = {t: sum(c for tt, c, _, _ in seq if tt == t) for t in weights}
    passes = {t: 0.0 for t in weights}
    order = []
    for tenant, calls, cols, _ in seq:
        pick = min((t for t in weights if left[t] > 0),
                   key=lambda t: (passes[t], t))
        order.append(pick)
        passes[pick] += cols / weights[pick]
        left[tenant] -= calls
    return order


# ---------------------------------------------------------------------------
# Parity: routed == direct PlanHandle, and the JAX package's routed values
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("transport", ["memory", "pipe", "tcp"])
def test_explicit_mask_bitwise_vs_direct_handle(operands, plan, transport):
    A, xs = operands
    done = np.ones(6, bool)
    done[[1, 4]] = False
    with Router() as router, CodedFleet(6, transport=transport,
                                        device="cpu") as ref_fleet:
        router.register("head", plan, replicas=1, n_workers=6,
                        transport=transport)
        h = ref_fleet.attach(plan)
        for i in range(3):
            routed = router.call("head", xs[i], done=done)
            assert torch.equal(routed, h.matvec(xs[i], done))
            assert torch.equal(routed, plan.matvec(xs[i], done))


@pytest.mark.parametrize("backend", ["packed", "cuda"])
def test_race_mode_observed_pattern_bitwise(operands, backend):
    """Batched race-mode calls carry their round's observed pattern in
    ``fut.report``; a direct handle and the in-process plan replay every
    routed result (on ``cuda`` the workers' products run at the batch's
    width and each call's decode on its own slice)."""
    A, xs = operands
    plan = port_plan(A, backend)
    with Router() as router, host_fleet(6, backend) as ref_fleet:
        router.register("head", plan, replicas=1, n_workers=6)
        assert router._endpoints["head"].replicas[0].fleet.backend == (
            "cuda" if backend == "cuda" else "packed")
        router.pause()
        futs = [router.submit("head", xs[i]) for i in range(6)]
        router.resume()
        outs = [f.result(30) for f in futs]
        h = ref_fleet.attach(plan)
        for i, f in enumerate(futs):
            assert_replays(outs[i], h.matvec(xs[i], f.report.pattern),
                           backend)
            assert_replays(outs[i], plan.matvec(xs[i], f.report.pattern),
                           backend)


@pytest.mark.parametrize("backend", ["packed", "cuda"])
def test_routed_values_match_reference(operands, backend):
    """The same explicit-mask calls through both packages' routers agree
    within f32 tolerance (the JAX package on its ``packed`` backend)."""
    A, xs = operands
    plan = port_plan(A, backend)
    rplan = ref_api.compile_plan(jnp.asarray(A.numpy()), scheme="proposed",
                                 n=6, s=2, backend="packed")
    masks = [np.roll([True] * 4 + [False] * 2, i) for i in range(3)]
    with Router() as router, ref_serve.Router() as rrouter:
        router.register("head", plan, replicas=1, n_workers=6)
        rrouter.register("head", rplan, replicas=1, n_workers=6)
        for i, done in enumerate(masks):
            got = router.call("head", xs[i], done=done)
            want = rrouter.call("head", ref_xs(xs[i]), done=done)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_batched_calls_share_one_round(operands, plan):
    A, xs = operands
    with Router(batch_wait_s=0.05) as router:
        router.register("head", plan, replicas=1, n_workers=6,
                        adaptive=False, width=64)
        router.pause()
        futs = [router.submit("head", xs[i]) for i in range(5)]
        router.resume()
        [f.result(30) for f in futs]
        log = router.dispatch_log("head")
    assert len(log) == 1 and log[0]["calls"] == 5
    assert len({id(f.report) for f in futs}) == 1


# ---------------------------------------------------------------------------
# Weighted-fair scheduling
# ---------------------------------------------------------------------------


def contended(plan, xs, weights, calls=12, router_cls=Router):
    return burst_log(router_cls, plan, xs, weights=weights, calls=calls,
                     adaptive=False, width=8, max_inflight=2)


def test_dispatch_sequence_deterministic(operands, plan):
    A, xs = operands
    w = {"pro": 3.0, "free": 1.0}
    seq1, *_, c1, _ = contended(plan, xs, w)
    seq2, *_, c2, _ = contended(plan, xs, w)
    assert seq1 == seq2
    assert {t: c["resolved"] for t, c in c1.items()} == \
        {t: c["resolved"] for t, c in c2.items()} == {"pro": 12, "free": 12}


@pytest.mark.parametrize("backend", ["packed", "cuda"])
def test_service_tracks_weights_under_contention(operands, backend):
    """In place of the JAX package's service-ratio window: the dispatch
    log of a paused 3:1 burst is exactly the JAX package's, each dispatch
    goes to the tenant the stride rule picks, and while both tenants
    queue the columns served split 3:1 to within one batch."""
    A, xs = operands
    w = {"pro": 3.0, "free": 1.0}
    seq, *_ = contended(port_plan(A, backend), xs, w, calls=16)
    rplan = ref_api.compile_plan(jnp.asarray(A.numpy()), scheme="proposed",
                                 n=6, s=2, backend="packed")
    rseq, *_ = contended(rplan, ref_xs(xs), w, calls=16,
                         router_cls=ref_serve.Router)
    assert seq == rseq
    assert [t for t, *_ in seq] == stride_order(w, seq)
    served, left = {"pro": 0, "free": 0}, {"pro": 16, "free": 16}
    for tenant, calls, cols, _ in seq:
        if min(left.values()) <= 0:
            break
        served[tenant] += cols
        left[tenant] -= calls
    assert abs(served["pro"] - 3 * served["free"]) <= 3 * 8


def test_no_starvation_on_equal_weights(operands, plan):
    A, xs = operands
    seq, *_, counters, _ = contended(plan, xs, {"a": 1.0, "b": 1.0})
    assert {t: c["resolved"] for t, c in counters.items()} == \
        {"a": 12, "b": 12}
    tenants = [t for t, *_ in seq]
    assert max(len(list(g)) for _, g in
               itertools.groupby(tenants[:-2])) <= 2


# ---------------------------------------------------------------------------
# Tenant isolation
# ---------------------------------------------------------------------------


def test_deadline_expiry_scoped_to_tenant(operands, plan):
    A, xs = operands
    with Router() as router:
        router.register("head", plan, replicas=1, n_workers=6)
        router.pause()
        doomed = [router.submit("head", xs[i], tenant="slow",
                                deadline=0.02) for i in range(3)]
        safe = [router.submit("head", xs[i], tenant="fast")
                for i in range(3)]
        time.sleep(0.1)                         # the deadline passes
        router.resume()
        for f in doomed:
            with pytest.raises(TimeoutError):
                f.result(30)
        for i, f in enumerate(safe):
            np.testing.assert_allclose(f.result(30).numpy(),
                                       (xs[i] @ A).numpy(), **LOOSE)
        m = router.metrics()["endpoints"]["head"]["tenants"]
        assert m["slow"]["counters"]["deadline_hit"] == 3
        assert m["fast"]["counters"]["failed"] == 0


def test_shed_admission_scoped_to_tenant(operands, plan):
    A, xs = operands
    with Router() as router:
        router.register("head", plan, replicas=1, n_workers=6)
        router.set_tenant("burst", queue_cap=2, admission="shed")
        router.pause()
        kept = [router.submit("head", xs[i], tenant="burst")
                for i in range(2)]
        with pytest.raises(FleetDegraded) as ei:
            router.submit("head", xs[2], tenant="burst")
        assert ei.value.action == "shed"
        other = router.submit("head", xs[3], tenant="steady")
        router.resume()
        for f in [*kept, other]:
            assert f.result(30) is not None
        m = router.metrics()["endpoints"]["head"]["tenants"]
        assert m["burst"]["counters"]["shed"] == 1
        assert m["steady"]["counters"]["resolved"] == 1


def test_cancel_queued_call(operands, plan):
    A, xs = operands
    with Router() as router:
        router.register("head", plan, replicas=1, n_workers=6)
        router.pause()
        fut = router.submit("head", xs[0], tenant="t")
        assert fut.cancel()
        router.resume()
        assert fut.cancelled()
        m = router.metrics()["endpoints"]["head"]["tenants"]
        assert m["t"]["counters"]["cancelled"] == 1


# ---------------------------------------------------------------------------
# Adaptive microbatching feedback
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["packed", "cuda"])
def test_width_ramps_under_backlog_and_collapses_idle(operands, backend):
    """In place of the JAX package's timed ramp: a paused burst walks the
    width through exactly the JAX package's sequence (it ramps), the
    routed values agree with the JAX package's routed values replayed
    under the port's observed patterns, and idle solo calls collapse the
    width to 1 in the same number of steps in both packages."""
    A, xs = operands
    plan = port_plan(A, backend)
    rplan = ref_api.compile_plan(jnp.asarray(A.numpy()), scheme="proposed",
                                 n=6, s=2, backend="packed")
    widths = {}
    for name, cls, p, x in (("port", Router, plan, xs),
                            ("ref", ref_serve.Router, rplan, ref_xs(xs))):
        with cls(batch_wait_s=0.002) as router:
            router.register("head", p, replicas=1, n_workers=6,
                            min_cols=1, max_cols=64)
            assert router.metrics()["endpoints"]["head"]["width"] == 1
            router.pause()
            futs = [router.submit("head", x[i % len(x)]) for i in range(24)]
            router.resume()
            outs = [f.result(60) for f in futs]
            log = [(e["calls"], e["cols"], e["width"])
                   for e in router.dispatch_log("head")]
            grown = router.metrics()["endpoints"]["head"]["width"]
            idle = []
            for _ in range(8):
                router.call("head", x[0])
                idle.append(router.metrics()["endpoints"]["head"]["width"])
        widths[name] = (log, grown, idle)
        if name == "port":
            pouts, pfuts = outs, futs
    assert widths["port"] == widths["ref"]
    log, grown, idle = widths["port"]
    assert grown > 1 and max(c for _, c, _ in log) > 4
    assert idle[-1] == 1
    with ref_serve.Router() as rrouter:
        rrouter.register("head", rplan, replicas=1, n_workers=6)
        for i in (0, 7, 23):
            want = rrouter.call("head", ref_xs(xs[i % len(xs)]),
                                done=pfuts[i].report.pattern)
            np.testing.assert_allclose(pouts[i].numpy(), np.asarray(want),
                                       **TOL)


def test_static_width_is_frozen(operands, plan):
    A, xs = operands
    with Router() as router:
        router.register("head", plan, replicas=1, n_workers=6,
                        adaptive=False, width=8)
        router.pause()
        futs = [router.submit("head", xs[i % len(xs)]) for i in range(16)]
        router.resume()
        [f.result(60) for f in futs]
        assert router.metrics()["endpoints"]["head"]["width"] == 8
        assert all(e["cols"] <= 8 + 4 for e in router.dispatch_log("head"))


# ---------------------------------------------------------------------------
# Metrics under load (the autoscaler's sensor surface)
# ---------------------------------------------------------------------------


def test_backlog_width_and_latency_signals(operands, plan):
    """The fields ``repro_torch.scale.router_sensor`` reads: queued
    columns while paused; after the drain, the width and backlog EWMA
    the paused burst gives (equal to the JAX package's) and a latency
    EWMA."""
    A, xs = operands
    rplan = ref_api.compile_plan(jnp.asarray(A.numpy()), scheme="proposed",
                                 n=6, s=2, backend="packed")
    after = {}
    for name, cls, p, x in (("port", Router, plan, xs),
                            ("ref", ref_serve.Router, rplan, ref_xs(xs))):
        with cls(batch_wait_s=0.002) as router:
            router.register("head", p, replicas=1, n_workers=6,
                            min_cols=1, max_cols=64)
            router.pause()
            futs = [router.submit("head", x[i % len(x)]) for i in range(24)]
            m = router.metrics()["endpoints"]["head"]
            assert m["queued_cols"] == 24 * 4
            assert m["tenants"]["default"]["queued"] == 24
            assert m["tenants"]["default"]["queued_cols"] == 24 * 4
            (rep,) = m["replicas"]
            assert rep["dispatched"] == 0 and rep["lat_ewma_ms"] is None
            router.resume()
            [f.result(60) for f in futs]
            m = router.metrics()["endpoints"]["head"]
            (rep,) = m["replicas"]
            assert m["queued_cols"] == 0 and rep["outstanding_cols"] == 0
            assert rep["dispatched"] > 0 and rep["lat_ewma_ms"] > 0
            after[name] = (m["width"], m["depth_ewma"], rep["dispatched"])
    assert after["port"] == after["ref"]
    assert after["port"][0] > 1 and after["port"][1] > 0


# ---------------------------------------------------------------------------
# Config push without dropping traffic
# ---------------------------------------------------------------------------


def test_configure_retunes_live(operands, plan):
    A, xs = operands
    with Router() as router:
        router.register("head", plan, replicas=1, n_workers=6,
                        adaptive=False, width=4)
        router.call("head", xs[0])
        router.configure("head", width=32, batch_wait_s=0.001)
        m = router.metrics()["endpoints"]["head"]
        assert m["width"] == 32 and m["batch_wait_s"] == 0.001


def test_swap_plan_mid_traffic(operands, plan):
    A, xs = operands
    plan2 = port_plan(A, scheme="cyclic31")
    with Router() as router:
        router.register("head", plan, replicas=1, n_workers=6)
        router.pause()
        before = [router.submit("head", xs[i]) for i in range(3)]
        router.resume()
        router.swap_plan("head", plan2)
        after = [router.submit("head", xs[i]) for i in range(3)]
        for j, f in enumerate(before + after):
            np.testing.assert_allclose(f.result(30).numpy(),
                                       (xs[j % 3] @ A).numpy(), **LOOSE)


def test_add_remove_replica_live(operands, plan):
    A, xs = operands
    with Router() as router:
        router.register("head", plan, replicas=1, n_workers=6)
        idx = router.add_replica("head", n_workers=6)
        futs = [router.submit("head", xs[i % len(xs)]) for i in range(12)]
        [f.result(30) for f in futs]
        assert len(router.metrics()["endpoints"]["head"]["replicas"]) == 2
        router.remove_replica("head", idx)
        m = router.metrics()["endpoints"]["head"]["replicas"]
        assert [r["index"] for r in m] == [0]
        np.testing.assert_allclose(router.call("head", xs[0]).numpy(),
                                   (xs[0] @ A).numpy(), **LOOSE)


def test_remove_last_replica_refuses(operands, plan):
    with Router() as router:
        router.register("head", plan, replicas=1, n_workers=6)
        with pytest.raises(ValueError, match="last live replica"):
            router.remove_replica("head", 0)


def test_replica_indices_monotonic_after_remove(operands, plan):
    A, xs = operands
    with Router() as router:
        router.register("head", plan, replicas=2, n_workers=6)
        assert router.add_replica("head", n_workers=6) == 2
        router.remove_replica("head", 1)
        assert router.add_replica("head", n_workers=6) == 3
        idxs = [r["index"] for r in
                router.metrics()["endpoints"]["head"]["replicas"]]
        assert idxs == [0, 2, 3]
        router.remove_replica("head", 2)        # THE replica 2, not 3
        idxs = [r["index"] for r in
                router.metrics()["endpoints"]["head"]["replicas"]]
        assert idxs == [0, 3]
        np.testing.assert_allclose(router.call("head", xs[0]).numpy(),
                                   (xs[0] @ A).numpy(), **LOOSE)


class Gate:
    """Fault model whose workers hold every task until ``open`` is set
    (memory workers are threads of this process), so the router's picks
    happen while every dispatched round is still in flight."""

    def __init__(self):
        self.open = threading.Event()

    def should_fail(self, worker, tasks_done):
        assert self.open.wait(30.0)
        return False

    def delay(self, worker, task_row, work):
        return 0.0


def test_replicas_balance_load(operands, plan):
    """In place of the JAX package's timed balance check: with both
    replicas' rounds held in flight, least-loaded alternates the replicas
    (ties by index) until each holds its ``max_inflight`` rounds; once
    released, every call resolves bitwise its replay."""
    A, xs = operands
    gate = Gate()
    fleets = [CodedFleet(6, device="cpu", faults=gate, max_inflight=2,
                         microbatch=False) for _ in range(2)]
    try:
        with Router() as router:
            router.register("head", plan, fleets=fleets, adaptive=False,
                            width=4)
            router.pause()
            futs = [router.submit("head", xs[i % len(xs)])
                    for i in range(16)]
            router.resume()
            assert wait_until(lambda: len(router.dispatch_log("head")) == 4)
            time.sleep(0.05)            # no fifth pick while both are full
            log = router.dispatch_log("head")
            assert [e["replica"] for e in log] == [0, 1, 0, 1]
            gate.open.set()
            outs = [f.result(60) for f in futs]
            used = {e["replica"] for e in router.dispatch_log("head")}
            assert used == {0, 1}
            for i, (out, f) in enumerate(zip(outs, futs)):
                assert torch.equal(out, plan.matvec(xs[i % len(xs)],
                                                    f.report.pattern))
    finally:
        gate.open.set()
        for f in fleets:
            f.close()


# ---------------------------------------------------------------------------
# The scheduler thread never parks inside fleet admission
# ---------------------------------------------------------------------------


def test_backlog_wider_than_fleet_queue_cap_no_deadlock(operands, plan):
    A, xs = operands
    with CodedFleet(6, device="cpu", queue_cap=8, max_inflight=2) as fleet, \
            Router() as router:
        router.register("head", plan, fleets=[fleet], adaptive=False,
                        width=256)
        router.pause()
        futs = [router.submit("head", xs[i % len(xs)]) for i in range(20)]
        router.resume()
        for i, f in enumerate(futs):
            np.testing.assert_allclose(f.result(60).numpy(),
                                       (xs[i % len(xs)] @ A).numpy(),
                                       **LOOSE)
        assert all(e["calls"] <= 8 for e in router.dispatch_log("head"))


def test_saturated_endpoint_never_blocks_neighbors(operands, plan):
    """Head-of-line isolation: while one endpoint's only replica holds
    its whole admission budget in gated rounds, another endpoint's
    tenant is served."""
    A, xs = operands
    gate = Gate()
    with CodedFleet(6, device="cpu", faults=gate, queue_cap=4,
                    max_inflight=2, microbatch=False) as busy_fleet, \
            Router(batch_wait_s=0.002) as router:
        try:
            router.register("busy", plan, fleets=[busy_fleet],
                            adaptive=False, width=16)
            router.register("snappy", plan, replicas=1, n_workers=6)
            stuck = [router.submit("busy", xs[i % len(xs)])
                     for i in range(12)]
            assert wait_until(lambda: router.metrics()["endpoints"]["busy"]
                              ["replicas"][0]["free_calls"] == 0)
            np.testing.assert_allclose(
                router.call("snappy", xs[0], deadline=10.0).numpy(),
                (xs[0] @ A).numpy(), **LOOSE)
            assert router.metrics()["endpoints"]["busy"]["queued_cols"] > 0
        finally:
            gate.open.set()
        for f in stuck:
            f.result(60)


def test_unregister_timeout_fails_leftovers_cleanly(operands, plan):
    A, xs = operands
    with Router() as router:
        router.register("head", plan, replicas=1, n_workers=6)
        router.pause()
        futs = [router.submit("head", xs[i], tenant="t") for i in range(4)]
        router.unregister("head", timeout=0.2)
        for f in futs:
            with pytest.raises(RuntimeError, match="unregistered"):
                f.result(5)
        assert router.endpoints() == []
        router.resume()
        router.register("head", plan, replicas=1, n_workers=6)
        np.testing.assert_allclose(router.call("head", xs[0]).numpy(),
                                   (xs[0] @ A).numpy(), **LOOSE)


# ---------------------------------------------------------------------------
# The engine's front door
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def smoke_model():
    """The qwen3-14b smoke model in both packages, on the same weights."""
    cfg = ref_configs.get_smoke_config("qwen3-14b")
    jm = ref_models.build_model(cfg, dtype=jnp.float32)
    jp = jm.init(jax.random.key(0))
    pcfg = port_configs.get_smoke_config("qwen3-14b")
    pm = build_model(pcfg, torch.float32, device=CPU)
    sd = model_params_from_reference(jax.tree.map(np.asarray, jp), pcfg,
                                     device=CPU)
    return cfg, jm, jp, pcfg, pm, sd


def port_engine(smoke_model, **coded):
    *_, pcfg, pm, sd = smoke_model
    return ServeEngine(pm, sd, pcfg, batch_size=2, max_len=32,
                       coded=port_configs.base.CodedConfig(
                           enabled=True, n_workers=6, stragglers=2,
                           backend="packed", **coded))


def test_engine_routes_coded_head_as_tenant(smoke_model):
    """The engine registers its endpoint, calls through it as its tenant
    (bitwise the in-process engine under explicit masks, within f32
    tolerance of the JAX package's engine in router mode) and
    unregisters it on close."""
    cfg, jm, jp, pcfg, *_ = smoke_model
    hidden = np.random.default_rng(0).standard_normal(
        (2, pcfg.d_model)).astype(np.float32)
    h = torch.from_numpy(hidden)
    router, rrouter = Router(), ref_serve.Router()
    local = port_engine(smoke_model)
    try:
        engine = port_engine(smoke_model, router=router, tenant="engine")
        ref = ref_serve.ServeEngine(
            jm, jp, cfg, batch_size=2, max_len=32,
            coded=ref_configs.base.CodedConfig(
                enabled=True, n_workers=6, stragglers=2, backend="packed",
                router=rrouter, tenant="engine"))
        assert router.has_endpoint("lm-head")
        assert engine.coded_cluster is None
        for i in range(3):
            done = np.ones(6, bool)
            done[[i, (i + 3) % 6]] = False
            got = engine.coded_logits(h, done)
            assert got.dtype == torch.float32
            assert torch.equal(got, local.coded_logits(h, done))
            np.testing.assert_allclose(
                got.numpy(), np.asarray(ref.coded_logits(
                    jnp.asarray(hidden), jnp.asarray(done))), **TOL)
        torch.testing.assert_close(engine.coded_logits(h),
                                   h @ engine.params["head"], **LOOSE)
        m = router.metrics()["endpoints"]["lm-head"]["tenants"]
        assert m["engine"]["counters"]["resolved"] == 4
        engine.close()
        ref.close()
        assert not router.has_endpoint("lm-head")
    finally:
        router.close()
        rrouter.close()


def test_engine_register_race_falls_back_to_shared(smoke_model):
    *_, pcfg, pm, sd = smoke_model
    router = Router()
    try:
        winner = port_engine(smoke_model, router=router)
        real = router.has_endpoint
        state = {"stale": True}

        def stale_once(name):           # the loser's pre-check snapshot
            if state.pop("stale", False):
                return False
            return real(name)

        router.has_endpoint = stale_once
        try:
            loser = port_engine(smoke_model, router=router)
        finally:
            router.has_endpoint = real
        h = torch.from_numpy(np.random.default_rng(1).standard_normal(
            (2, pcfg.d_model)).astype(np.float32))
        torch.testing.assert_close(loser.coded_logits(h),
                                   h @ loser.params["head"], **LOOSE)
        loser.close()                   # shared mode: must NOT unregister
        assert router.has_endpoint("lm-head")
        winner.close()
        assert not router.has_endpoint("lm-head")
    finally:
        router.close()


# ---------------------------------------------------------------------------
# Lifecycle and knobs
# ---------------------------------------------------------------------------


def test_close_is_idempotent_and_leaks_nothing(operands, plan):
    A, xs = operands
    router = Router()
    router.register("head", plan, replicas=2, n_workers=6)
    futs = [router.submit("head", xs[i]) for i in range(4)]
    router.close()
    router.close()
    for f in futs:                      # drained, not dropped
        assert f.result(1) is not None
    assert wait_until(lambda: leftover_threads() == [])
    with pytest.raises(RuntimeError):
        router.submit("head", xs[0])


def test_unregister_scoped_to_endpoint(operands, plan):
    A, xs = operands
    with Router() as router:
        router.register("head", plan, replicas=1, n_workers=6)
        router.register("aux", plan, replicas=1, n_workers=6)
        router.call("head", xs[0])
        router.unregister("head")
        assert router.endpoints() == ["aux"]
        with pytest.raises(ValueError, match="no endpoint"):
            router.submit("head", xs[0])
        np.testing.assert_allclose(router.call("aux", xs[0]).numpy(),
                                   (xs[0] @ A).numpy(), **LOOSE)


def test_external_fleets_survive_router_close(operands, plan):
    A, xs = operands
    with CodedFleet(6, device="cpu") as fleet:
        router = Router()
        router.register("head", plan, fleets=[fleet])
        np.testing.assert_allclose(router.call("head", xs[0]).numpy(),
                                   (xs[0] @ A).numpy(), **LOOSE)
        router.close()
        h = fleet.attach(plan)          # not closed by the router
        np.testing.assert_allclose(h.matvec(xs[0]).numpy(),
                                   (xs[0] @ A).numpy(), **LOOSE)


def test_owned_fleets_follow_the_plan(operands):
    """A replica fleet the router creates computes where its plan lives:
    host workers for a host plan, the card path for a ``cuda`` plan (its
    plain version here, on CPU tensors); a card plan without a card
    raises instead of falling back to host workers."""
    A, _ = operands
    with Router() as router:
        router.register("host", port_plan(A), n_workers=6)
        router.register("card", port_plan(A, "cuda"), n_workers=6)
        kinds = {name: [(r.fleet.backend, r.fleet.device.type)
                        for r in router._endpoints[name].replicas]
                 for name in ("host", "card")}
    assert kinds == {"host": [("packed", "cpu")], "card": [("cuda", "cpu")]}


@pytest.mark.parametrize("var,value,fn", [
    ("REPRO_ROUTER_BALANCER", "fastest", "default_balancer"),
    ("REPRO_ROUTER_QUEUE_CAP", "bogus", "default_queue_cap"),
    ("REPRO_ROUTER_QUEUE_CAP", "0", "default_queue_cap"),
    ("REPRO_ROUTER_MAX_COLS", "-1", "default_max_cols"),
])
def test_env_knob_errors_match_reference(monkeypatch, var, value, fn):
    """A mis-set knob fails with the JAX package's message, naming it;
    the router itself refuses a bad balancer at construction."""
    monkeypatch.setenv(var, value)
    errors = []
    for pkg in (ref_serve, port_serve):
        with pytest.raises(ValueError) as ei:
            getattr(pkg, fn)()
        errors.append(str(ei.value))
    assert errors[0] == errors[1] and var in errors[0]
    if fn == "default_balancer":
        with pytest.raises(ValueError, match=var):
            Router()
    monkeypatch.delenv(var)
    assert default_balancer() == "least-loaded"
    assert default_queue_cap() == 256
