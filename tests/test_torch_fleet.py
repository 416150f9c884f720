"""The port's fleet sessions (``repro_torch.api.fleet.CodedFleet``) and the
serve engine's cluster and fleet modes: two plans on one worker set,
microbatched rounds that decode bitwise like solo ones, elastic
membership, the availability floor, the re-encode cut, and the engine
against its in-process self and the JAX package's engine in cluster
mode.

No assertion is paced by wall-clock timing, and every wait has its own
timeout."""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
import repro.models as ref_models
import repro.serve as ref_serve
import repro_torch.configs as port_configs
from repro_torch.api import compile_plan
from repro_torch.api.fleet import CodedFleet, FleetDegraded
from repro_torch.cluster import FailStop
from repro_torch.convert import model_params_from_reference
from repro_torch.models import build_model
from repro_torch.serve import ServeEngine

TOL = dict(rtol=2e-5, atol=2e-5)
LOOSE = dict(rtol=5e-3, atol=5e-3)
CPU = torch.device("cpu")


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


def no_new_threads(before: set, timeout: float = 10.0) -> bool:
    """Every thread started since ``before`` was taken has ended."""
    return wait_until(lambda: not set(threading.enumerate()) - before,
                      timeout)


@pytest.fixture(scope="module")
def operands():
    rng = np.random.default_rng(3)
    A = torch.from_numpy(block_sparse(rng, 256, 144, 0.9))
    A2 = torch.from_numpy(block_sparse(rng, 256, 96, 0.9))
    xs = torch.from_numpy(rng.standard_normal((8, 256)).astype(np.float32))
    return A, A2, xs


def plan_of(A, **kw):
    kw = {"scheme": "proposed", "n": 6, "s": 2, **kw}
    return compile_plan(A, backend="packed", device="cpu", **kw)


@pytest.fixture(scope="module")
def pipe_fleet():
    fleet = CodedFleet(3, transport="pipe", device="cpu", max_inflight=4)
    try:
        yield fleet
    finally:
        fleet.close()


@pytest.mark.parametrize("transport", ["memory", "pipe"])
def test_two_plans_interleaved_bitwise(operands, pipe_fleet, transport):
    """Rounds of two attached plans in flight together, demuxed by (plan,
    round): each bitwise its in-process plan under its mask."""
    A, A2, xs = operands
    p1, p2 = plan_of(A), plan_of(A2, scheme="cyclic31")
    masks = [np.roll([True] * 4 + [False] * 2, i) for i in range(6)]
    fleet = pipe_fleet if transport == "pipe" else CodedFleet(
        6, device="cpu", max_inflight=4)
    try:
        h1, h2 = fleet.attach(p1), fleet.attach(p2)
        futs = []
        for i, done in enumerate(masks):
            futs.append((p1, i, done, h1.submit_matvec(xs[i], done)))
            futs.append((p2, i, done, h2.submit_matvec(xs[i], done)))
        for plan, i, done, fut in futs:
            assert torch.equal(fut.result(timeout=60),
                               plan.matvec(xs[i], done))
        assert len(h1.reports) == len(h2.reports) == len(masks)
        assert all(r.deaths == r.requeues == 0 for r in h1.reports)
        h1.detach()
        h2.detach()
    finally:
        if fleet is not pipe_fleet:
            fleet.close()


def test_microbatched_round_decodes_like_solo_rounds(operands):
    """A packed group is one round; every call's slice decodes bitwise as
    the same call alone under the round's pattern, and racing rounds
    decode bitwise as the in-process plan under the observed pattern."""
    A, _, xs = operands
    plan = plan_of(A)
    with CodedFleet(6, device="cpu", max_inflight=2) as fleet:
        h = fleet.attach(plan)
        futs = h.submit_matvec_many([xs[i] for i in range(4)])
        outs = [f.result(timeout=60) for f in futs]
        rep = futs[0].report
        assert rep.calls == 4 and all(f.report is rep for f in futs)
        for i, out in enumerate(outs):
            assert torch.equal(out, plan.matvec(xs[i], rep.pattern))
            assert torch.equal(out, h.matvec(xs[i], rep.pattern))
        futs = [h.submit_matvec(xs[i]) for i in range(4, 8)]
        outs = [f.result(timeout=60) for f in futs]
        for i, (out, f) in zip(range(4, 8), zip(outs, futs)):
            assert torch.equal(out, plan.matvec(xs[i], f.report.pattern))


def test_matmat_and_aggregate_futures():
    rng = np.random.default_rng(5)
    A = torch.from_numpy(block_sparse(rng, 144, 72, 0.9))
    B = torch.from_numpy(block_sparse(rng, 144, 48, 0.9))
    mm = compile_plan(A, scheme="proposed", n=12, k_A=3, k_B=3,
                      backend="packed", device="cpu")
    agg = compile_plan(scheme="proposed", n=6, s=2, device="cpu")
    payloads = [{"g": torch.from_numpy(rng.standard_normal(16).astype(
        np.float32))} for _ in range(6)]
    with CodedFleet(12, device="cpu", max_inflight=4) as fleet:
        hm, ha = fleet.attach(mm), fleet.attach(agg)
        done = np.ones(12, bool)
        fm = hm.submit_matmat(B, done)
        fa = ha.submit_aggregate(payloads, done[:6])
        assert torch.equal(fm.result(timeout=60), mm.matmat(B, done))
        torch.testing.assert_close(fa.result(timeout=60)["g"],
                                   agg.aggregate(payloads, done[:6])["g"],
                                   **TOL)


def test_add_and_remove_workers(operands):
    A, _, xs = operands
    plan = plan_of(A)
    with CodedFleet(6, device="cpu") as fleet:
        h = fleet.attach(plan)
        h.matvec(xs[0])
        joiner = fleet.add_worker(timeout=60)
        assert joiner == 6 and joiner in fleet.live_workers()
        assert "join" in [e["kind"] for e in fleet.event_log]
        assert wait_until(lambda: any(
            o == joiner for ps in fleet._plans.values()
            for o in ps.owner.values()))
        done = np.ones(6, bool)
        assert torch.equal(h.matvec(xs[1], done), plan.matvec(xs[1], done))
        # the re-encode cuts by the measured throughput EWMAs; with none
        # the survivors are equal and the cut is uniform (n = 5), which
        # timing noise in the measured ones would not guarantee
        fleet._rate.clear()
        fleet.remove_worker(joiner, drain=True)
        fleet.remove_worker(5, drain=True)
        assert 5 not in fleet.live_workers()
        kinds = [e["kind"] for e in fleet.event_log]
        assert "leave" in kinds and "death" not in kinds
        # resilience shrank before availability: k preserved
        assert wait_until(lambda: h.plan.n == 5)
        assert (h.plan.k, h.plan.s) == (4, 1)
        np.testing.assert_allclose(h.matvec(xs[2]).numpy(),
                                   (xs[2] @ A).numpy(), **LOOSE)
        assert all(r.deaths == 0 for r in h.reports)
        assert fleet.metrics()["n_live"] == 5


def test_floor_fails_fast(operands):
    A, _, xs = operands
    plan = plan_of(A)
    with CodedFleet(6, device="cpu", min_workers=3,
                    faults=FailStop({w: 0 for w in range(5)})) as fleet:
        h = fleet.attach(plan)
        with pytest.raises(FleetDegraded, match="min_workers"):
            h.matvec(xs[0], deadline=30.0)
        with pytest.raises(FleetDegraded, match="add_worker"):
            h.submit_matvec(xs[1])
        assert "degraded-floor" in [e["kind"] for e in fleet.event_log]
    with CodedFleet(1, device="cpu") as fleet:
        h = fleet.attach(plan)
        with pytest.raises(FleetDegraded, match="add a worker"):
            fleet.remove_worker(0)
        np.testing.assert_allclose(h.matvec(xs[1]).numpy(),
                                   (xs[1] @ A).numpy(), **LOOSE)


def test_reencode_cut_follows_worker_capacities(operands):
    """With per-worker rates given, a worker loss re-encodes the plan for
    the survivors with ``proposed-hetero`` over the capacities
    ``worker_capacities(rates=)`` gives them: the slow worker owns the
    fewest rows of the new encoding."""
    A, _, xs = operands
    plan = plan_of(A, n=12, s=4)
    rates = {0: 0.25, 1: 1.0, 2: 1.0, 3: 1.0, 4: 1.0, 5: 1.0}
    with CodedFleet(6, device="cpu") as fleet:
        h = fleet.attach(plan)
        h.matvec(xs[0])
        assert fleet.worker_capacities([0, 1, 2], rates={0: 4.0, 1: 1.0,
                                                         2: 2.0}) == [4, 1, 2]
        caps = fleet.worker_capacities([0, 1, 2, 3, 4], rates=rates)
        assert caps == [1, 4, 4, 4, 4]
        fleet._rate.clear()
        fleet._rate.update(rates)
        pid0 = h.plan_id
        fleet.remove_worker(5, drain=True)
        assert wait_until(lambda: h.plan_id != pid0)
        assert h.plan.scheme.name == "proposed-hetero"
        total = sum(caps)
        virt = [max(1, round(c * 10 / total)) for c in caps]
        assert h.plan.n == sum(virt)
        owned = {w: 0 for w in fleet.live_workers()}
        for o in h._ps.owner.values():
            owned[o] += 1
        assert owned == {w: v for w, v in zip(range(5), virt)}
        assert h.plan_version(pid0).n == 12
        np.testing.assert_allclose(h.matvec(xs[1]).numpy(),
                                   (xs[1] @ A).numpy(), **LOOSE)


def test_close_leaves_no_threads(operands):
    A, _, xs = operands
    before = set(threading.enumerate())
    with CodedFleet(6, device="cpu") as fleet:
        fleet.attach(plan_of(A)).matvec(xs[0])
    assert no_new_threads(before)
    with pytest.raises(RuntimeError, match="closed"):
        fleet.attach(plan_of(A))


# ---------------------------------------------------------------------------
# The serve engine's cluster and fleet modes
# ---------------------------------------------------------------------------


def engines(**coded):
    """(JAX engine in cluster mode, port engine with ``coded``, port
    in-process engine) on the same phi3-mini smoke weights."""
    cfg = ref_configs.get_smoke_config("phi3-mini-3.8b")
    jm = ref_models.build_model(cfg, dtype=jnp.float32)
    jp = jm.init(jax.random.key(0))
    pcfg = port_configs.get_smoke_config("phi3-mini-3.8b")
    pm = build_model(pcfg, torch.float32, device=CPU)
    sd = model_params_from_reference(jax.tree.map(np.asarray, jp), pcfg,
                                     device=CPU)
    base = dict(enabled=True, n_workers=6, stragglers=2, backend="packed")
    ref = ref_serve.ServeEngine(
        jm, jp, cfg, batch_size=2, max_len=32,
        coded=ref_configs.base.CodedConfig(**base, cluster=True,
                                           transport="memory"))
    port = ServeEngine(pm, sd, pcfg, batch_size=2, max_len=32,
                       coded=port_configs.base.CodedConfig(**base, **coded))
    local = ServeEngine(pm, sd, pcfg, batch_size=2, max_len=32,
                        coded=port_configs.base.CodedConfig(**base))
    return ref, port, local, pcfg


@pytest.mark.parametrize("mode", ["cluster", "fleet"])
def test_engine_cluster_and_fleet_modes(mode):
    """coded_logits in cluster / fleet mode: bitwise the in-process
    engine's (host workers), within f32 tolerance of the JAX package's
    engine in cluster mode; close() releases the workers (cluster) or
    only detaches (fleet)."""
    before = set(threading.enumerate())
    fleet = CodedFleet(6, device="cpu") if mode == "fleet" else None
    try:
        coded = {"fleet": fleet} if fleet else {"cluster": True,
                                                "transport": "memory"}
        ref, port, local, cfg = engines(**coded)
        assert port.coded_cluster is not None
        rng = np.random.default_rng(0)
        hidden = rng.standard_normal((2, cfg.d_model)).astype(np.float32)
        h = torch.from_numpy(hidden)
        for i in range(5):
            done = np.ones(6, bool)
            done[[i, (i + 2) % 6]] = False
            got = port.coded_logits(h, done)
            assert got.dtype == torch.float32 and got.shape == (2, cfg.vocab)
            assert torch.equal(got, local.coded_logits(h, done))
            np.testing.assert_allclose(
                got.numpy(),
                np.asarray(ref.coded_logits(jnp.asarray(hidden),
                                            jnp.asarray(done))), **TOL)
            rep = port.coded_cluster.last_report
            assert (rep.deaths, rep.requeues) == (0, 0)
        head = port.params["head"]
        torch.testing.assert_close(port.coded_logits(h), h @ head, **LOOSE)
        port.close()
        ref.close()
        assert port.coded_cluster is None
        if fleet is not None:
            # detached only: the fleet serves its other consumers
            other = fleet.attach(plan_of(head[:, :64].contiguous()))
            torch.testing.assert_close(other.matvec(h), h @ head[:, :64],
                                       **LOOSE)
    finally:
        if fleet is not None:
            fleet.close()
    assert no_new_threads(before), set(threading.enumerate()) - before
