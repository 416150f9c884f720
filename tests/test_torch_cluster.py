"""The port's cluster (``repro_torch.cluster``: worker, memory and pipe
transports, dispatcher) against its own in-process plans and the JAX
package's cluster: the C(6, 2) parity sweep, matmat, aggregate, partial
stragglers, fail-stop requeue, hangs caught by heartbeat, the card
worker path (``bcsr_matmul``'s plain version here) and shutdown hygiene.

No assertion is paced by wall-clock timing, and every wait has its own
timeout."""

import itertools
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import compile_plan as ref_compile
from repro_torch.api import compile_plan
from repro_torch.cluster import (
    ClusterPlan,
    FailStop,
    Hang,
    StragglerFaults,
    make_transport,
    resolve_transport,
    shard_plan,
)
from repro_torch.cluster.fleet import CodedFleet
from repro_torch.cluster.wire import Task, plan_packed
from repro_torch.cluster.worker import ShardRuntime

TOL = dict(rtol=2e-5, atol=2e-5)
LOOSE = dict(rtol=5e-3, atol=5e-3)
CPU = torch.device("cpu")


def block_sparse(rng, t, r, zeros, bs=8):
    mask = rng.random((t // bs, r // bs)) >= zeros
    a = rng.standard_normal((t, r)).astype(np.float32)
    return a * np.kron(mask, np.ones((bs, bs), np.float32))


def all_straggler_masks(n, s):
    for pat in itertools.combinations(range(n), s):
        done = np.ones(n, bool)
        done[list(pat)] = False
        yield done


def port_plan(A, backend="packed", **kw):
    kw = kw or {"n": 6, "s": 2}
    return compile_plan(torch.from_numpy(A), scheme=kw.pop("scheme",
                                                           "proposed"),
                        backend=backend, device="cpu", **kw)


def wait_until(pred, timeout=10.0):
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < timeout:
        if pred():
            return True
        time.sleep(0.02)
    return pred()


@pytest.fixture(scope="module")
def operand():
    rng = np.random.default_rng(0)
    A = block_sparse(rng, 256, 144, 0.9)
    x = rng.standard_normal((3, 256)).astype(np.float32)
    return A, x


@pytest.fixture(scope="module")
def ref_results(operand):
    """The JAX package's cluster over the same operand: the C(6, 2)
    sweep's results, by straggler pattern."""
    A, x = operand
    plan = ref_compile(jnp.asarray(A), scheme="proposed", n=6, s=2,
                       backend="packed")
    with plan.to_cluster(transport="memory") as cl:
        return {done.tobytes(): np.asarray(cl.matvec(jnp.asarray(x), done))
                for done in all_straggler_masks(6, 2)}


@pytest.fixture(scope="module")
def pipe_clusters(operand):
    """One host-worker and one card-worker (plain version) pipe cluster,
    shared by the tests of this module: three processes each, every one
    hosting two of the six coded rows."""
    A, _ = operand
    host, card = port_plan(A), port_plan(A, "cuda")
    clusters = []
    try:
        for plan in (host, card):
            clusters.append(plan.to_cluster(3, transport="pipe"))
        yield {"packed": (host, clusters[0]), "cuda": (card, clusters[1])}
    finally:
        for cl in clusters:
            cl.shutdown()


def sweep(plan, cl, x, ref_results, bitwise):
    for done in all_straggler_masks(6, 2):
        got = cl.matvec(x, done)
        rep = cl.last_report
        assert (rep.deaths, rep.requeues, rep.n_done) == (0, 0, plan.k)
        assert got.dtype == torch.float32 and got.device == CPU
        want = plan.matvec(torch.from_numpy(x), done)
        if bitwise:
            # host workers: the JAX package's arithmetic throughout
            assert torch.equal(got, want)
            np.testing.assert_allclose(got.numpy(),
                                       ref_results[done.tobytes()], **TOL)
        else:
            torch.testing.assert_close(got, want, **TOL)


@pytest.mark.parametrize("backend", ["packed", "cuda"])
@pytest.mark.parametrize("transport", ["memory", "pipe"])
def test_parity_sweep(operand, ref_results, pipe_clusters, transport,
                      backend):
    """Every C(6, 2) explicit mask: on host workers bitwise the port's
    in-process plan and within f32 tolerance of the JAX package's
    cluster; on card workers within f32 tolerance of the in-process
    ``cuda`` plan."""
    A, x = operand
    if transport == "pipe":
        plan, cl = pipe_clusters[backend]
        sweep(plan, cl, x, ref_results, backend == "packed")
        return
    plan = port_plan(A, backend)
    with plan.to_cluster(transport=transport) as cl:
        assert cl.transport_name == transport
        assert cl.fleet.backend == backend
        sweep(plan, cl, x, ref_results, backend == "packed")


@pytest.mark.parametrize("backend", ["packed", "cuda"])
def test_pipe_children_report_themselves(operand, pipe_clusters, backend):
    """Each pipe child answers on the control channel with its own pid,
    its compute backend and its launch counts; on the CPU no kernel
    launches (the card path runs ``bcsr_matmul``'s plain version)."""
    A, x = operand
    plan, cl = pipe_clusters[backend]
    cl.matvec(x, next(all_straggler_masks(6, 2)))
    reports = cl.transport.reports(timeout=30.0)
    procs = cl.transport._procs
    assert sorted(reports) == sorted(procs) == [0, 1, 2]
    for w, rep in reports.items():
        assert rep["pid"] == procs[w].pid
        assert (rep["device"], rep["backend"]) == ("cpu", backend)
        assert rep["launches"] == {"bcsr_matmul": 0, "cyclic_encode": 0,
                                   "decode_matmul": 0,
                                   "mla_decode_attention": 0,
                                   "held_expert_ffn": 0}
        assert (rep["device_name"], rep["memory_allocated"]) == (None, 0)


@pytest.mark.parametrize("kind", ["mv", "mm"])
def test_card_worker_path_matches_host_path(operand, kind):
    """The card worker's re-tiled 32x32 form times the operand
    (``bcsr_matmul``'s plain version on CPU) equals the scipy BSR path
    within f32 tolerance, task by task, dense and support-restricted."""
    A, _ = operand
    rng = np.random.default_rng(7)
    plan = port_plan(A) if kind == "mv" else port_plan(A, n=6, k_A=2, k_B=2)
    host, card = ShardRuntime(), ShardRuntime(CPU, "cuda")
    for shard in shard_plan(plan, 3, plan_id=4):
        host.load(shard)
        card.load(shard)
        for j, row in enumerate(shard.task_rows):
            b = rng.standard_normal((shard.t_pad, 5)).astype(np.float32)
            kb = np.asarray(shard.supports[j][:2], np.int32)
            bx = b.reshape(-1, shard.bk, 5)[kb].reshape(-1, 5)
            for payload in ({"b": b}, {"bx": bx, "bi": kb}):
                task = Task(round=1, op="matvec", task_row=row, plan=4,
                            payload=payload)
                (y_h, w_h, c_h), (y_c, w_c, c_c) = host.run(task), \
                    card.run(task)
                assert (w_h, c_h) == (w_c, c_c)
                assert y_c["y"].shape == y_h["y"].shape == (shard.c_pad, 5)
                np.testing.assert_allclose(y_c["y"], y_h["y"], **TOL)
    with pytest.raises(ValueError, match="worker backend"):
        ShardRuntime(CPU, "reference")


def test_matmat_patterns(operand):
    A, _ = operand
    rng = np.random.default_rng(6)
    B = block_sparse(rng, 256, 24, 0.5)
    plan = port_plan(A, n=6, k_A=2, k_B=2)
    ref = ref_compile(jnp.asarray(A), scheme="proposed", n=6, k_A=2, k_B=2,
                      backend="packed")
    card = port_plan(A, "cuda", n=6, k_A=2, k_B=2)
    with plan.to_cluster() as cl, ref.to_cluster() as ref_cl, \
            card.to_cluster() as card_cl:
        for done in itertools.islice(all_straggler_masks(6, 2), 6):
            want = plan.matmat(torch.from_numpy(B), done)
            got = cl.matmat(B, done)
            assert torch.equal(got, want)
            np.testing.assert_allclose(
                got.numpy(), np.asarray(ref_cl.matmat(jnp.asarray(B), done)),
                **TOL)
            torch.testing.assert_close(card_cl.matmat(B, done),
                                       card.matmat(torch.from_numpy(B), done),
                                       **TOL)
            assert cl.last_report.requeues == card_cl.last_report.requeues == 0
        race = cl.matmat(torch.from_numpy(B))
    np.testing.assert_allclose(race.numpy(), A.T @ B, **LOOSE)


def test_aggregate_and_trees():
    """Coded gradients (worker i holds sum_q G[i, q] g_q, as a dict /
    list tree with a bf16 leaf) sum like the in-process plan's aggregate
    under an explicit mask, and to sum_q g_q when racing."""
    rng = np.random.default_rng(3)
    agg = compile_plan(scheme="proposed", n=6, s=2, device="cpu")
    G = torch.from_numpy(agg.G.astype(np.float32))
    grads = [torch.from_numpy(rng.standard_normal(17).astype(np.float32))
             for _ in range(agg.k)]
    coded = [sum(G[i, q] * grads[q] for q in range(agg.k)) for i in range(6)]
    payloads = [{"w": c[:12].reshape(4, 3),
                 "rest": [c[12:], c[:2].to(torch.bfloat16)]} for c in coded]
    flat = [{"w": p["w"], "rest": [p["rest"][0], p["rest"][1].float()]}
            for p in payloads]
    total = sum(grads)
    done = np.ones(6, bool)
    done[[1, 4]] = False
    want = agg.aggregate(flat, done)
    with agg.to_cluster() as cl:
        got = cl.aggregate(payloads, done)
        assert set(got) == {"w", "rest"} and len(got["rest"]) == 2
        for g, w in ((got["w"], want["w"]), (got["rest"][0], want["rest"][0]),
                     (got["rest"][1], want["rest"][1])):
            torch.testing.assert_close(g, w, **TOL)
        race = cl.aggregate(payloads)
        torch.testing.assert_close(race["w"].reshape(-1), total[:12],
                                   **LOOSE)
        torch.testing.assert_close(race["rest"][0], total[12:], **LOOSE)


def test_partial_stragglers(operand):
    """Task-level masks and fewer hosts than virtual workers: hosts that
    finish a strict subset of their rows are reported, the result is
    bitwise the in-process plan's."""
    A, x = operand
    xt = torch.from_numpy(x)
    plan = port_plan(A, scheme="scs36", n=6, k_A=4)
    assert plan.tasks_per_worker == 3
    task_done = np.ones(plan.n_tasks, bool)
    task_done[[2, 4, 5]] = False        # w0 loses row 2, w1 rows 4, 5
    with plan.to_cluster() as cl:
        got = cl.matvec(x, task_done)
        assert {0, 1} <= set(cl.last_report.partial_workers)
    assert torch.equal(got, plan.matvec(xt, task_done))
    plan = port_plan(A)
    done = np.ones(6, bool)
    done[[3, 4]] = False
    with plan.to_cluster(4) as cl:      # hosts own {0,4}, {1,5}, {2}, {3}
        got = cl.matvec(x, done)
        assert cl.n_workers == 4
        assert cl.last_report.partial_workers == (0,)
        assert torch.equal(got, plan.matvec(xt, done))
    with plan.to_cluster(3) as cl:      # hosts own {0,3}, {1,4}, {2,5}
        got = cl.matvec(x, done)
        assert cl.last_report.partial_workers == (0, 1)
        assert torch.equal(got, plan.matvec(xt, done))


def test_failstop_requeues_and_recovers(operand):
    A, x = operand
    plan = port_plan(A, n=6, s=1)
    want = x @ A
    # two deaths leave 4 live hosts < k = 5: the decode needs a requeue
    with plan.to_cluster(faults=FailStop({0: 0, 3: 0})) as cl:
        got = cl.matvec(x)
        rep = cl.last_report
        assert rep.deaths == 2 and rep.requeues >= 1
        np.testing.assert_allclose(got.numpy(), want, **LOOSE)
        got = cl.matvec(x)
        assert cl.last_report.deaths == 0
        np.testing.assert_allclose(got.numpy(), want, **LOOSE)
    with plan.to_cluster(faults=FailStop({w: 0 for w in range(6)})) as cl:
        with pytest.raises(RuntimeError, match="dead"):
            cl.matvec(x)


def test_call_built_across_a_reencode_is_rebuilt(operand):
    """A matvec whose build on the caller's thread straddles the loop's
    re-encode (forced here: the re-encode waits for the build to start,
    the build waits for the re-encode to land) is rebuilt for the new
    geometry at launch, not decoded with the old one."""
    A, x = operand
    plan = port_plan(A, n=6, s=1)
    want = x @ A
    build_started, reencoded = threading.Event(), threading.Event()
    with plan.to_cluster(faults=FailStop({0: 0, 3: 0})) as cl:
        fleet, armed = cl.fleet, []
        real_reencode = fleet._reencode

        def reencode(ps):
            assert build_started.wait(30.0)
            try:
                real_reencode(ps)
            finally:
                reencoded.set()

        def alloc_operand(shape, dtype):
            if armed and not build_started.is_set():
                build_started.set()
                assert reencoded.wait(30.0)
            return None

        fleet._reencode = reencode
        fleet.transport.alloc_operand = alloc_operand
        # even capacities: the re-encode keeps k = min(k, live hosts)
        # (rates measured under load could cut a proposed-hetero code
        # that keeps k)
        fleet.worker_capacities = lambda ws=None, levels=4, rates=None: \
            [1] * len(ws if ws is not None else fleet.live_workers())
        cl.matvec(x)
        k0 = cl.handle._ps.plan.k
        armed.append(True)
        got = cl.matvec(x)
        assert reencoded.is_set() and cl.handle._ps.plan.k < k0
        np.testing.assert_allclose(got.numpy(), want, **LOOSE)


def test_hang_caught_by_heartbeat(operand):
    """Two silent workers (no result, no beat, channel open) with k = 5
    of 6: only the heartbeat timeout can free the decode."""
    A, x = operand
    plan = port_plan(A, n=6, s=1)
    # a second of silence before suspicion: a healthy worker on a loaded
    # machine keeps beating well inside it
    with plan.to_cluster(faults=Hang({0: 0, 3: 0}), heartbeat_s=0.05,
                         suspect_after=1.0) as cl:
        got = cl.matvec(x)
        rep = cl.last_report
        assert 1 <= rep.suspected <= 2
        assert rep.deaths == 0 and rep.requeues >= 1
        np.testing.assert_allclose(got.numpy(), x @ A, **LOOSE)
        got = cl.matvec(x)
        assert cl.last_report.suspected == 0
        np.testing.assert_allclose(got.numpy(), x @ A, **LOOSE)


def test_race_mode_accounting_and_shutdown(operand):
    """Racing under latency faults stays right; task traffic is
    support-restricted; closing joins every thread the cluster started."""
    A, x = operand
    plan = port_plan(A)
    before = set(threading.enumerate())
    with plan.to_cluster(faults=StragglerFaults(time_scale=2e-3,
                                                seed=11)) as cl:
        for _ in range(3):
            np.testing.assert_allclose(cl.matvec(x).numpy(), x @ A, **LOOSE)
            rep = cl.last_report
            assert rep.n_done >= plan.k and rep.deaths == 0
            assert 0 < rep.bytes_tasks <= rep.bytes_tasks_dense
            assert rep.bytes_results > 0
        assert cl.matvec(x[0]).shape == (plan.r,)
        with pytest.raises(ValueError, match="need at least k"):
            cl.matvec(x, np.zeros(6, bool))
        with pytest.raises(ValueError, match="matmat needs an mm"):
            cl.matmat(x)
        totals = cl.wire_totals()
        assert totals["bytes_shards"] == cl.bytes_shards > 0
    assert wait_until(lambda: not (set(threading.enumerate()) - before),
                      timeout=10.0)


def test_transports_and_worker_placement(operand, monkeypatch):
    """Every transport resolves, tcp and shm included; a card plan needs
    card workers and a host plan host workers; a fleet with no device
    asks for the card."""
    A, _ = operand
    assert resolve_transport(None) == "memory"
    assert resolve_transport("pipe") == "pipe"
    monkeypatch.setenv("REPRO_CLUSTER_TRANSPORT", "pipe")
    assert resolve_transport(None) == "pipe"
    assert resolve_transport("memory") == "memory"
    for name in ("tcp", "shm"):
        assert resolve_transport(name) == name
        assert make_transport(name, 2).name == name
    for name in ("carrier-pigeon", "process"):
        with pytest.raises(ValueError, match="transport"):
            resolve_transport(name)
    monkeypatch.delenv("REPRO_CLUSTER_TRANSPORT")
    with CodedFleet(2, device="cpu") as fleet:
        assert (fleet.backend, fleet.transport.backend) == ("packed",
                                                            "packed")
        with pytest.raises(ValueError, match="needs cuda workers"):
            fleet.attach(port_plan(A, "cuda"))
    with CodedFleet(2, device="cpu", backend="cuda") as fleet:
        with pytest.raises(ValueError, match="needs packed workers"):
            fleet.attach(port_plan(A))
    with ClusterPlan(port_plan(A, "cuda"), 2) as cl:
        assert (cl.fleet.backend, cl.fleet.device) == ("cuda", CPU)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            CodedFleet(2)


def test_shards_and_packing_for_card_plans(operand):
    """A card plan ships 8x8 shards like a host plan: the same BSR
    components, the same supports."""
    A, _ = operand
    host, card = port_plan(A), port_plan(A, "cuda")
    assert card.executor.packed.bk == 32 and plan_packed(card).bk == 8
    for a, b in zip(shard_plan(host, 3), shard_plan(card, 3)):
        assert a.supports == b.supports and a.work == b.work
        for ta, tb in zip(a.tasks, b.tasks):
            np.testing.assert_array_equal(ta["indices"], tb["indices"])
            np.testing.assert_allclose(ta["data"], tb["data"], **TOL)
        kb = a.t_pad // a.bk
        for sup, task in zip(a.supports, a.tasks):
            assert sorted(sup) == sorted(set(task["indices"].tolist()))
            assert all(0 <= j < kb for j in sup)
