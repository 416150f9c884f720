"""The port's tcp and shm transports and its remote worker
(``repro_torch.cluster.transport.{tcp,shm}``,
``python -m repro_torch.cluster.worker --connect``) against the port's
in-process plans and the JAX package's cluster: the C(6, 2) parity
sweep, the children's own reports, shm's zero-copy task path and
segment lifecycle, tcp's handshake, liveness, shard digests and
teardown, and a remote worker joining a coordinator that spawns none.

Clusters shared by several tests are module fixtures with three
children each.  No assertion is paced by wall-clock timing, and every
wait has its own timeout."""

import gc
import hashlib
import itertools
import json
import os
import signal
import socket
import struct
import subprocess
import sys
import threading
import time
import warnings
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import compile_plan as ref_compile
from repro_torch.api import compile_plan
from repro_torch.cluster import Hang, make_transport, resolve_transport
from repro_torch.cluster.fleet import CodedFleet
from repro_torch.cluster.wire import WIRE_VERSION, Task, encode_record

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=2e-5, atol=2e-5)
# racing decodes against x @ A: the JAX package's cluster tests' tolerance
LOOSE = dict(rtol=5e-3, atol=5e-3)
CPU = torch.device("cpu")
NO_LAUNCHES = {"bcsr_matmul": 0, "cyclic_encode": 0, "decode_matmul": 0,
               "mla_decode_attention": 0, "held_expert_ffn": 0}
# a suspicion timeout no load reaches: tests of death notices must see
# only the deaths they cause, not a loaded child's late heartbeats
# failed on suspicion (the default is 2 s)
NO_SUSPICION = dict(suspect_after=3600.0)


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
    return compile_plan(torch.from_numpy(A), scheme="proposed",
                        backend=backend, device="cpu", **kw)


def wait_until(pred, timeout=10.0):
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < timeout:
        if pred():
            return True
        time.sleep(0.02)
    return pred()


def own_shm_segments(transport):
    """/dev/shm entries created by one shm transport."""
    return {e for e in os.listdir("/dev/shm")
            if e.startswith(transport.prefix)}


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
def clusters(operand):
    """A host-worker and a card-worker (plain version) cluster on each of
    tcp and shm, three children each, every one hosting two of the six
    coded rows."""
    A, _ = operand
    plans = {"packed": port_plan(A), "cuda": port_plan(A, "cuda")}
    out = {}
    try:
        for transport in ("tcp", "shm"):
            for backend, plan in plans.items():
                out[transport, backend] = (
                    plan, plan.to_cluster(3, transport=transport))
        yield out
    finally:
        for _, cl in out.values():
            cl.shutdown()


@pytest.mark.parametrize("backend", ["packed", "cuda"])
@pytest.mark.parametrize("transport", ["tcp", "shm"])
def test_parity_sweep(operand, ref_results, clusters, transport, backend):
    """Every C(6, 2) explicit mask: on host workers bitwise the port's
    in-process plan and within f32 tolerance of the JAX package's
    cluster; on card workers (``bcsr_matmul``'s plain version here)
    within f32 tolerance of the in-process ``cuda`` plan.  Over tcp
    every worker digest-verified its shard and acked the digest."""
    A, x = operand
    plan, cl = clusters[transport, backend]
    assert cl.transport_name == transport
    assert (cl.fleet.backend, cl.transport.backend) == (backend, backend)
    if transport == "tcp":
        want_acks = {w: hashlib.sha256(blob).hexdigest()
                     for w, blob in enumerate(cl._shard_bytes)}
        assert wait_until(lambda: cl.transport.shard_acks == want_acks)
    for done in all_straggler_masks(6, 2):
        got = cl.matvec(x, done)
        rep = cl.last_report
        assert (rep.deaths, rep.requeues, rep.n_done) == (0, 0, plan.k)
        assert got.dtype == torch.float32 and got.device == CPU
        want = plan.matvec(torch.from_numpy(x), done)
        if backend == "packed":
            assert torch.equal(got, want)
            np.testing.assert_allclose(got.numpy(),
                                       ref_results[done.tobytes()], **TOL)
        else:
            torch.testing.assert_close(got, want, **TOL)


@pytest.mark.parametrize("backend", ["packed", "cuda"])
@pytest.mark.parametrize("transport", ["tcp", "shm"])
def test_children_report_themselves(operand, clusters, transport, backend):
    """Each spawned child answers on its control channel (tcp: a pipe
    beside the socket; shm: the pipe itself) with its own pid, its
    compute backend and its launch counts, and its start-up was timed;
    on the CPU no kernel launches."""
    A, x = operand
    plan, cl = clusters[transport, backend]
    cl.matvec(x, next(all_straggler_masks(6, 2)))
    reports = cl.transport.reports(timeout=30.0)
    procs = cl.transport._procs
    assert sorted(reports) == sorted(procs) == [0, 1, 2]
    for w, rep in reports.items():
        assert rep["pid"] == procs[w].pid
        assert (rep["device"], rep["backend"]) == ("cpu", backend)
        assert rep["launches"] == NO_LAUNCHES
        assert (rep["device_name"], rep["memory_allocated"]) == (None, 0)
    startup = cl.transport.startup
    assert sorted(startup) == [0, 1, 2]
    for s in startup.values():
        assert 0 <= s["prepare_s"] and 0 < s["spawn_s"] < s["ready_s"]


def test_transports_resolve_and_take_the_workers_device():
    assert resolve_transport("tcp") == "tcp"
    assert resolve_transport("shm") == "shm"
    for name in ("tcp", "shm"):
        tr = make_transport(name, 2, device="cpu", backend="cuda")
        assert (tr.name, tr.device, tr.backend) == (name, CPU, "cuda")
        with pytest.raises(ValueError, match="worker backend"):
            make_transport(name, 2, backend="reference")


# ---------------------------------------------------------------------------
# shm: zero-copy accounting + segment lifecycle
# ---------------------------------------------------------------------------


def test_shm_zero_copy_task_path(operand):
    """shm task frames carry segment references: the task path copies
    header bytes only, the worker materializes no operand."""
    A, x = operand
    plan = port_plan(A)
    with plan.to_cluster(3, transport="shm") as cl:
        cl.matvec(x)
        rep = cl.last_report
        assert 0 < rep.bytes_copied <= rep.bytes_tasks
        assert rep.bytes_copied < rep.bytes_tasks_dense
        totals = cl.fleet.wire_totals()
        assert totals["bytes_copied_total"] == rep.bytes_copied
        # the transport's own counter also holds the shard staging
        assert totals["transport_bytes_copied"] >= \
            rep.bytes_copied + totals["bytes_shards"]


def test_shm_segments_released_on_close_and_per_round(operand):
    A, x = operand
    plan = port_plan(A)
    with plan.to_cluster(3, transport="shm") as cl:
        tr = cl.transport
        shards = own_shm_segments(tr)
        assert len(shards) == 3             # one shard frame per worker
        for _ in range(3):
            cl.matvec(x)
        # every round's operand and result slab went with its round
        assert wait_until(lambda: own_shm_segments(tr) == shards)
    assert own_shm_segments(tr) == set()


def test_shm_remove_worker_drain_releases_shard_segments(operand):
    A, x = operand
    plan = port_plan(A)
    with CodedFleet(3, transport="shm", device="cpu") as fleet:
        tr = fleet.transport
        h = fleet.attach(plan)
        h.matvec(x)
        assert own_shm_segments(tr)
        fleet.remove_worker(2, drain=True)
        assert not any(key[0] == 2 for key in tr._shard_segs)
        np.testing.assert_allclose(h.matvec(x).numpy(), x @ A, **LOOSE)
    assert own_shm_segments(tr) == set()


def test_shm_worker_crash_leaves_no_segments(operand):
    """SIGKILL mid-run: the coordinator owns every segment, so a
    fail-stop child leaks nothing."""
    A, x = operand
    plan = port_plan(A, n=6, s=1)
    with plan.to_cluster(3, transport="shm", **NO_SUSPICION) as cl:
        tr = cl.transport
        np.testing.assert_allclose(cl.matvec(x).numpy(), x @ A, **LOOSE)
        os.kill(tr._procs[2].pid, signal.SIGKILL)
        assert wait_until(lambda: not tr.alive(2))
        np.testing.assert_allclose(cl.matvec(x).numpy(), x @ A, **LOOSE)
        assert sum(r.deaths for r in cl.reports) == 1
    assert own_shm_segments(tr) == set()


def test_shm_garbled_and_wrong_version_frames_kill_worker(operand):
    """A corrupt frame and a future-wire-version frame are both refused
    with a death notice, and the fleet re-homes the rows."""
    A, x = operand
    plan = port_plan(A)
    with plan.to_cluster(4, transport="shm", **NO_SUSPICION) as cl:
        tr = cl.transport
        tr.garble(1)
        bad = bytearray(Task(round=999, op="matvec", task_row=0,
                             payload={}, meta={}).encode())
        bad[4] = WIRE_VERSION + 1
        tr._send(2, ("task", bytes(bad)))
        assert wait_until(lambda: not tr.alive(1) and not tr.alive(2))
        np.testing.assert_allclose(cl.matvec(x).numpy(), x @ A, **LOOSE)
    assert own_shm_segments(tr) == set()


def test_shm_heir_keeps_its_own_shard_segment(operand):
    """An heir that inherits a dead worker's shard of a plan it already
    serves keeps its own shard's segment; only a re-ship of the same
    shard replaces one.  (Keyed by worker and plan alone, the inherited
    shard released the heir's segment at once, and a child that had not
    mapped it yet died on the missing name: the cause of this file's shm
    tests failing under a loaded run.)"""
    from repro_torch.cluster.wire import shard_plan

    A, _ = operand
    plan = port_plan(A, n=6, s=1)
    own_shard, inherited = (s.encode() for s in shard_plan(plan, 3)[::2])
    tr = make_transport("shm", 2)
    try:
        tr.start()

        def worker0():
            return {key[2]: seg.name for key, seg in tr._shard_segs.items()
                    if key[0] == 0}

        tr.ship_shard(0, own_shard)
        first = worker0()
        tr.ship_shard(0, inherited)
        both = worker0()
        assert len(first) == 1 and len(both) == 2
        assert set(first.values()) < set(both.values()) \
            <= own_shm_segments(tr)
        tr.ship_shard(0, inherited)             # a re-ship replaces
        again = worker0()
        assert len(again) == 2 and again != both
        assert set(first.values()) <= set(again.values())
        assert set(both.values()) - set(first.values()) \
            & own_shm_segments(tr) == set()
        assert 0 in tr.reports(timeout=60) and tr.alive(0)
    finally:
        tr.close()
    assert own_shm_segments(tr) == set()


def test_shm_child_skips_a_released_shard_segment(operand):
    """A shard frame whose segment is already gone (a newer ship of the
    same shard follows it) is skipped: the child keeps serving."""
    from repro_torch.cluster.transport.shm import _REF_META

    A, x = operand
    plan = port_plan(A)
    with plan.to_cluster(3, transport="shm", **NO_SUSPICION) as cl:
        tr = cl.transport
        tr._send(0, ("shard", (_REF_META, tr.prefix + "released", 64)))
        np.testing.assert_allclose(cl.matvec(x).numpy(), x @ A, **LOOSE)
        assert 0 in tr.reports(timeout=60)
        assert tr.alive(0)
        assert sum(r.deaths for r in cl.reports) == 0


# ---------------------------------------------------------------------------
# tcp: liveness, handshake, digests, teardown
# ---------------------------------------------------------------------------


def test_tcp_hang_suspected_and_requeued(operand):
    """A hung child keeps its socket open: only the heartbeat timeout
    catches it (k = 5 of 6 rows, two of them on the hung worker)."""
    A, x = operand
    plan = port_plan(A, n=6, s=1)
    with plan.to_cluster(3, transport="tcp", faults=Hang({1: 0}),
                         heartbeat_s=0.05, suspect_after=1.0) as cl:
        got = cl.matvec(x)
        rep = cl.last_report
        assert rep.suspected >= 1 and rep.requeues >= 1
        assert rep.deaths == 0
        np.testing.assert_allclose(got.numpy(), x @ A, **LOOSE)


def test_tcp_worker_killed_mid_round(operand):
    """A child SIGKILLed between rounds: the dropped connection surfaces
    as a death, its rows are re-homed, the decode is still right."""
    A, x = operand
    plan = port_plan(A, n=6, s=1)
    with plan.to_cluster(3, transport="tcp") as cl:
        np.testing.assert_allclose(cl.matvec(x).numpy(), x @ A, **LOOSE)
        os.kill(cl.transport._procs[2].pid, signal.SIGKILL)
        assert wait_until(lambda: not cl.transport.alive(2))
        np.testing.assert_allclose(cl.matvec(x).numpy(), x @ A, **LOOSE)
        assert sum(r.deaths for r in cl.reports) == 1
        assert 2 not in cl.last_report.completed_per_worker


def test_tcp_wrong_version_handshake_rejected(operand, clusters):
    A, x = operand
    plan, cl = clusters["tcp", "packed"]
    blob = bytearray(encode_record({"record": "hello", "worker": 0}))
    blob[4] = WIRE_VERSION + 1
    with socket.create_connection(("127.0.0.1", cl.transport.port),
                                  timeout=5) as sock:
        sock.sendall(struct.pack("<I", len(blob)) + bytes(blob))
        sock.settimeout(5)
        assert sock.recv(1) == b""          # the server closed on us
    done = next(all_straggler_masks(6, 2))
    assert torch.equal(cl.matvec(x, done),
                       plan.matvec(torch.from_numpy(x), done))


def test_tcp_shard_digest_mismatch_is_a_death_notice(operand):
    """The worker enforces the digest: a shard whose bytes do not match
    the digest it came with ends the worker with a death notice."""
    A, x = operand
    plan = port_plan(A)
    with plan.to_cluster(3, transport="tcp") as cl:
        tr = cl.transport
        seen = []
        push = tr.push_event
        tr.push_event = lambda ev: (seen.append(ev), push(ev))
        blob = cl._shard_bytes[1]
        frame = encode_record({"record": "shard-wrap", "digest": "0" * 64},
                              {"blob": np.frombuffer(blob, np.uint8)})
        assert tr._run_coro(tr._asend(1, frame), timeout=10)
        assert wait_until(lambda: not tr.alive(1))
        deaths = [e for e in seen
                  if getattr(e, "kind", None) == "death" and e.worker == 1]
        assert deaths and "digest mismatch" in deaths[0].error
        assert tr.shard_acks[1] == hashlib.sha256(blob).hexdigest()


def test_tcp_shutdown_releases_sockets_and_threads(operand):
    A, x = operand
    plan = port_plan(A)
    before = set(threading.enumerate())
    with warnings.catch_warnings():
        warnings.simplefilter("error", ResourceWarning)
        with plan.to_cluster(3, transport="tcp") as cl:
            cl.matvec(x)
            procs = list(cl.transport._procs.values())
        gc.collect()                    # unclosed sockets would warn here
    assert all(not p.is_alive() for p in procs)
    assert wait_until(lambda: not (set(threading.enumerate()) - before))


# ---------------------------------------------------------------------------
# Remote workers (python -m repro_torch.cluster.worker --connect)
# ---------------------------------------------------------------------------


def test_remote_workers_join_a_coordinator_that_spawns_none(operand):
    """Two ``--connect --device cpu`` processes dial a ``spawn=False``
    coordinator; the sweep's masks are bitwise the in-process plan, and
    each worker prints its own report when the coordinator stops it.
    ``reports()`` leaves remote workers out: they have no control
    channel."""
    A, x = operand
    plan = port_plan(A)
    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    port = probe.getsockname()[1]
    probe.close()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src")] + [p for p in os.environ.get(
            "PYTHONPATH", "").split(os.pathsep) if p]))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.cluster.worker", "--connect",
         f"127.0.0.1:{port}", "--id", str(w), "--device", "cpu"],
        env=env, stdout=subprocess.PIPE, text=True) for w in range(2)]
    try:
        with CodedFleet(2, transport="tcp", device="cpu",
                        transport_opts={"spawn": False, "port": port}
                        ) as fleet:
            assert fleet.transport.reports() == {}
            h = fleet.attach(plan)
            for done in itertools.islice(all_straggler_masks(6, 2), 4):
                assert torch.equal(h.matvec(x, done),
                                   plan.matvec(torch.from_numpy(x), done))
        for w, p in enumerate(procs):
            out, _ = p.communicate(timeout=60)
            assert p.returncode == 0
            rep = json.loads(out.strip().splitlines()[-1])
            assert (rep["pid"], rep["device"], rep["backend"]) == (
                p.pid, "cpu", "packed")
            assert rep["launches"] == NO_LAUNCHES
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()


def test_remote_cli_rejects_a_bad_address_and_gives_up_dialing():
    from repro_torch.cluster.worker import main, run_remote_worker

    with pytest.raises(SystemExit):
        main(["--connect", "no-port-here", "--id", "0", "--device", "cpu"])
    t0 = time.perf_counter()
    with pytest.raises((ConnectionError, OSError, TimeoutError)):
        # nothing listens on port 1: the dial loop retries with backoff
        # and gives up at the wall cap
        run_remote_worker("127.0.0.1", 1, 0, max_dial_s=1.0, device="cpu")
    assert time.perf_counter() - t0 < 10.0
