"""The port's wire format (``repro_torch.cluster.wire``) against the JAX
package's (``repro.cluster.wire``): the codec, frames that cross-load in
both directions, shard frames bitwise the reference's for the same plan,
task/result/liveness records, and bf16 plan frames without ml_dtypes."""

import json
import os
import struct
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.cluster.wire as ref_wire
import repro_torch.cluster.wire as wire
from repro.api import compile_plan as ref_compile
from repro_torch.api import compile_plan, list_schemes, make_scheme
from repro_torch.convert import plan_from_reference_arrays

CPU = torch.device("cpu")
TOL = dict(rtol=2e-5, atol=2e-5)
SRC = str(Path(__file__).resolve().parents[1] / "src")


def block_sparse(rng, t, r, zeros, bs=8):
    mask = rng.random((t // bs, r // bs)) >= zeros
    a = rng.standard_normal((t, r)).astype(np.float32)
    return a * np.kron(mask, np.ones((bs, bs), np.float32))


def ref_plan(A, kind="mv", backend="packed", dtype=jnp.float32, **kw):
    if kind == "mv":
        kw = {"n": 6, "s": 2, **kw}
    else:
        kw = {"n": 6, "k_A": 2, "k_B": 2, **kw}
    return ref_compile(jnp.asarray(A, dtype), scheme="proposed",
                       backend=backend, **kw)


def port_from_ref(plan):
    """The port plan holding exactly the reference plan's state."""
    sch = plan.scheme
    meta = {"scheme": sch.name, "kind": plan.kind, "n": plan.n,
            "s": plan.s, "k_A": sch.k_A, "k_B": getattr(sch, "k_B", None),
            "seed": plan.seed, "r": plan.r, "backend": plan.backend}
    arrays = {"G": np.asarray(plan.G),
              "coded": np.asarray(plan.executor.coded)}
    if plan.kind == "mm":
        arrays.update(rb=np.asarray(plan._rb), sup_b=np.asarray(plan._sup_b),
                      coef_b=np.asarray(plan._coef_b))
    return plan_from_reference_arrays(meta, arrays, device=CPU)


@pytest.fixture(scope="module")
def operands():
    rng = np.random.default_rng(0)
    A = block_sparse(rng, 256, 144, 0.9)
    x = rng.standard_normal((3, 256)).astype(np.float32)
    B = block_sparse(rng, 256, 40, 0.9)
    return A, x, B


# ---------------------------------------------------------------------------
# The codec
# ---------------------------------------------------------------------------


def test_record_bytes_equal_the_reference():
    """Numpy records encode to the reference's bytes and decode both ways;
    a torch tensor (any dtype the wire names) encodes like its array."""
    meta = {"a": 1, "s": "x", "nested": {"b": [1, 2]}}
    arrays = {"f": np.arange(6, dtype=np.float32).reshape(2, 3),
              "i": np.asarray([3, 1], np.int32),
              "d": np.ones((2, 2), np.float64),
              "l": np.arange(3, dtype=np.int64),
              "m": np.array([True, False]),
              "z": np.array(2.5, np.float32)}
    blob = wire.encode_record(meta, arrays)
    assert blob == ref_wire.encode_record(meta, arrays)
    assert wire.encode_record(meta, {k: torch.from_numpy(v)
                                     for k, v in arrays.items()}) == blob
    for decode in (wire.decode_record, ref_wire.decode_record):
        m2, a2 = decode(blob)
        assert m2 == meta
        for k, v in arrays.items():
            assert a2[k].dtype == v.dtype
            np.testing.assert_array_equal(a2[k].reshape(v.shape), v)
    assert wire.record_nbytes(meta, arrays) == len(blob)
    head, bufs = wire.encode_record_sg(meta, arrays)
    assert wire.flatten(head, bufs) == blob
    m3, a3 = wire.decode_record_sg(head, bufs)
    assert np.shares_memory(a3["f"], arrays["f"])       # zero-copy views


def test_bf16_record_is_the_reference_frame():
    """A bf16 tensor travels as its raw 16-bit words under the name
    ``bfloat16``: the same bytes the JAX package writes for an ml_dtypes
    array, decoded back to a ``torch.bfloat16`` tensor with its bits."""
    import ml_dtypes

    vals = np.random.default_rng(1).standard_normal((3, 5)).astype(
        ml_dtypes.bfloat16)
    t = torch.from_numpy(vals.view(np.uint16).astype(np.int16)).view(
        torch.bfloat16)
    blob = wire.encode_record({"k": 1}, {"w": t})
    assert blob == ref_wire.encode_record({"k": 1}, {"w": vals})
    assert wire.record_nbytes({"k": 1}, {"w": t}) == len(blob)
    _, arrays = wire.decode_record(blob)
    assert arrays["w"].dtype == torch.bfloat16
    assert torch.equal(arrays["w"].view(torch.int16), t.view(torch.int16))
    _, ref_arrays = ref_wire.decode_record(blob)
    np.testing.assert_array_equal(ref_arrays["w"].view(np.uint16),
                                  vals.view(np.uint16))


@pytest.mark.parametrize("case", ["magic", "version", "short", "manifest",
                                  "payload", "garbled", "specs"])
def test_bad_frames_rejected(case):
    blob = bytearray(wire.encode_record(
        {"x": 1}, {"a": np.arange(8, dtype=np.float32)}))
    match = {"magic": "not a repro", "version": "version",
             "garbled": "garbled|truncated", "specs": "garbled"}.get(
                 case, "truncated")
    if case == "magic":
        blob[:4] = b"XXXX"
    elif case == "version":
        blob[4] = 0xFF
    elif case == "short":
        blob = blob[:6]
    elif case == "manifest":
        blob = blob[:20]
    elif case == "payload":
        blob = blob[:-4]
    elif case == "garbled":
        blob[16:22] = b"\xff\xfe\xfd\xfc\xfb\xfa"
    else:
        head = json.dumps({"meta": {}, "arrays": [{}]}).encode()
        blob = struct.pack("<4sHQ", b"RPRC", wire.WIRE_VERSION,
                           len(head)) + head
    with pytest.raises(ValueError, match=match):
        wire.decode_record(bytes(blob))


def test_sg_buffer_table_enforced():
    arrays = {"a": np.ones(4, np.float32), "b": np.arange(3, dtype=np.int64)}
    header, bufs = wire.encode_record_sg({"x": 1}, arrays)
    with pytest.raises(ValueError, match="wrong buffer count"):
        wire.decode_record_sg(header, bufs[:1])
    with pytest.raises(ValueError, match="'b'"):
        wire.decode_record_sg(header, [bufs[0], bufs[1][:4]])
    bad = bytearray(header)
    bad[4] = wire.WIRE_VERSION + 1
    with pytest.raises(ValueError, match="version"):
        wire.decode_record_sg(bytes(bad), bufs)


# ---------------------------------------------------------------------------
# Records
# ---------------------------------------------------------------------------


def records(w):
    """The same records built from wire module ``w``."""
    payload = {"bx": np.arange(16, dtype=np.float32).reshape(8, 2),
               "bi": np.asarray([3], np.int32)}
    return [
        w.Task(round=3, op="matvec", task_row=5, plan=2, payload=payload,
               meta={"b": 2}),
        w.Task(round=4, op="matmat", task_row=1, plan=1, trace=9,
               payload={"b": np.ones((4, 3), np.float32)}, meta={"cb": 3}),
        w.TaskResult(worker=1, round=3, task_row=5, plan=2, work=0.25,
                     compute_s=1e-4, copied=123,
                     arrays={"y": np.arange(6, dtype=np.float32)}),
        w.TaskResult(worker=2, round=7, task_row=0, trace=4, t_recv=1.5,
                     t_start=1.75, t_finish=2.0,
                     arrays={"y": np.zeros((2, 2), np.float32)}),
        w.death_notice(3, "boom"),
        w.Heartbeat(worker=3, tick=17),
        w.WorkerJoin(worker=6, capacity=2),
        w.WorkerLeave(worker=1, reason="drain"),
    ]


@pytest.mark.parametrize("i", range(8))
def test_records_round_trip_and_match_the_reference(i):
    rec, ref = records(wire)[i], records(ref_wire)[i]
    blob = rec.encode()
    assert blob == ref.encode()
    if isinstance(rec, wire.Task):
        back, ref_back = wire.Task.decode(blob), ref_wire.Task.decode(blob)
        assert rec.nbytes() == len(blob)
        head, bufs = rec.encode_sg()
        assert wire.flatten(head, bufs) == blob
    else:
        back, ref_back = wire.decode_event(blob), ref_wire.decode_event(blob)
    assert type(back).__name__ == type(ref_back).__name__
    fields = {k: v for k, v in vars(back).items()
              if k not in ("payload", "arrays")}
    assert fields == {k: v for k, v in vars(ref_back).items()
                      if k not in ("payload", "arrays")}
    assert fields == {k: v for k, v in vars(rec).items()
                      if k not in ("payload", "arrays")}
    for name in ("payload", "arrays"):
        for key, arr in getattr(rec, name, {}).items():
            np.testing.assert_array_equal(getattr(back, name)[key], arr)


def test_control_frames_and_event_errors():
    for rec in ("shard-ack", "welcome"):
        blob = wire.control_record(rec, worker=2)
        assert blob == ref_wire.control_record(rec, worker=2)
        assert wire.decode_event(blob)["worker"] == 2
    assert wire.drop_record(4) == ref_wire.drop_record(4)
    assert wire.welcome_record(1, 3) == ref_wire.welcome_record(1, 3)
    assert wire.decode_event(wire.hello_record(5, join=True))["join"]
    with pytest.raises(ValueError, match="unexpected event"):
        wire.decode_event(wire.encode_record({"record": "task"}))
    with pytest.raises(ValueError, match="garbled"):
        wire.decode_event(wire.encode_record({"record": "beat"}))


def test_scheme_meta_round_trips_every_scheme():
    for info in list_schemes():
        if info.hetero:
            sch = make_scheme(info.name, capacities=[2, 2, 1, 1], k_A=4)
        elif info.kind == "mv":
            sch = make_scheme(info.name, n=6, k_A=4)
        else:
            sch = make_scheme(info.name, n=6, k_A=2, k_B=2)
        meta = wire.scheme_to_meta(sch)
        assert wire.scheme_from_meta(meta) == sch
        assert json.dumps(meta) == json.dumps(ref_wire.scheme_to_meta(
            ref_wire.scheme_from_meta(meta)))


# ---------------------------------------------------------------------------
# Plan frames, both directions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["mv", "mm"])
def test_plan_frame_bitwise_the_reference(operands, kind):
    """The port plan over the reference plan's state writes the very
    frame the reference writes (scheme, G, shards, mm tables, warmed
    patterns)."""
    A, _, _ = operands
    ref = ref_plan(A, kind)
    assert wire.dumps_plan(port_from_ref(ref)) == ref_wire.dumps_plan(ref)


@pytest.mark.parametrize("backend", ["packed", "reference"])
@pytest.mark.parametrize("kind", ["mv", "mm"])
def test_reference_frame_loads_in_the_port(operands, kind, backend):
    A, x, B = operands
    ref = ref_plan(A, kind, backend)
    done = np.ones(ref.n_tasks, bool)
    done[[1, 4]] = False
    ref.prewarm(jnp.asarray(done))
    plan = wire.loads_plan(ref_wire.dumps_plan(ref), device="cpu")
    assert (plan.backend, plan.device) == (backend, CPU)
    assert wire.scheme_to_meta(plan.scheme) == \
        ref_wire.scheme_to_meta(ref.scheme)
    np.testing.assert_array_equal(plan.executor.coded.numpy(),
                                  np.asarray(ref.executor.coded))
    np.testing.assert_array_equal(plan._decode_cache().patterns(),
                                  ref._decode_cache().patterns())
    if kind == "mv":
        got = plan.matvec(torch.from_numpy(x), done).numpy()
        want = np.asarray(ref.matvec(jnp.asarray(x), jnp.asarray(done)))
    else:
        got = plan.matmat(torch.from_numpy(B), done).numpy()
        want = np.asarray(ref.matmat(jnp.asarray(B), jnp.asarray(done)))
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("backend", ["packed", "cuda"])
@pytest.mark.parametrize("kind", ["mv", "mm"])
def test_port_frame_loads_in_the_reference(operands, kind, backend):
    A, x, B = operands
    kw = dict(n=6, s=2) if kind == "mv" else dict(n=6, k_A=2, k_B=2)
    plan = compile_plan(torch.from_numpy(A), scheme="proposed",
                        backend=backend, device="cpu", **kw)
    ref = ref_wire.loads_plan(wire.dumps_plan(plan), backend="packed")
    assert ref.backend == "packed"
    assert ref_wire.scheme_to_meta(ref.scheme) == \
        wire.scheme_to_meta(plan.scheme)
    np.testing.assert_array_equal(np.asarray(ref.executor.coded),
                                  plan.executor.coded.numpy())
    if kind == "mv":
        got = plan.matvec(torch.from_numpy(x)).numpy()
        want = np.asarray(ref.matvec(jnp.asarray(x)))
    else:
        got = plan.matmat(torch.from_numpy(B)).numpy()
        want = np.asarray(ref.matmat(jnp.asarray(B)))
    np.testing.assert_allclose(got, want, **TOL)


def test_aggregation_only_and_bf16_frames_round_trip(operands):
    A, x, _ = operands
    agg = compile_plan(scheme="proposed", n=6, s=2, seed=3, device="cpu")
    back = wire.loads_plan(wire.dumps_plan(agg), device="cpu")
    assert back.executor is None
    assert wire.scheme_to_meta(back.scheme) == wire.scheme_to_meta(agg.scheme)
    np.testing.assert_array_equal(back.G, agg.G)
    head = torch.from_numpy(A).to(torch.bfloat16)
    plan = compile_plan(head, scheme="proposed", n=6, s=2, device="cpu",
                        backend="cuda")
    back = wire.loads_plan(wire.dumps_plan(plan), device="cpu")
    assert back.executor.coded.dtype == torch.bfloat16
    assert torch.equal(back.executor.coded.view(torch.int16),
                       plan.executor.coded.view(torch.int16))
    torch.testing.assert_close(back.matvec(torch.from_numpy(x)),
                               plan.matvec(torch.from_numpy(x)), rtol=0,
                               atol=0)
    ref = ref_wire.loads_plan(wire.dumps_plan(plan), backend="packed")
    assert ref.executor.coded.dtype == jnp.bfloat16


def test_loads_plan_refuses_what_the_port_lacks(operands):
    """A frame whose backend the port lacks raises instead of demoting;
    ``backend=`` picks one of the port's.  Without ``device`` the plan
    goes to the card, which this machine lacks."""
    A, x, _ = operands
    blob = ref_wire.dumps_plan(ref_plan(A, backend="pallas-interpret"))
    with pytest.raises(ValueError, match="pallas-interpret"):
        wire.loads_plan(blob, device="cpu")
    plan = wire.loads_plan(blob, backend="cuda", device="cpu")
    assert plan.backend == "cuda" and plan.executor.packed.bk == 32
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            wire.loads_plan(blob, backend="packed")
    with pytest.raises(ValueError, match="expected a plan record"):
        wire.loads_plan(wire.encode_record({"record": "task"}),
                        device="cpu")


def test_bf16_frame_decodes_without_ml_dtypes(operands, tmp_path):
    """A bf16 plan frame (written by the JAX package) loads in a process
    where ``ml_dtypes`` cannot be imported."""
    A, x, _ = operands
    ref = ref_plan(A, dtype=jnp.bfloat16)
    frame = tmp_path / "plan.bin"
    frame.write_bytes(ref_wire.dumps_plan(ref))
    want = tmp_path / "coded.npy"
    np.save(want, np.asarray(ref.executor.coded).view(np.uint16))
    code = f"""
import sys
sys.modules["ml_dtypes"] = None
import numpy as np, torch
from repro_torch.cluster.wire import loads_plan
plan = loads_plan(open({str(frame)!r}, "rb").read(), device="cpu")
coded = plan.executor.coded
assert coded.dtype == torch.bfloat16, coded.dtype
bits = coded.view(torch.int16).numpy().view(np.uint16)
assert (bits == np.load({str(want)!r})).all()
assert "ml_dtypes" not in [m for m in sys.modules if sys.modules[m]]
print("ok")
"""
    env = {**os.environ, "PYTHONPATH": SRC}
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


# ---------------------------------------------------------------------------
# Shard frames
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["mv", "mv-partial", "mv-capacities",
                                  "mm", "aggregation"])
def test_shard_frames_bitwise_the_reference(operands, case):
    """``shard_plan`` of the port plan over the reference plan's arrays
    writes the reference's frames, bit for bit."""
    A, _, _ = operands
    kw = {}
    if case == "aggregation":
        ref = ref_compile(scheme="proposed", n=6, s=2)
        plan = compile_plan(scheme="proposed", n=6, s=2, device="cpu")
    else:
        ref = ref_plan(A, "mm" if case == "mm" else "mv")
        plan = port_from_ref(ref)
        if case == "mv-partial":
            kw = {"n_workers": 4}
        elif case == "mv-capacities":
            kw = {"n_workers": 3, "capacities": [3, 1, 2]}
    got = wire.shard_plan(plan, plan_id=2, **kw)
    want = ref_wire.shard_plan(ref, plan_id=2, **kw)
    assert [s.encode() for s in got] == [s.encode() for s in want]
    for shard in got:
        head, bufs = shard.encode_sg()
        assert wire.flatten(head, bufs) == shard.encode()
        back = wire.PlanShard.decode(shard.encode())
        assert back.encode() == shard.encode()
