"""The port's retry policy and chaos harness (``repro_torch.cluster.
{retry,chaos}``) against the JAX package's: backoff schedules and fault
schedules equal for the same seeds, the concurrent-failure count, and
scripted storms against a live fleet on every transport, where every
resolved value must be bitwise the local replay of its round's pattern
and close to the fault-free result, also with the autoscaler
(``repro_torch.scale``) changing the roster during the storm."""

import pytest

from repro.cluster.chaos import max_concurrent_failures as ref_max_concurrent
from repro.cluster.chaos import scripted_schedule as ref_schedule
from repro.cluster.retry import RetryPolicy as RefRetryPolicy
from repro_torch.cluster import (
    ChaosEvent,
    RetryPolicy,
    max_concurrent_failures,
    run_chaos,
    scripted_schedule,
)
from repro_torch.cluster.retry import (ENV_RETRY_MAX_ATTEMPTS,
                                       default_max_attempts)

# ---------------------------------------------------------------------------
# RetryPolicy
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(5))
def test_backoff_is_bitwise_the_reference(seed):
    for kw in ({}, {"base_s": 0.1, "factor": 3.0, "max_backoff_s": 0.5},
               {"jitter": 0.0}, {"base_s": 0.05, "max_backoff_s": 0.5,
                                 "jitter": 0.5}):
        ours, ref = RetryPolicy(seed=seed, **kw), RefRetryPolicy(seed=seed,
                                                                  **kw)
        got = [ours.backoff_s(i) for i in range(1, 12)]
        assert got == [ref.backoff_s(i) for i in range(1, 12)]
        assert all(x <= ours.max_backoff_s * (1 + ours.jitter) for x in got)


def test_call_retries_then_succeeds_and_exhausts():
    attempts, slept = [], []

    def flaky():
        attempts.append(1)
        if len(attempts) < 3:
            raise ConnectionError("not yet")
        return "ok"

    assert RetryPolicy(max_attempts=5, base_s=0.01, jitter=0.0).call(
        flaky, sleep=slept.append) == "ok"
    assert len(attempts) == 3 and slept == [0.01, 0.02]
    with pytest.raises(ConnectionError, match="always"):
        RetryPolicy(max_attempts=3, base_s=0.0, jitter=0.0).call(
            lambda: (_ for _ in ()).throw(ConnectionError("always")),
            sleep=lambda s: None)
    calls = []

    def boom():
        calls.append(1)
        raise ValueError("not transient")

    with pytest.raises(ValueError):
        RetryPolicy(max_attempts=5, base_s=0.0).call(boom,
                                                     sleep=lambda s: None)
    assert len(calls) == 1


def test_total_timeout_bounds_the_wall_budget():
    now = [0.0]

    def sleep(s):
        now[0] += s

    def always_fail():
        now[0] += 0.05
        raise TimeoutError("slow op")

    p = RetryPolicy(max_attempts=0, base_s=0.1, jitter=0.0,
                    total_timeout_s=1.0)
    with pytest.raises(TimeoutError):
        p.call(always_fail, clock=lambda: now[0], sleep=sleep)
    assert now[0] <= 1.5


def test_env_var_sets_attempt_default(monkeypatch):
    monkeypatch.delenv(ENV_RETRY_MAX_ATTEMPTS, raising=False)
    assert default_max_attempts() == 5
    monkeypatch.setenv(ENV_RETRY_MAX_ATTEMPTS, "2")
    assert default_max_attempts() == 2
    attempts = []

    def fail():
        attempts.append(1)
        raise ConnectionError("x")

    with pytest.raises(ConnectionError):
        RetryPolicy(base_s=0.0).call(fail, sleep=lambda s: None)
    assert len(attempts) == 2
    monkeypatch.setenv(ENV_RETRY_MAX_ATTEMPTS, "zero")
    with pytest.raises(ValueError, match=ENV_RETRY_MAX_ATTEMPTS):
        default_max_attempts()


# ---------------------------------------------------------------------------
# Schedules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 3, 7, 9, 10])
def test_scripted_schedule_is_the_reference(seed):
    for kw in ({"n": 6, "s": 2, "duration": 3.0},
               {"n": 4, "s": 1, "duration": 1.5, "n_events": 3},
               {"n": 8, "s": 2, "duration": 4.0, "n_events": 10,
                "budget": 3}):
        ours, ref = scripted_schedule(seed=seed, **kw), \
            ref_schedule(seed=seed, **kw)
        assert [e.__dict__ for e in ours] == [e.__dict__ for e in ref]
        assert [e.window() for e in ours] == [e.window() for e in ref]
        assert max_concurrent_failures(ours) == ref_max_concurrent(ref)
    assert [e.__dict__ for e in scripted_schedule(seed=seed, n=6, s=2)] != \
        [e.__dict__ for e in scripted_schedule(seed=seed + 1, n=6, s=2)]


def test_max_concurrent_failures_counts_overlap_and_reconnects():
    sched = [
        ChaosEvent(kind="kill", t0=0.0, t1=2.0, worker=0),
        ChaosEvent(kind="hang", t0=1.0, t1=3.0, worker=1),
        ChaosEvent(kind="slow", t0=0.5, t1=2.5, worker=2),  # not a failure
        ChaosEvent(kind="kill", t0=4.0, t1=5.0, worker=3),
    ]
    assert max_concurrent_failures(sched) == 2
    sched = [
        ChaosEvent(kind="garble", t0=1.0, worker=0),
        ChaosEvent(kind="kill", t0=1.5, t1=2.0, worker=1),
        ChaosEvent(kind="reconnect", t0=1.2, worker=0),
    ]
    # the garble heals at 1.2, before the kill opens at 1.5
    assert max_concurrent_failures(sched) == 1


def test_schedule_respects_failure_budget():
    for seed in range(5):
        sched = scripted_schedule(seed=seed, n=8, s=2, duration=4.0,
                                  n_events=10, budget=2)
        assert max_concurrent_failures(sched) <= 2


# ---------------------------------------------------------------------------
# Chaos runs (host workers here; chip_smoke.py runs them on the card)
# ---------------------------------------------------------------------------


def test_memory_within_budget_all_resolve_bitwise():
    """One of everything, never more than s = 2 concurrent failures:
    run_chaos itself asserts every resolved value is bitwise the local
    replay of its observed pattern and close to the fault-free result,
    and that no future failed."""
    storm = [
        ChaosEvent(kind="slow", t0=0.2, t1=1.0, worker=2, delay_s=0.1),
        ChaosEvent(kind="kill", t0=0.5, t1=1.2, worker=1),
        ChaosEvent(kind="join", t0=0.8),
        ChaosEvent(kind="leave", t0=1.1, worker=3),
        ChaosEvent(kind="reconnect", t0=1.6, worker=1),
    ]
    assert max_concurrent_failures(storm) <= 2
    res = run_chaos(storm, transport="memory", n=6, s=2, seed=0,
                    calls=16, spacing_s=0.1, warmup_s=3.0, device="cpu")
    counts = res.counts()
    assert counts["failed"] == 0
    assert counts["clean"] + counts["degraded"] == 16
    assert all(o.bitwise and o.correct for o in res.outcomes)
    assert res.joiner_serving is True
    kinds = {e["kind"] for e in res.events}
    assert "join" in kinds
    assert "death" in kinds or "suspect" in kinds


def test_memory_past_budget_degrades_never_hangs():
    """Three concurrent kills against s = 2: the fleet re-encodes at
    reduced resilience or fails fast with a structured error; no future
    hangs, every resolved value is still bitwise its replay.  The final
    plan follows the re-encode policy over the hosts left alive:
    k' = min(k, live), availability last.  (The JAX package's version
    asserts k' = min(k, n'), which a capacity-virtualized cut breaks
    whenever the heartbeat rates come out uneven: it then gives some
    host more than one shard, so n' > live.)"""
    storm = [
        ChaosEvent(kind="kill", t0=0.4, t1=2.0, worker=1),
        ChaosEvent(kind="kill", t0=0.45, t1=2.0, worker=2),
        ChaosEvent(kind="kill", t0=0.5, t1=2.0, worker=3),
    ]
    assert max_concurrent_failures(storm) == 3
    res = run_chaos(storm, transport="memory", n=6, s=2, seed=1,
                    calls=16, spacing_s=0.1, warmup_s=3.0, device="cpu")
    counts = res.counts()
    assert sum(counts.values()) == 16
    assert counts["degraded"] > 0 or counts["failed"] > 0
    resolved = [o for o in res.outcomes if o.outcome != "failed"]
    assert resolved
    assert all(o.bitwise and o.correct for o in resolved)
    # a kill fires when a task lands in its window: count the ones that did
    deaths = sum(e["kind"] == "death" for e in res.events)
    assert 1 <= deaths <= 3
    live = 6 - deaths
    assert res.final_plan["k"] == min(4, live)
    assert res.final_plan["n"] >= live


def test_recovery_latency_is_reported_per_fault_kind():
    storm = [ChaosEvent(kind="kill", t0=0.3, t1=1.2, worker=0),
             ChaosEvent(kind="reconnect", t0=1.5, worker=0)]
    res = run_chaos(storm, transport="memory", n=4, s=1, seed=2,
                    calls=10, spacing_s=0.1, warmup_s=3.0, device="cpu")
    lat = res.recovery_latency()
    assert "kill" in lat and all(v >= 0 for v in lat["kill"])
    d = res.as_dict()
    assert {"p50_s", "p99_s", "n"} <= set(d["recovery_latency"]["kill"])
    assert d["futures"] == res.counts() and d["transport"] == "memory"


def test_autoscale_waits_for_the_scale_port():
    """``run_chaos(autoscale=)`` raised until ``scale/*`` was ported; it
    now starts an ``Autoscaler`` on the chaos fleet and lands its
    decision log on the result.  Here its default queue-depth policy
    sees nothing queued and drains the fleet to ``min_members``, one
    worker per tick, without failing a call."""
    res = run_chaos([], autoscale={"policy": None, "interval_s": 0.05,
                                   "cooldown_s": 0.0, "min_members": 4},
                    calls=6, spacing_s=0.1, warmup_s=0.5, device="cpu")
    counts = res.counts()
    assert sum(counts.values()) == 6 and counts["failed"] == 0
    assert all(o.bitwise and o.correct for o in res.outcomes)
    downs = [d for d in res.autoscale if d["action"] == "down"]
    assert [d["applied"] for d in downs] == [-1, -1]
    assert all(d["ok"] for d in res.autoscale)
    assert res.final_plan["n"] == 4


def test_autoscaling_interleaves_with_faults():
    """The JAX package's case: scripted faults and autoscaling decisions
    on the same fleet at once (a kill can land mid scale-up, a join mid
    drain); run_chaos's invariants hold regardless, and the decision log
    shows scaling in both directions."""
    from repro_torch.scale import SchedulePolicy

    sched = scripted_schedule(seed=7, n=6, s=2, duration=2.0, n_events=5)
    res = run_chaos(
        sched, transport="memory", n=6, s=2, seed=7, calls=16,
        spacing_s=0.1, warmup_s=3.0, device="cpu",
        autoscale={"policy": SchedulePolicy([(0, 6), (0.5, 8), (1.5, 6)]),
                   "min_members": 2, "max_members": 10,
                   "interval_s": 0.1, "cooldown_s": 0.2})
    counts = res.counts()
    assert sum(counts.values()) == 16
    if res.max_concurrent <= 2:
        assert counts["failed"] == 0
    resolved = [o for o in res.outcomes if o.outcome != "failed"]
    assert resolved
    assert all(o.bitwise and o.correct for o in resolved)
    actions = [d["action"] for d in res.autoscale]
    assert "up" in actions and "down" in actions
    for d in res.autoscale:
        if d["action"] != "hold":
            assert d["reason"] and d["target"] >= 0


@pytest.mark.parametrize("transport", ["pipe", "tcp", "shm"])
def test_process_transports_survive_chaos(transport):
    """The JAX package's process-transport case, on host children: the
    schedule (seed 3) kills or garbles within s = 1, and every resolved
    value is bitwise its replay.  The warm-up covers the children's
    start (torch import) before the schedule's epoch."""
    sched = scripted_schedule(seed=3, n=4, s=1, duration=1.5, n_events=3)
    res = run_chaos(sched, transport=transport, n=4, s=1, seed=3,
                    calls=8, spacing_s=0.15, warmup_s=12.0,
                    suspect_after=1.0, device="cpu")
    counts = res.counts()
    assert sum(counts.values()) == 8
    resolved = [o for o in res.outcomes if o.outcome != "failed"]
    assert resolved
    assert all(o.bitwise and o.correct for o in resolved)
    if res.max_concurrent <= 1:
        assert counts["failed"] == 0
