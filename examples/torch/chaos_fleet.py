"""Self-healing fleet under a scripted fault storm.

A ``CodedFleet`` claims it never hangs: workers can die, go silent,
slow down, partition, leave gracefully or join mid-run, and every
submitted future still resolves -- with a value that is *bitwise* the
local replay of its round's observed pattern, or with a structured
``FleetDegraded`` naming the recovery action.  This example scripts
exactly that storm with the chaos harness and narrates what the fleet
does about it:

  * a **kill** fails a worker mid-round: its shards re-home, its rows
    requeue, and (the live set now too small for the full encoding)
    the plan **re-encodes** under a fresh plan id -- ``k`` preserved,
    resilience ``s`` shrunk: availability survives at reduced margin;
  * a **reconnect** revives the felled worker id: the fleet catches it
    up with every attached plan's shards and re-encodes back to full
    strength;
  * a **join** admits a brand-new worker: shard ownership rebalances
    off the most-loaded hosts so the newcomer serves too;
  * a **leave** drains first -- in-flight rows get a grace window on
    the leaver before the channel closes without a death notice;
  * throughout, per-worker throughput EWMAs feed the hetero-capacity
    encoder, so a measurably slow device would get fewer virtual tiles
    on the next re-encode.

The PyTorch port of ``examples/chaos_fleet.py``: the storm's plan and
its workers live on the card (card workers: ``bcsr_matmul`` per task,
``decode_matmul`` per round) unless ``--device cpu`` (host workers).

    python examples/torch/chaos_fleet.py [--device cpu]
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2] / "src"))

from repro_torch.cluster.chaos import (
    ChaosEvent,
    max_concurrent_failures,
    run_chaos,
    scripted_schedule,
)

if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card, default) or cpu")
    dev = ap.parse_args().device
    n, s = 6, 2

    # a hand-written storm: one of everything, inside the budget
    storm = [
        ChaosEvent(kind="slow", t0=0.3, t1=1.2, worker=2, delay_s=0.15),
        ChaosEvent(kind="kill", t0=0.6, t1=1.4, worker=1),
        ChaosEvent(kind="join", t0=0.9),
        ChaosEvent(kind="leave", t0=1.3, worker=3),
        ChaosEvent(kind="reconnect", t0=1.7, worker=1),
        ChaosEvent(kind="garble", t0=2.0, worker=4),
        ChaosEvent(kind="reconnect", t0=2.5, worker=4),
    ]
    print(f"storm: {len(storm)} events, peak concurrent failures = "
          f"{max_concurrent_failures(storm)} (budget s={s})")

    res = run_chaos(storm, transport="memory", n=n, s=s, seed=0,
                    calls=24, spacing_s=0.12, warmup_s=3.0, device=dev)

    counts = res.counts()
    print(f"\nfutures: {counts['clean']} clean, {counts['degraded']} "
          f"degraded-but-correct, {counts['failed']} failed -- none hung")
    print("fleet journal:", " -> ".join(e["kind"] for e in res.events))
    print(f"final encoding: plan_id={res.final_plan['plan_id']} "
          f"n={res.final_plan['n']} k={res.final_plan['k']} "
          f"s={res.final_plan['s']}")
    if res.joiner_serving is not None:
        print(f"joiner serving the attached plan: {res.joiner_serving}")
    for kind, lat in sorted(res.recovery_latency().items()):
        print(f"recovery after {kind}: "
              f"{', '.join(f'{v * 1e3:.0f}ms' for v in lat)}")

    # the same machinery generates seeded random storms (the CI smoke):
    sched = scripted_schedule(seed=5, n=n, s=s, duration=2.0)
    res2 = run_chaos(sched, transport="memory", n=n, s=s, seed=5,
                     calls=16, spacing_s=0.1, warmup_s=3.0, device=dev)
    print(f"\nseeded schedule (seed=5): {res2.counts()} under "
          f"{res2.max_concurrent} peak concurrent failures")
    print("every resolved value was bitwise-verified against the local "
          "replay of its observed pattern.")
