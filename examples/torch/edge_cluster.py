"""Compile -> ship -> dispatch -> decode on the real cluster runtime.

The paper's deployment, end to end: an edge server compiles a
sparsity-preserving coded plan for a sparse operator, serializes it into
per-worker shards (``repro_torch.cluster.wire``), ships them to workers over a
pluggable transport (in-process ``memory`` here; flip ``TRANSPORT`` or
set ``REPRO_CLUSTER_TRANSPORT=tcp`` for real localhost sockets), and
then serves matvecs by racing the workers -- decoding as soon as any
fastest-k task set reports, while injected shifted-exponential latency
makes the run reproducibly straggly.  Task payloads are
support-restricted (only the x-blocks a worker's nonzero tiles read
travel), so the wire carries omega/k-proportional bytes -- printed per
round.  Later passes show adversarial slowdown (partial-straggler
credit), worker fail-stop with requeue, and a *silent* worker caught
purely by heartbeat timeout (suspected -> shard re-shipped -> requeue).

The PyTorch port of ``examples/edge_cluster.py``.  ``packed`` is the
host block-sparse path (scipy BSR), so the plan and its workers live on
the CPU whichever ``--device`` is given.

    python examples/torch/edge_cluster.py [--device cpu]
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2] / "src"))

import numpy as np
import torch

from repro_torch.api import compile_plan
from repro_torch.cluster import (
    FailStop,
    Hang,
    StragglerFaults,
    adversarial_faults,
    dumps_plan,
    shard_plan,
)

TRANSPORT = "memory"              # or "pipe" / "tcp" -- same results

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda",
                help="cuda (default) or cpu; a packed plan is a host plan")
ap.parse_args()

rng = np.random.default_rng(0)

# --- a 98%-block-sparse operator, plan compiled once ------------------------
n, k = 12, 9                      # s = 3 stragglers tolerated
t, r = 1024, 720
mask = rng.random((t // 8, r // 8)) >= 0.98
A = torch.as_tensor((rng.standard_normal((t, r)) *
                     np.kron(mask, np.ones((8, 8)))).astype(np.float32))
x = torch.as_tensor(rng.standard_normal((4, t)), dtype=torch.float32)
ref = (x @ A).numpy()

plan = compile_plan(A, scheme="proposed", n=n, s=n - k, backend="packed",
                    device="cpu")
blob = dumps_plan(plan)
shards = shard_plan(plan, n_workers=4)
print(f"compiled: scheme={plan.scheme.name} n={n} k={k} "
      f"omega={plan.scheme.omega_A} backend={plan.backend}")
print(f"wire: plan={len(blob) / 1e3:.1f} kB, "
      f"shards={[len(s.encode()) // 1024 for s in shards]} kiB "
      f"over 4 hosts\n")

# --- race the workers under shifted-exponential stragglers ------------------
with plan.to_cluster(transport=TRANSPORT,
                     faults=StragglerFaults(time_scale=0.05, seed=1)) as cl:
    for i in range(3):
        y = cl.matvec(x)                      # decode at fastest-k
        rep = cl.last_report
        err = np.abs(y.numpy() - ref).max()
        print(f"round {i}: wall={rep.wall_s * 1e3:6.1f} ms  "
              f"decode={rep.decode_s * 1e6:5.0f} us  "
              f"decoded_from={rep.n_done}/{rep.n_tasks}  "
              f"task_kB={rep.bytes_tasks / 1e3:5.1f} "
              f"(dense would ship {rep.bytes_tasks_dense / 1e3:.1f})  "
              f"err={err:.1e}")
    tot = cl.wire_totals()
    print(f"totals[{tot['transport']}]: shards={tot['bytes_shards'] / 1e3:.1f} kB "
          f"once, tasks={tot['bytes_tasks_total'] / 1e3:.1f} kB over 3 rounds")

# --- partial stragglers: 4 hosts, host 0 is adversarially slow --------------
print("\n4 physical hosts x 3 virtual workers, host 0 is 25x slow:")
with plan.to_cluster(4, transport=TRANSPORT,
                     faults=adversarial_faults([0], slowdown=25.0,
                                               time_scale=0.05)) as cl:
    y = cl.matvec(x)
    rep = cl.last_report
    err = np.abs(y.numpy() - ref).max()
    print(f"  decoded from {rep.n_done} rows, partial hosts "
          f"{list(rep.partial_workers)} (finished SOME of their rows), "
          f"err={err:.1e}")

# --- fail-stop + requeue: two workers die; their shards are re-homed --------
print("\nfail-stop: workers 2 and 5 die on first task (k needs requeue):")
with plan.to_cluster(transport=TRANSPORT, faults=FailStop({2: 0, 5: 0})) as cl:
    y = cl.matvec(x)
    rep = cl.last_report
    err = np.abs(y.numpy() - ref).max()
    print(f"  deaths={rep.deaths} requeues={rep.requeues} "
          f"decoded_from={rep.n_done}  err={err:.1e}")
    y = cl.matvec(x)                          # cluster keeps serving
    print(f"  next round on {n - rep.deaths} survivors: "
          f"err={np.abs(y.numpy() - ref).max():.1e}")

# --- silent workers: liveness is measured, not injected ---------------------
print("\nsilent hang: workers 1, 4, 7, 10 go mute mid-round (no death notice,")
print("connection stays open; 8 < k live) -- only heartbeat timeout helps:")
with plan.to_cluster(transport=TRANSPORT,
                     faults=Hang({1: 0, 4: 0, 7: 0, 10: 0}),
                     heartbeat_s=0.05, suspect_after=0.5) as cl:
    y = cl.matvec(x)
    rep = cl.last_report
    err = np.abs(y.numpy() - ref).max()
    print(f"  suspected={rep.suspected} requeues={rep.requeues} "
          f"decoded_from={rep.n_done}  err={err:.1e}")
