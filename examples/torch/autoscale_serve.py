"""The closed load->capacity loop: an autoscaled coded serve path.

The fleet roster is *elastic* (live join/leave + re-encode) and has
*sensors* (router/fleet metrics, traced per-worker compute rates).
``repro_torch.scale`` closes the loop: a deterministic controller
watches the load signal and drives a provisioner pool, so
capacity follows demand without anyone calling ``add_worker`` by hand.

Four acts:

  * **load ramp** -- a paused router builds a backlog; the
    ``QueueDepthPolicy`` watermark trips and the ``ReplicaPool``
    provisions replica fleets up to the ceiling;
  * **scale-up serves the burst** -- every queued call resolves, and
    each result matches the plain ``plan.matvec`` reference;
  * **scale-down** -- once the backlog drains and nothing is in
    flight, the controller sheds one replica per tick (newest first,
    cooldown between actions) back to the floor, and the decision log
    shows the whole story;
  * **straggler storm** -- a fleet with a seeded slow worker measures
    it via traced compute rates; when a scheduled scale-up grows the
    roster, ``grow_encodings=True`` re-encodes to a *larger* code cut
    by those measured rates, so the grown capacity raises ``k`` (more
    parallelism per round, instead of padding redundancy) and the slow
    worker owns the fewest rows of the new hetero layout.

The PyTorch port of ``examples/autoscale_serve.py``: acts 1-3 serve a
plan on the card (``auto`` picks ``cuda``; the router's replica fleets
have card workers) unless ``--device cpu``; act 4's plan is ``packed``,
the host block-sparse path, so it and its fleet live on the CPU.

    python examples/torch/autoscale_serve.py [--device cpu]
"""

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2] / "src"))

import numpy as np
import torch

from repro_torch.api import compile_plan
from repro_torch.cluster import CodedFleet
from repro_torch.cluster.faults import adversarial_faults
from repro_torch.obs import Tracer
from repro_torch.scale import Autoscaler, QueueDepthPolicy, SchedulePolicy
from repro_torch.serve import Router

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda",
                help="cuda (the card, default) or cpu")
dev = torch.device(ap.parse_args().device)

rng = np.random.default_rng(0)

# --- act 1: load ramp trips the queue-depth watermark -----------------------
n, s, b = 6, 2, 4
A = torch.as_tensor(rng.standard_normal((512, 768)).astype(np.float32),
                    device=dev)
plan = compile_plan(A, scheme="proposed", n=n, s=s)
xs = [torch.as_tensor(rng.standard_normal((b, 512)), dtype=torch.float32,
                      device=dev)
      for _ in range(48)]

router = Router(batch_wait_s=0.002)
router.register("head", plan, replicas=1, n_workers=n,
                transport="memory", min_cols=1, max_cols=32)
router.call("head", xs[0])                           # warm the first replica

scaler = Autoscaler(router, endpoint="head", n_workers=n,
                    policy=QueueDepthPolicy(high=2 * b, low=1),
                    min_members=1, max_members=3,
                    interval_s=0.05, cooldown_s=0.1).start()
print(f"autoscaler up: pool={scaler.pool.kind} size={scaler.pool.size()} "
      f"bounds=[1, 3] policy=queue-depth(high={2 * b}, low=1)")

router.pause()                                       # the ramp: queue, don't serve
futs = [router.submit("head", x) for x in xs]
time.sleep(0.3)                                      # a few controller ticks
ramped = scaler.pool.size()
router.resume()

# --- act 2: the scaled-out pool serves the burst, bitwise-checked -----------
peak, bad = ramped, 0
for i, f in enumerate(futs):
    got = f.result(60).cpu().numpy()
    peak = max(peak, scaler.pool.size())
    # decode picks whichever k-subset finished first, so compare
    # against the exact product, not one particular pattern's decode
    exact = (xs[i] @ A).cpu().numpy()
    if np.linalg.norm(got - exact) > 1e-3 * np.linalg.norm(exact):
        bad += 1
print(f"\nburst: {len(futs)} calls ({len(futs) * b} cols) served, "
      f"replicas 1 -> {peak} under load, {bad} results off the exact "
      f"product")

# --- act 3: idle drains the pool back to the floor, one step per tick -------
t0 = time.monotonic()
while scaler.pool.size() > 1 and time.monotonic() - t0 < 30:
    # spaced probes: a probe permanently in flight would hold the
    # queue-depth shrink (it requires an idle endpoint)
    router.submit("head", xs[0]).result(60)
    time.sleep(0.1)
acts = [d for d in scaler.decision_log() if d["action"] != "hold"]
print(f"idle: pool back to {scaler.pool.size()} after "
      f"{time.monotonic() - t0:.1f}s")
print("decisions:", " ".join(
    f"{d['action']}({d['reason']},{d['size']}->{d['target']})"
    for d in acts))
scaler.close()
router.close()

# --- act 4: straggler storm -> measured rates cut the grown encoding --------
A2 = torch.as_tensor(rng.standard_normal((256, 144)).astype(np.float32))
plan2 = compile_plan(A2, scheme="proposed", n=8, s=2, backend="packed",
                     device="cpu")
x2 = torch.as_tensor(rng.standard_normal((256,)), dtype=torch.float32)
slow = 0
tr = Tracer(capacity=4096)
storm = adversarial_faults([slow], slowdown=60.0, time_scale=2e-3)
with CodedFleet(4, grow_encodings=True, faults=storm, tracer=tr,
                device="cpu") as fleet:
    h = fleet.attach(plan2)
    for _ in range(16):                              # storm under observation
        h.matvec(x2)
        time.sleep(0.01)
    rates = fleet.observed_rates()
    print(f"\nstorm: measured rates "
          f"{ {w: round(r, 1) for w, r in sorted(rates.items())} } "
          f"(worker {slow} seeded slow)")
    scaler2 = Autoscaler(fleet, policy=SchedulePolicy([(0, 4), (0.2, 6)]),
                         min_members=2, max_members=8,
                         interval_s=0.05, cooldown_s=0).start()
    before = (h.plan.n, h.plan.k, h.plan.s)
    pid0 = h.plan_id
    t0 = time.monotonic()
    while (len(fleet.live_workers()) < 6 or h.plan_id == pid0) \
            and time.monotonic() - t0 < 30:
        time.sleep(0.05)
    scaler2.close()
    owned = {w: 0 for w in fleet.live_workers()}
    for o in h._ps.owner.values():
        owned[o] += 1
    y = h.matvec(x2).numpy()
    exact = (x2 @ A2).numpy()
    err = np.linalg.norm(y - exact) / np.linalg.norm(exact)
    print(f"grown: (n,k,s) {before} -> "
          f"{(h.plan.n, h.plan.k, h.plan.s)} scheme={h.plan.scheme.name}")
    print(f"rows owned per worker: {dict(sorted(owned.items()))} "
          f"(slow worker {slow} gets the fewest)")
    print(f"decode parity on the grown code: rel err {err:.2e}")

print("\nloop closed: load ramped capacity up, idle walked it back, and "
      "the storm's measured rates shaped the grown encoding.")
