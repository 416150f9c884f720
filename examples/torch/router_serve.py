"""The serve front door: two tenants, one endpoint, a replica pair.

The fleet coalesces queued matvecs under a *static* width cap -- tuned
for one offered load only.  The ``Router`` fronts fleet replicas with
named endpoints and decides the width itself: per-tenant weighted-fair
queues (service converges to the weight ratios under contention, no
starvation), **adaptive microbatching** (the effective round width
follows the backlog: collapses at low load so solo calls skip the
collection window, ramps at high load so decode amortization kicks in),
and least-loaded replica balancing.  Every routed result is bitwise
identical to the same call submitted directly against a fleet handle --
batches go down as one round with per-call decode slices.

Here a "pro" tenant (weight 3) and a "free" tenant (weight 1) share one
``lm-head`` endpoint over two replica fleets:

  * a contended burst shows ~3:1 service in the dispatch log and an
    adaptive width ramp;
  * a quiet stretch shows the width collapsing back and solo-call
    latency matching a direct fleet call;
  * ``ServeEngine`` plugs in via ``CodedConfig(router=...)`` -- the
    engine's coded LM head becomes just another tenant.

The PyTorch port of ``examples/router_serve.py``: the plan and the
router's replica fleets live on the card (``auto`` picks ``cuda``: card
workers) unless ``--device cpu``.

    python examples/torch/router_serve.py [--device cpu]
"""

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2] / "src"))

import numpy as np
import torch

from repro_torch.api import compile_plan
from repro_torch.serve import Router

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda",
                help="cuda (the card, default) or cpu")
dev = torch.device(ap.parse_args().device)

rng = np.random.default_rng(0)
n, s, b = 8, 2, 4
A = torch.as_tensor(rng.standard_normal((512, 768)).astype(np.float32),
                    device=dev)
plan = compile_plan(A, scheme="proposed", n=n, s=s)

# --- one endpoint, two replica fleets, two tenants --------------------------
router = Router(batch_wait_s=0.004)
# max_cols caps the adaptive round width: wider rounds amortize more
# decode weight but make fair-share granularity coarser -- 32 keeps the
# burst below legible in the dispatch log
router.register("lm-head", plan, replicas=2, n_workers=n,
                transport="memory", max_cols=32)
router.set_tenant("pro", weight=3.0)
router.set_tenant("free", weight=1.0, deadline=5.0)
print(f"endpoint lm-head: replicas=2 adaptive width in "
      f"[{router.metrics()['endpoints']['lm-head']['min_cols']}, "
      f"{router.metrics()['endpoints']['lm-head']['max_cols']}]")

xs = [torch.as_tensor(rng.standard_normal((b, 512)), dtype=torch.float32,
                     device=dev)
      for _ in range(32)]
router.call("lm-head", xs[0], tenant="pro")          # warm both replicas
router.call("lm-head", xs[0], tenant="free")

# --- contended burst: weighted-fair service + adaptive width ramp -----------
log_before = len(router.dispatch_log("lm-head"))
router.pause()                                       # build a backlog
futs = [(tn, router.submit("lm-head", x, tenant=tn))
        for x in xs for tn in ("pro", "free")]
t0 = time.perf_counter()
router.resume()
outs = {id(f): f.result(60).cpu().numpy() for _, f in futs}
elapsed = time.perf_counter() - t0
log = router.dispatch_log("lm-head")[log_before:]
# fairness shows while BOTH tenants still queue (the drain tail is
# whoever's backlog outlived the other): cumulative service at the
# point the first tenant's last column dispatches
cols, backlog = {}, dict.fromkeys(("pro", "free"), len(xs) * b)
for e in log:
    if min(backlog.values()) <= 0:
        break
    cols[e["tenant"]] = cols.get(e["tenant"], 0) + e["cols"]
    backlog[e["tenant"]] -= e["cols"]
print(f"\nburst: {len(futs)} calls ({len(futs) * b} cols) in "
      f"{elapsed * 1e3:.1f} ms over {len(log)} rounds")
print(f"served cols while contended, pro:free = "
      f"{cols.get('pro', 0)}:{cols.get('free', 0)} (weights 3:1)")
print(f"width ramp: {[e['cols'] for e in log]} "
      f"(replicas used: {sorted({e['replica'] for e in log})})")

# --- every routed result is bitwise-identical to a direct handle call -------
ep = router.metrics()["endpoints"]["lm-head"]
handle_fleetless = None
tn0, f0 = futs[0]
rep = f0.report                                      # observed pattern
direct = plan.to_cluster(n, transport="memory")
try:
    want = direct.matvec(xs[0], done=rep.pattern).cpu().numpy()
finally:
    direct.shutdown()
print(f"parity vs direct replay of the observed pattern: "
      f"{'bitwise' if np.array_equal(outs[id(f0)], want) else 'DIVERGED'}")

# --- quiet stretch: the width collapses, solo calls fly solo ----------------
lat = []
for i, x in enumerate(2 * xs[:8]):
    t1 = time.perf_counter()
    router.call("lm-head", x, tenant="free")
    lat.append(time.perf_counter() - t1)
m = router.metrics()["endpoints"]["lm-head"]
p50 = np.percentile(np.array(lat[-8:]) * 1e3, 50)    # post-collapse tail
print(f"\nquiet: solo-call p50 {p50:.2f} ms once the width walks back "
      f"down to {m['width']} (no collection window at low load)")
print(f"tenant counters: "
      f"{ {t: v['counters']['resolved'] for t, v in m['tenants'].items()} }")

router.close()
print("\nrouter closed: queues drained, endpoints detached, owned replica "
      "fleets reaped.")
