"""End-to-end round tracing + straggler attribution (repro_torch.obs).

The paper's whole premise is that stragglers dominate edge wall-clock
-- but a production fleet needs to know *which* worker is slow and in
*which phase* (wire? queue? compute?) before it can act.  This example
threads a ``Tracer`` through a live fleet:

  * every round becomes a span tree -- coordinator queue, per-worker
    wire-out / worker-queue / compute / wire-back, decode -- on one
    monotonic timeline (worker clocks are re-anchored via the
    transport's hello clock handshake, tightened per traced result);
  * one worker is deliberately made 40x slower; ``attribute()`` names
    it from the trace alone (rounds decoded *without* it, its measured
    compute rate) and its rate feeds ``worker_capacities(rates=...)``
    -- the capacity vector heterogeneity-aware schemes virtualize
    devices with;
  * the merged timeline ships as a Chrome trace: open trace_round.json
    at https://ui.perfetto.dev and look at the per-worker tracks.

Tracing costs one pointer check per instrumented site when disabled
(tracer=None, the default); flip it on globally with REPRO_TRACE=1.

The PyTorch port of ``examples/trace_round.py``.  ``packed`` is the
host block-sparse path (scipy BSR), so the plan and the fleet's host
workers live on the CPU whichever ``--device`` is given.

    python examples/torch/trace_round.py [--device cpu]
"""

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2] / "src"))

import numpy as np
import torch

from repro_torch.api import CodedFleet, compile_plan
from repro_torch.cluster.faults import adversarial_faults
from repro_torch.obs import Tracer, attribute, write_chrome_trace

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda",
                help="cuda (default) or cpu; a packed plan is a host plan")
ap.parse_args()

rng = np.random.default_rng(0)
n, s, b = 8, 2, 4
SLOW = 3

mask = np.kron(rng.random((32, 24)) >= 0.95, np.ones((8, 8)))
A = torch.as_tensor((rng.standard_normal((256, 192)) * mask)
                    .astype(np.float32))
plan = compile_plan(A, scheme="proposed", n=n, s=s, backend="packed",
                    device="cpu")
xs = [torch.as_tensor(rng.standard_normal((b, 256)), dtype=torch.float32)
      for _ in range(12)]

tracer = Tracer()
with CodedFleet(n, transport="memory", tracer=tracer, device="cpu",
                faults=adversarial_faults([SLOW], slowdown=40.0,
                                          time_scale=2e-3)) as fleet:
    for i, x in enumerate(xs):
        h = fleet.attach(plan) if i == 0 else h
        h.matvec(x)
        time.sleep(0.01)        # pace: let healthy workers drain

    report = attribute(tracer.events())
    print(f"traced {len(report.rounds)} rounds; "
          f"worker {SLOW} seeded 40x slow\n")
    print(report.table())

    print("\nwhere does round latency go? (critical-chain segment "
          "totals)")
    totals = report.phase_totals()
    for phase, total in sorted(totals.items(), key=lambda kv: -kv[1]):
        print(f"  {phase:<13} {total * 1e3:8.2f} ms total")

    suspect = report.suspects()[0]
    print(f"\nattribution's top suspect: worker {suspect} "
          f"({'correct' if suspect == SLOW else 'WRONG'})")
    print(f"wasted work (computed but not decoded): "
          f"{report.wasted_work():.1f} units")

    # traced compute rates -> capacity levels for hetero-aware schemes
    rates = report.compute_rates()
    ws = sorted(report.workers)
    caps = fleet.worker_capacities(workers=ws, rates=rates)
    print("\ntraced compute rate -> capacity level:")
    for w, cap in zip(ws, caps):
        rate = rates.get(w)
        shown = f"{rate:7.1f} work/s" if rate else "   (no sample)"
        print(f"  worker {w}: {shown} -> level {cap}"
              + ("   <- seeded straggler" if w == SLOW else ""))

    n_events = write_chrome_trace("trace_round.json", tracer,
                                  fleet=fleet)
print(f"\nwrote {n_events} events to trace_round.json "
      f"(open at https://ui.perfetto.dev)")
