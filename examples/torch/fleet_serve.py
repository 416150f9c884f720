"""One fleet, many consumers: the LM head and the gradient aggregator
serving off the same persistent worker session.

Before the fleet redesign every consumer of coded compute hoarded its
own cluster (one transport, one worker set, one blocking round at a
time).  Here a single ``CodedFleet`` owns the workers; the serving
engine's coded LM head and a ``CodedAggregator`` both *attach* to it --
their shards co-hosted on the same devices, their rounds multiplexed
over one long-lived dispatcher loop:

  * **futures + pipelining** -- a burst of decode-step matvecs is
    submitted as ``CodedFuture``s and collected later, with several
    rounds in flight at once;
  * **microbatching** -- queued matvecs coalesce into wider rounds
    (operand columns packed side by side, the MM-regime amortization);
    the per-round reports show multiple calls resolved per round;
  * **shared capacity** -- gradient aggregation rounds interleave with
    the head's rounds on the same workers, no second fleet required;
  * ``engine.close()`` only *detaches* the head's plan -- the fleet
    keeps serving the aggregator until its owner closes it.

The PyTorch port of ``examples/fleet_serve.py``: the fleet's workers,
the model and the aggregator live on the card (``cuda`` card workers:
``bcsr_matmul`` per task, ``decode_matmul`` per round) unless
``--device cpu``.  The model's weights are drawn from a seeded
``torch.Generator``, so they are not the reference's.

    python examples/torch/fleet_serve.py [--device cpu]
"""

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2] / "src"))

import numpy as np
import torch

from repro_torch.api.fleet import CodedFleet
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import CodedConfig
from repro_torch.models import build_model
from repro_torch.parallel.coded_grads import CodedAggregator
from repro_torch.serve import ServeEngine

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda",
                help="cuda (the card, default) or cpu")
dev = torch.device(ap.parse_args().device)

rng = np.random.default_rng(0)
n, s = 6, 2

# --- one session for everything --------------------------------------------
fleet = CodedFleet(n, transport="memory", max_inflight=8, device=dev)

# --- consumer 1: the serve engine's coded LM head ---------------------------
cfg = get_smoke_config("qwen3-14b")
model = build_model(cfg, dtype=torch.float32, device=dev)
params = model.init(torch.Generator(device=dev).manual_seed(0))
engine = ServeEngine(
    model, params, cfg, batch_size=4, max_len=64,
    coded=CodedConfig(enabled=True, n_workers=n, stragglers=s, fleet=fleet))
head = params["embed"].T if cfg.tie_embeddings else params["head"]
print(f"head plan attached: scheme={engine.coded.scheme.name} n={n} s={s} "
      f"plan_id={engine.coded_cluster.plan_id}")

# --- consumer 2: coded gradient aggregation on the SAME workers -------------
agg = CodedAggregator.build(n, s, seed=0, device=dev)
agg_handle = agg.to_cluster(fleet=fleet)
print(f"aggregator attached: plan_id={agg_handle.plan_id} "
      f"(same transport: {fleet.transport_name})\n")

# --- a burst of decode steps as futures, gradients interleaved --------------
steps = 12
hiddens = [torch.as_tensor(rng.standard_normal((4, cfg.d_model)),
                           dtype=torch.float32, device=dev)
           for _ in range(steps)]
shard_grads = [{"w": torch.as_tensor(rng.standard_normal(64),
                                     dtype=torch.float32, device=dev)}
               for _ in range(n - s)]
payloads = [agg.worker_payload(w, shard_grads) for w in range(n)]

t0 = time.perf_counter()
logit_futs = [engine.coded_cluster.submit_matvec(h) for h in hiddens]
grad_fut = agg_handle.submit_aggregate(payloads)   # interleaves with the head
logits = [f.result() for f in logit_futs]
grad = grad_fut.result()
elapsed = time.perf_counter() - t0

worst = max(float((lg - hd @ head).abs().max())
            for lg, hd in zip(logits, hiddens))
want = sum(g["w"] for g in shard_grads).cpu().numpy()
print(f"{steps} head matvecs + 1 aggregate in {elapsed * 1e3:.1f} ms "
      f"({(steps + 1) / elapsed:.0f} calls/s)")
print(f"head max |coded - direct| = {worst:.2e}")
print(f"aggregate max |err| = {np.abs(grad['w'].cpu().numpy() - want).max():.2e}")
rounds = list(engine.coded_cluster.reports)
print(f"head rounds: {len(rounds)} for {steps} calls "
      f"(microbatch coalesced: {[r.calls for r in rounds]})\n")

# --- engine close detaches; the fleet keeps serving the aggregator ----------
engine.close()
grad2 = agg_handle.aggregate(payloads)
print(f"after engine.close(): aggregator still serving "
      f"(err {np.abs(grad2['w'].cpu().numpy() - want).max():.2e})")
fleet.close()
print("fleet closed: workers reaped, futures accounted for.")
