"""Batched serving with a straggler-resilient coded LM head.

Serves a wave of requests through the engine, then demonstrates the
paper's feature end-to-end: the final logits matmul runs through a
precompiled CodedPlan (Alg. 1 via the scheme registry, n=6 workers,
s=2, backend="auto") under fresh random straggler masks every step --
outputs are bit-stable regardless of WHICH two workers die, and the
per-worker compute is omega/k = 2/4 of the logical matmul instead of
the k/k a dense MDS code would need.

The PyTorch port of ``examples/serve_coded.py``: on the card the
engine's head plan is a ``cuda`` plan (one ``cyclic_encode`` at build,
one ``bcsr_matmul`` + one ``decode_matmul`` per coded call);
``--device cpu`` runs their plain versions.  The model's weights are
drawn from a seeded ``torch.Generator``, so they (and the generated
tokens) are not the reference's.

    python examples/torch/serve_coded.py [--device cpu]
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2] / "src"))

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import CodedConfig
from repro_torch.models import build_model
from repro_torch.serve import Request, ServeEngine

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda",
                help="cuda (the card, default) or cpu")
dev = torch.device(ap.parse_args().device)

cfg = get_smoke_config("qwen3-14b")
model = build_model(cfg, dtype=torch.float32, device=dev)
params = model.init(torch.Generator(device=dev).manual_seed(0))

engine = ServeEngine(model, params, cfg, batch_size=4, max_len=64,
                     coded=CodedConfig(enabled=True, n_workers=6,
                                       stragglers=2, scheme="proposed",
                                       backend="auto"))
print(f"coded LM head plan: {engine.coded.describe()}")

# --- batched generation ----------------------------------------------------
reqs = [Request(prompt=[1, 17, 42], max_new=8),
        Request(prompt=[1, 5], max_new=8),
        Request(prompt=[1, 99, 3, 7], max_new=8),
        Request(prompt=[1], max_new=8)]
out = engine.run(reqs)
for i, r in enumerate(out):
    print(f"req {i}: prompt {r.prompt} -> {r.output}")

# --- coded-head resilience check -------------------------------------------
rng = np.random.default_rng(0)
hidden = torch.as_tensor(rng.standard_normal((4, cfg.d_model)),
                         dtype=torch.float32, device=dev)
head = params["embed"].T if cfg.tie_embeddings else params["head"]
ref = (hidden @ head).cpu().numpy()

print("\ncoded LM head under 5 random straggler patterns:")
for trial in range(5):
    logits = engine.coded_logits(hidden)   # fresh straggler mask inside
    err = np.max(np.abs(logits.cpu().numpy() - ref)) / np.max(np.abs(ref))
    print(f"  trial {trial}: max rel err vs uncoded head = {err:.2e}")
    assert err < 1e-2
stats = engine.coded.describe().get("decode_cache",
                                    "n/a (reference backend)")
print(f"decode cache after 5 trials: {stats}")
print("OK: any 2 of 6 workers can die; logits unchanged")
