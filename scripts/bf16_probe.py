#!/usr/bin/env python3
"""How far does a bf16 model's prefill drift from its own fresh forward,
and what makes it drift?

    python3 scripts/bf16_probe.py [--seed N] [--archs a,b] [--depths 6,12]

For each config (full width, weights drawn from ``--seed`` on the card)
and each depth (the first layers of the full config; 0 = full depth),
prefills a wave of 4 prompts of 9 tokens and compares the last logits
with a fresh forward over the prompt plus 16 more tokens at the same
position, as ``chip_smoke.py``'s cache check does: in bf16 with the
library's default reduced-precision bf16 reductions, in bf16 with them
off (``torch.backends.cuda.matmul.allow_bf16_reduced_precision_
reduction``), and in f32 on the same weights.  Prints one JSON line per
(config, depth): each relative error against max|logit|.  The prefill
and the forward compute the same positions over different sequence
lengths, so they differ only in how the library orders their sums (an
MoE config runs at a capacity where no slot drops: at its published
capacity a longer forward drops other slots).  Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import build_model  # noqa: E402


def drift(model, toks: torch.Tensor) -> float:
    """max |prefill logits - forward logits at the same position| over
    max |forward logits|."""
    with torch.inference_mode():
        last, _ = model.prefill(toks[:, :9], max_len=64)
        full, _ = model(toks)
    want = full[:, 8].double()
    return float((last.double() - want).abs().max() / want.abs().max())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--archs", default="mamba2-1.3b,zamba2-2.7b,"
                    "phi-3-vision-4.2b,granite-moe-1b-a400m")
    ap.add_argument("--depths", default="6,12,24,0")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bf16_probe.py needs a CUDA device; none found")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(args.seed)
    for arch in args.archs.split(","):
        full = get_config(arch)
        p = len(full.pattern)
        toks = torch.as_tensor(rng.integers(2, full.vocab, (4, 25)),
                               device=dev)
        depths = sorted({int(d) or full.n_layers
                         for d in args.depths.split(",")})
        for layers in depths:
            if layers > full.n_layers or layers % p:
                continue
            cfg = full.with_(n_layers=layers)
            if cfg.moe is not None:     # no slot drops: see the docstring
                cfg = cfg.with_(moe=dataclasses.replace(
                    cfg.moe, capacity_factor=cfg.moe.n_experts
                    / cfg.moe.top_k))
            model = build_model(cfg, torch.bfloat16, device=dev)
            params = model.init(torch.Generator(dev).manual_seed(args.seed))
            row = {"arch": arch, "layers": layers,
                   "bf16": drift(model, toks)}
            prev = torch.backends.cuda.matmul.\
                allow_bf16_reduced_precision_reduction
            torch.backends.cuda.matmul.\
                allow_bf16_reduced_precision_reduction = False
            try:
                row["bf16_full_reductions"] = drift(model, toks)
            finally:
                torch.backends.cuda.matmul.\
                    allow_bf16_reduced_precision_reduction = prev
            del model
            model32 = build_model(cfg, torch.float32, device=dev)
            model32.load_state_dict(params)
            row["f32"] = drift(model32, toks)
            del model32, params
            torch.cuda.empty_cache()
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
