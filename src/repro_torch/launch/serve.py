"""Serving launcher CLI.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch phi3-mini-3.8b \
        --coded                                  # full config, on the card
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-14b \
        --smoke --device cpu --requests 8 --max-new 16 --coded

Boots a model (bf16 weights for a full config, f32 for ``--smoke``),
runs a wave of synthetic requests through the batched engine, and with
``--coded`` compiles the LM head into a straggler-resilient coded plan
and checks it under 5 random straggler patterns.  The flags and printed
lines are those of ``python -m repro.launch.serve``; ``--device``
(default ``cuda``) is the port's own.  ``build``, ``make_requests``,
``serve`` and ``check_coded_head`` are the steps of ``main``, for
callers that drive the same path.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..api.schemes import scheme_names
from ..configs import ARCH_IDS, get_config, get_smoke_config
from ..configs.base import CodedConfig
from ..models import build_model
from ..runtime import BACKENDS
from ..serve import Request, ServeEngine


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--coded", action="store_true",
                    help="serve logits through the coded LM head")
    ap.add_argument("--workers", type=int, default=6)
    ap.add_argument("--stragglers", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--scheme",
                    choices=scheme_names("mv", resilient_only=True),
                    default="proposed",
                    help="registered coded scheme for the LM head "
                         "(repro_torch.api.list_schemes; non-resilient and "
                         "capacity-based schemes are excluded)")
    ap.add_argument("--coded-backend", choices=BACKENDS + ("auto",),
                    default="auto",
                    help="coded-execution backend for the LM head "
                         "(auto = cuda on the card, else the density pick "
                         "at plan compile time, see repro_torch.api.backends)")
    ap.add_argument("--device", default="cuda",
                    help="where the model and the coded head run "
                         "(cuda, or cpu for --smoke)")
    return ap.parse_args(argv)


def build(args):
    """-> (cfg, model, params, engine), the weights drawn from
    ``--seed`` on ``--device``."""
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if cfg.family == "audio":
        raise SystemExit("audio serving needs frames; see tests/examples")
    model = build_model(cfg, dtype=torch.float32 if args.smoke
                        else torch.bfloat16, device=args.device)
    params = model.init(torch.Generator(model.device).manual_seed(args.seed))
    coded = CodedConfig(enabled=True, n_workers=args.workers,
                        stragglers=args.stragglers, scheme=args.scheme,
                        backend=args.coded_backend) if args.coded else None
    engine = ServeEngine(model, params, cfg, batch_size=args.batch,
                         max_len=args.max_len, coded=coded)
    if engine.coded is not None:
        print(f"coded LM head plan: {engine.coded.describe()}")
    return cfg, model, params, engine


def make_requests(args, cfg, rng: np.random.Generator) -> list[Request]:
    return [Request(prompt=[1] + rng.integers(2, cfg.vocab,
                                              rng.integers(2, 9)).tolist(),
                    max_new=args.max_new)
            for _ in range(args.requests)]


def serve(engine: ServeEngine, reqs: list[Request]) -> list[Request]:
    t0 = time.perf_counter()
    out = engine.run(reqs)
    dt = time.perf_counter() - t0
    tokens = sum(len(r.output) for r in out)
    print(f"served {len(out)} requests, {tokens} tokens "
          f"in {dt:.2f}s ({tokens / dt:.1f} tok/s incl. compile)")
    for i, r in enumerate(out[: min(4, len(out))]):
        print(f"  req {i}: {r.prompt[:6]}... -> {r.output}")
    return out


def check_coded_head(args, cfg, params, engine: ServeEngine,
                     rng: np.random.Generator) -> float:
    """The coded head against ``hidden @ head`` under 5 random straggler
    patterns -> the worst relative error."""
    hidden = torch.as_tensor(rng.standard_normal((2, cfg.d_model)),
                             dtype=torch.float32, device=engine.model.device)
    head = params["embed"].T if cfg.tie_embeddings else params["head"]
    ref = hidden @ head.to(hidden.dtype)
    worst = 0.0
    for _ in range(5):
        logits = engine.coded_logits(hidden)
        worst = max(worst, float((logits - ref).abs().max()
                                 / (ref.abs().max() + 1e-9)))
    print(f"coded head: 5 random straggler patterns, "
          f"worst rel err {worst:.2e} "
          f"(resilient to any {args.stragglers}/{args.workers} lost)")
    return worst


def main(argv=None) -> None:
    args = parse_args(argv)
    cfg, _, params, engine = build(args)
    rng = np.random.default_rng(args.seed)
    serve(engine, make_requests(args, cfg, rng))
    if args.coded:
        check_coded_head(args, cfg, params, engine, rng)


if __name__ == "__main__":
    main()
