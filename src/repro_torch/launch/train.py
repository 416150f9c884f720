"""Training launcher CLI.

    PYTHONPATH=src python -m repro_torch.launch.train --arch phi3-mini-3.8b \
        --steps 12                               # full config, on the card
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-14b \
        --smoke --device cpu --steps 50 --batch 8 --seq 128 \
        --ckpt-dir /tmp/run1

Runs the training substrate on one device: synthetic seekable data
pipeline, AdamW + cosine schedule, gradient accumulation/compression,
atomic checkpoints (in the JAX package's layout) with auto-resume,
straggler-step detection.  ``--smoke`` builds the reduced config in f32,
a full config builds bf16.  The flags and printed lines are those of
``python -m repro.launch.train``; ``--device`` (default ``cuda``) is the
port's own.  ``build`` and ``train`` are the steps of ``main``, for
callers that drive the same path.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

import torch

from ..api.schemes import scheme_names
from ..configs import ARCH_IDS, get_config, get_smoke_config
from ..data import DataConfig, make_pipeline
from ..models import build_model
from ..optim import AdamWConfig, CompressionConfig
from ..runtime import BACKENDS, ENV_BACKEND, resolve_backend
from ..train import TrainConfig, Trainer


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compress", choices=("none", "int8", "topk"),
                    default="none")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--scheme",
                    choices=scheme_names("mv", resilient_only=True),
                    default="proposed",
                    help="registered coded scheme recorded in the model "
                         "config's CodedConfig (consumed wherever the "
                         "config's coded components are built, e.g. a "
                         "checkpoint later served with a coded LM head)")
    ap.add_argument("--coded-backend", choices=BACKENDS + ("auto",),
                    default=None,
                    help="force the coded-execution backend for every "
                         "coded component in this run ('auto' re-enables "
                         "the per-plan density pick, see repro_torch.api)")
    ap.add_argument("--device", default="cuda",
                    help="where the model trains (cuda, or cpu for --smoke)")
    return ap.parse_args(argv)


def build(args):
    """-> (cfg, model, trainer, data config); the model's weights are
    drawn when ``train`` fits."""
    if args.coded_backend:
        os.environ[ENV_BACKEND] = args.coded_backend
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.scheme != cfg.coded.scheme:
        cfg = cfg.with_(coded=dataclasses.replace(cfg.coded,
                                                  scheme=args.scheme))
    if cfg.family in ("audio",):
        raise SystemExit("use examples/train_lm.py for enc-dec training")
    model = build_model(cfg, dtype=torch.float32 if args.smoke
                        else torch.bfloat16, device=args.device)
    devices = torch.cuda.device_count() if model.device.type == "cuda" \
        else 1
    print(f"arch={cfg.name} params~{cfg.param_count() / 1e6:.1f}M "
          f"devices={devices} "
          f"coded_backend={resolve_backend(device=model.device)} "
          f"coded_scheme={cfg.coded.scheme}")
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                      global_batch=args.batch, seed=args.seed)
    tcfg = TrainConfig(
        steps=args.steps, microbatches=args.microbatches,
        log_every=args.log_every, ckpt_every=args.ckpt_every,
        ckpt_dir=args.ckpt_dir,
        compression=CompressionConfig(mode=args.compress))
    trainer = Trainer(model, AdamWConfig(lr=args.lr,
                                         warmup_steps=args.steps // 10,
                                         total_steps=args.steps), tcfg)
    return cfg, model, trainer, dcfg


def train(args, trainer: Trainer, dcfg: DataConfig):
    """Fit from ``--seed``, print the reference launcher's lines ->
    ``trainer.fit``'s (params, opt_state, history)."""
    gen = torch.Generator(trainer.model.device).manual_seed(args.seed)
    params, opt_state, history = trainer.fit(
        lambda start: make_pipeline(dcfg, start), gen=gen)
    for h in history:
        if h["step"] % args.log_every == 0 or h["step"] == args.steps - 1:
            print(f"step {h['step']:5d}  loss {h['loss']:.4f}  "
                  f"lr {h['lr']:.2e}  gnorm {h['grad_norm']:.2f}  "
                  f"{h['dt'] * 1e3:.0f} ms")
    if trainer.stragglers:
        print(f"straggler steps detected: {trainer.stragglers}")
    if history:
        print(json.dumps({"final_loss": history[-1]["loss"],
                          "steps": len(history)}))
    return params, opt_state, history


def main(argv=None) -> None:
    args = parse_args(argv)
    _, _, trainer, dcfg = build(args)
    train(args, trainer, dcfg)


if __name__ == "__main__":
    main()
