"""End-to-end training driver: train a small LM for a few hundred steps
on the synthetic pipeline, with checkpointing and auto-resume.

Default trains a ~13M-parameter qwen3-family model for 200 steps on CPU
(a few minutes); ``--params 100m --steps 300`` scales to the ~100M-class
run on real hardware.  Loss decreases monotonically thanks to the copy
motifs planted by the pipeline.

After training, demonstrates coded gradient aggregation through the
plan API: the final step's gradients are split over k data shards and
summed exactly from any n - s workers (an aggregation-only
``repro_torch.api.CodedPlan`` with the LRU-cached per-pattern decode).

The PyTorch port of ``examples/train_lm.py``: the model, the trainer
and the aggregator live on the card unless ``--device cpu``.  The
weights are drawn from a seeded ``torch.Generator``, so the losses are
not the reference's.

    python examples/torch/train_lm.py --steps 200 [--device cpu]
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2] / "src"))

import torch

from repro_torch.configs.base import AttnConfig, ModelConfig
from repro_torch.data import DataConfig, make_pipeline
from repro_torch.models import build_model
from repro_torch.optim import AdamWConfig
from repro_torch.train import TrainConfig, Trainer

SIZES = {
    "13m": dict(n_layers=4, d_model=256, d_ff=768, n_heads=4, kv=2, hd=64),
    "30m": dict(n_layers=6, d_model=384, d_ff=1152, n_heads=6, kv=2, hd=64),
    "100m": dict(n_layers=12, d_model=640, d_ff=1920, n_heads=10, kv=2, hd=64),
}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--params", choices=SIZES, default="13m")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--vocab", type=int, default=8192)
    ap.add_argument("--lr", type=float, default=6e-4)
    ap.add_argument("--ckpt-dir", default="/tmp/repro_train_lm")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card, default) or cpu")
    args = ap.parse_args()
    dev = torch.device(args.device)

    sz = SIZES[args.params]
    cfg = ModelConfig(
        name=f"lm-{args.params}", family="dense", n_layers=sz["n_layers"],
        d_model=sz["d_model"], d_ff=sz["d_ff"], vocab=args.vocab,
        attn=AttnConfig(n_heads=sz["n_heads"], n_kv_heads=sz["kv"],
                        head_dim=sz["hd"], qk_norm=True),
        tie_embeddings=True, max_seq=args.seq, remat="none")
    model = build_model(cfg, dtype=torch.float32, device=dev)
    print(f"model: {cfg.param_count() / 1e6:.1f}M params, "
          f"{cfg.n_layers}L d={cfg.d_model}")

    dcfg = DataConfig(vocab=args.vocab, seq_len=args.seq,
                      global_batch=args.batch)
    tcfg = TrainConfig(steps=args.steps, ckpt_every=max(50, args.steps // 4),
                       ckpt_dir=args.ckpt_dir)
    trainer = Trainer(
        model, AdamWConfig(lr=args.lr, warmup_steps=args.steps // 10,
                           total_steps=args.steps), tcfg)
    _, _, hist = trainer.fit(lambda s0: make_pipeline(dcfg, s0),
                             gen=torch.Generator(device=dev).manual_seed(0))
    for h in hist:
        if h["step"] % 20 == 0 or h["step"] == args.steps - 1:
            print(f"step {h['step']:4d}  loss {h['loss']:.4f}  "
                  f"{h['dt'] * 1e3:6.0f} ms/step")
    if hist:
        first = sum(h["loss"] for h in hist[:5]) / 5
        last = sum(h["loss"] for h in hist[-5:]) / 5
        print(f"\nloss: {first:.3f} -> {last:.3f} "
              f"({'improved' if last < first else 'NOT improved'})")

    # --- coded gradient aggregation through the plan API -----------------
    import numpy as np

    from repro_torch.parallel import CodedAggregator

    n_workers, stragglers = 6, 2
    agg = CodedAggregator.build(n_workers, stragglers, seed=0, device=dev)
    k = n_workers - stragglers
    rng = np.random.default_rng(0)
    # stand-in per-shard gradients (one pytree per data shard)
    shard_grads = [
        {name: torch.as_tensor(rng.standard_normal(p.shape),
                               dtype=torch.float32, device=dev)
         for name, p in model.state_dict().items()}
        for _ in range(k)]
    payloads = [agg.worker_payload(i, shard_grads) for i in range(n_workers)]
    expect = {name: sum(g[name] for g in shard_grads)
              for name in shard_grads[0]}
    done = np.ones(n_workers, bool)
    done[rng.choice(n_workers, stragglers, replace=False)] = False
    out = agg.aggregate(payloads, done)
    err = max(float((out[name] - expect[name]).abs().max())
              for name in expect)
    print(f"coded grad aggregation: {stragglers}/{n_workers} workers lost, "
          f"sum exact to {err:.2e} "
          f"(weight {max(len(t) for t in agg.shard_assignment)} per worker)")


if __name__ == "__main__":
    main()
