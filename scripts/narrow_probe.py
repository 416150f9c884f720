#!/usr/bin/env python3
"""Time ``bcsr_matmul``'s narrow path (N < 64) alone at the shapes its
callers run, against its bound, and check it against its plain version.

    python3 scripts/narrow_probe.py [--root DIR] [--cases a,b] [--reps N]

Each case draws a dense head from the seed on the card, compiles it as
the serve launcher does (``proposed``, n workers, s stragglers, the
``cuda`` backend) and multiplies the first k live workers' packed shards
by a (t, N) f32 (or bf16) operand, as ``plan.matvec`` does (``worker`` cases: one
worker's block-rows alone, as a card worker's task).  Per (case, N) it
prints one JSON line: the mean device time of ``reps`` back-to-back
launches by CUDA events, the least time the bytes need at 3.35 TB/s
(the live tiles read once, B's rows, C written once), their ratio, and
whether the result is bitwise its plain version.  ``--root`` imports
``repro_torch`` from ``DIR/src`` (another checkout, for a comparison in
one process tree).  Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

HBM_BYTES_PER_S = 3.35e12
F32, BF16 = torch.float32, torch.bfloat16

# name: (hidden t, output columns, A dtype, n, s, widths, form[, B dtype])
CASES = {
    "cell": (7168, 163840, BF16, 6, 2, range(1, 9), "plan"),
    "mv": (3072, 32064, F32, 16, 2, (8,), "plan"),
    "mv-bf16": (3072, 32064, BF16, 16, 2, (8,), "plan"),
    "mv-bf16-x": (3072, 32064, BF16, 16, 2, (8,), "plan", BF16),
    "serve": (3072, 32064, BF16, 6, 2, (2,), "plan"),
    "task": (3072, 32064, F32, 6, 2, (2, 8, 32), "worker"),
    "moe-gate": (1024, 512, F32, 6, 2, (4, 24), "plan"),
    "moe-down": (512, 1024, F32, 6, 2, (4, 24), "plan"),
    "granite": (1024, 49155, BF16, 6, 2, (2,), "plan"),
    "mamba2": (2048, 50280, BF16, 6, 2, (2,), "plan"),
    "zamba2": (2560, 32000, BF16, 6, 2, (2,), "plan"),
}


def cuda_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def run_case(name: str, reps: int, seed: int, kernels, compile_plan):
    t, m, dtype, n, s, widths, form, *b_dtype = CASES[name]
    b_dtype = b_dtype[0] if b_dtype else F32
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    head = torch.randn((t, m), generator=gen, device=dev, dtype=dtype)
    plan = compile_plan(head, scheme="proposed", n=n, s=s, seed=0,
                        backend="cuda")
    del head
    packed = plan.executor.packed
    k = n - s
    if form == "worker":
        a_data, a_idx = packed.worker_view(0)
        args = dict(mb=packed.mb, counts=packed.counts[:packed.mb])
        rows, n_rows = None, packed.mb
    else:
        a_data, a_idx = packed.a_data, packed.a_idx
        rows = torch.arange(k, dtype=torch.int32, device=dev)
        args = dict(mb=packed.mb, counts=packed.counts)
        n_rows = k * packed.mb
    tiles = int(packed.counts.view(packed.n, packed.mb)
                [:1 if form == "worker" else k].sum())
    for w in widths:
        b = torch.randn((w, packed.t), generator=gen, device=dev).T \
            .contiguous().to(b_dtype)
        out = kernels.bcsr_matmul(a_data, a_idx, b, rows, **args)
        plain = kernels.bcsr_matmul_plain(a_data, a_idx, b, rows, **args)
        torch.cuda.synchronize()
        ms = cuda_ms(lambda: kernels.bcsr_matmul(a_data, a_idx, b, rows,
                                                 **args), reps)
        nbytes = (tiles * 1024 * a_data.element_size() + tiles * 4
                  + packed.t * w * b.element_size() + n_rows * 32 * w * 4)
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        print(json.dumps({
            "case": name, "N": w, "dtype": str(dtype).split(".")[-1],
            "b_dtype": str(b_dtype).split(".")[-1],
            "block_rows": n_rows, "slots": tiles, "ms": round(ms, 5),
            "bound_ms": round(bound, 5), "share": round(bound / ms, 4),
            "bitwise_plain": bool(torch.equal(out, plain)),
            "max_abs_diff": float((out - plain).abs().max())}), flush=True)
        del out, plain


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve()
                                          .parents[1]))
    ap.add_argument("--cases", default=",".join(CASES))
    ap.add_argument("--reps", type=int, default=100)
    ap.add_argument("--seed", type=int, default=1234)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve() / "src"))
    from repro_torch import kernels
    from repro_torch.api import compile_plan
    from repro_torch.kernels import _build
    _build.library()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(json.dumps({"root": args.root, "card": card,
                      "torch": torch.__version__,
                      "build": dict(_build.build_info)}), flush=True)
    for name in args.cases.split(","):
        run_case(name, args.reps, args.seed, kernels, compile_plan)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
