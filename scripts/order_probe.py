#!/usr/bin/env python3
"""Does ``bcsr_matmul``'s plain version sum in the kernel's order at
every operand width N, and which of the two is nearer the exact product?

    python3 scripts/order_probe.py [--seed N] [--widths 1,2,3,4,8]

Builds ``run_chaos``'s operand (a (3072, 32064) f32 matrix with 10% of
its 8x8 tiles nonzero, from ``--seed``), compiles it as ``proposed``,
n=6, s=2 on the card, and for each width N multiplies the live workers'
tiles by a seeded (3072, N) operand four ways: the kernel, its plain
version, the plain version of the operand with one zero column appended
(the column dropped after), and the plain version in f64.  Then the same
for one card worker's task (the shard re-tiled as ``CardTask`` holds
it).  Prints one JSON line per (form, N): the largest differences
between the kernel and each of the others, whether they are bitwise
equal, and each f32 result's largest error against f64 over the largest
sum of |terms| of an output (the scale of the rounding a sum may show).
It fails only where a step fails.  Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.api import compile_plan  # noqa: E402
from repro_torch.cluster.wire import plan_packed, shard_plan  # noqa: E402
from repro_torch.cluster.worker import CardTask  # noqa: E402
from repro_torch.kernels import bcsr_matmul, bcsr_matmul_plain  # noqa: E402


def compare(form: str, n_cols: int, run, run_plain, run_f64, scale) -> dict:
    """One line: the kernel (run) against its plain version at N and at
    N + 1 with a zero column, and both against f64."""
    got, plain = run(n_cols), run_plain(n_cols)
    padded = run_plain(n_cols, pad=True)
    exact = run_f64(n_cols)
    torch.cuda.synchronize()
    mag = float(scale(n_cols).max())

    def diff(a, b):
        return float((a.double() - b.double()).abs().max())

    return {"form": form, "N": n_cols, "shape": list(got.shape),
            "kernel_vs_plain": diff(got, plain),
            "kernel_vs_plain_bitwise": bool(torch.equal(got, plain)),
            "kernel_vs_plain_padded": diff(got, padded),
            "kernel_vs_plain_padded_bitwise": bool(torch.equal(got, padded)),
            "kernel_vs_f64": diff(got, exact), "plain_vs_f64": diff(plain,
                                                                    exact),
            "max_abs_terms_sum": mag}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--widths", default="1,2,3,4,8")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("order_probe.py needs a CUDA device; none found")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    t, r = 3072, 32064
    rng = np.random.default_rng(args.seed)
    mask = rng.random((t // 8, r // 8)) >= 0.9
    A = torch.from_numpy((rng.standard_normal((t, r)) * np.kron(
        mask, np.ones((8, 8)))).astype(np.float32)).to(dev)
    plan = compile_plan(A, scheme="proposed", n=6, s=2, backend="cuda",
                        device=dev)
    ex = plan.executor
    done = np.ones(plan.n, bool)
    done[[1, 4]] = False
    dplan = ex.cache.plan(done)
    packed, rows = ex.packed, dplan.rows_dev
    widths = [int(w) for w in args.widths.split(",")]
    xs = {n: torch.from_numpy(rng.standard_normal((t, n)).astype(
        np.float32)).to(dev) for n in widths}

    def with_zero(b):
        return torch.cat([b, torch.zeros_like(b[:, :1])], 1)

    def plain_of(a_data, a_idx, b_of, rows_, counts, mb):
        def run(n, pad=False):
            b = b_of(n)
            out = bcsr_matmul_plain(a_data, a_idx, with_zero(b) if pad
                                    else b, rows_, mb=mb, counts=counts)
            return out[:, :n]
        return run

    # the in-process plan: every live worker in one launch
    b_mv = xs.__getitem__
    live = ex.coded[rows.long()]                      # (k, t, c) dense

    def mv_f64(n):
        return torch.einsum("ktc,tn->kcn", live.double(),
                            b_mv(n).double()).reshape(-1, n)

    def mv_scale(n):
        return torch.einsum("ktc,tn->kcn", live.double().abs(),
                            b_mv(n).double().abs()).reshape(-1, n)

    pad_rows = packed.c_pad - packed.c

    def mv_trim(out, n):        # drop each worker's pad columns of A
        return out.view(plan.k, packed.c_pad, n)[:, :packed.c].reshape(-1, n)

    for n in widths:
        def run(n_):
            return mv_trim(bcsr_matmul(packed.a_data, packed.a_idx, b_mv(n_),
                                       rows, mb=packed.mb,
                                       counts=packed.counts), n_)
        plain = plain_of(packed.a_data, packed.a_idx, b_mv, rows,
                         packed.counts, packed.mb)
        print(json.dumps(compare(
            "plan mv", n, run, lambda n_, pad=False: mv_trim(
                plain(n_, pad), n_), mv_f64, mv_scale) | {
                    "pad_rows": pad_rows}), flush=True)

    # one card worker's task, as a card worker holds it
    shard = shard_plan(plan, plan.n, packed=plan_packed(plan))[0]
    task = CardTask(shard, shard.tasks[0], dev)
    tp = task.packed
    dense = ex.coded[shard.task_rows[0]]              # (t, c)

    def b_task(n):
        b = torch.zeros((shard.t_pad, n), device=dev)
        b[:t] = xs[n]
        return b

    for n in widths:
        plain = plain_of(tp.a_data, tp.a_idx, b_task, None, tp.counts, tp.mb)
        print(json.dumps(compare(
            "worker task", n,
            lambda n_: bcsr_matmul(tp.a_data, tp.a_idx, b_task(n_),
                                   mb=tp.mb, counts=tp.counts)[:dense.shape[1]],
            lambda n_, pad=False: plain(n_, pad)[:dense.shape[1]],
            lambda n_: dense.double().T @ xs[n_].double(),
            lambda n_: dense.double().abs().T @ xs[n_].double().abs())),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
