#!/usr/bin/env python3
"""Compare two checkouts' matvec and matmat p50 on one card, in turns.

    python3 scripts/ab_smoke.py PARENT_DIR [CHANGE_DIR] [--rounds N]

Measures each checkout's port in its own process, in the order parent,
change, change, parent (``--rounds`` times, 2 by default), so that both meet
the same card and the same drift.  Each process imports the port from
its checkout's ``src`` and times, through the public API only:

  * the coded LM head of ``chip_smoke.py`` (A = 3072 x 32064, n=16, s=2,
    8 requests, stragglers {3, 11}): ``plan.matvec`` p50 over 1000 calls,
    f32 and with A in bf16;
  * its Fig. 4 system (8192 x 4096 operands, 98% zero 32x32 tiles, n=20,
    k_A=k_B=4, 4 stragglers): ``plan.matmat`` p50 over 100 calls.

Each call is timed on the host clock and ends in a device synchronise,
after 20 untimed calls.  Beside each p50, ``*_device_ms`` is the device
time one call keeps the card busy (the summed durations of its device
activities in a ``torch.profiler`` trace of 20 calls, per call, the
median of three traces), which
host noise does not reach.  Prints one JSON line per process and a summary
with each metric's values by checkout; exits non-zero when a process
fails.  CHANGE_DIR defaults to the checkout holding this script.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ORDER = ("parent", "change", "change", "parent")


def measure(seed: int = 0) -> dict:
    """The p50s of the checkout in the working directory (run there)."""
    import numpy as np
    import torch
    sys.path.insert(0, "src")
    from repro_torch.api import compile_plan

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(seed)

    def p50(fn, reps: int) -> float:
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(times))

    def device_ms(fn, calls: int = 20, traces: int = 3) -> float:
        # the profiler now and then loses activities from a trace, which
        # only lowers its sum: the median of a few traces stands
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        sums = []
        for _ in range(traces):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(calls):
                    fn()
                torch.cuda.synchronize()
            sums.append(sum(e.time_range.end - e.time_range.start
                            for e in prof.events()
                            if e.device_type == DeviceType.CUDA))
        return float(np.median(sums)) / calls / 1e3

    res = {}
    A = torch.randn((3072, 32064), generator=gen, device=dev)
    x = torch.randn((8, 3072), generator=gen, device=dev)
    done = np.ones(16, bool)
    done[[3, 11]] = False
    for dtype in (torch.float32, torch.bfloat16):
        plan = compile_plan(A.to(dtype), scheme="proposed", n=16, s=2,
                            backend="cuda", seed=seed)
        xd = x.to(dtype)
        key = str(dtype).removeprefix("torch.")
        res[f"matvec_p50_ms_{key}"] = p50(lambda: plan.matvec(xd, done), 1000)
        res[f"matvec_device_ms_{key}"] = device_ms(
            lambda: plan.matvec(xd, done))
        del plan
    del A

    def block_sparse(t, r):
        keep = torch.rand((t // 32, r // 32), generator=gen, device=dev) >= 0.98
        mask = keep.repeat_interleave(32, 0).repeat_interleave(32, 1)
        return torch.randn((t, r), generator=gen, device=dev) * mask

    A, B = block_sparse(8192, 4096), block_sparse(8192, 4096)
    plan = compile_plan(A, scheme="proposed", n=20, k_A=4, k_B=4,
                        backend="cuda", seed=seed)
    done = np.ones(20, bool)
    done[[2, 7, 11, 17]] = False
    res["matmat_p50_ms"] = p50(lambda: plan.matmat(B, done), 100)
    res["matmat_device_ms"] = device_ms(lambda: plan.matmat(B, done), 5)
    res["device"] = torch.cuda.get_device_name(0)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("parent", type=Path, nargs="?")
    ap.add_argument("change", type=Path, nargs="?",
                    default=Path(__file__).resolve().parents[1])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--measure", action="store_true",
                    help="measure the checkout in the working directory")
    args = ap.parse_args(argv)
    if args.measure:
        print(json.dumps(measure()), flush=True)
        return 0
    if args.parent is None:
        ap.error("PARENT_DIR is required")
    runs, failed = [], False
    for i, which in enumerate(ORDER * args.rounds):
        root = getattr(args, which).resolve()
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--measure"],
            cwd=root, capture_output=True, text=True, timeout=900)
        run = {"run": i, "which": which, "rc": proc.returncode}
        if proc.returncode == 0:
            run.update(json.loads(proc.stdout.strip().splitlines()[-1]))
        else:
            run["stderr"] = proc.stderr[-2000:]
        print(json.dumps(run), flush=True)
        runs.append(run)
        failed |= proc.returncode != 0
    summary = {}
    for key in ("matvec_p50_ms_float32", "matvec_p50_ms_bfloat16",
                "matmat_p50_ms", "matvec_device_ms_float32",
                "matvec_device_ms_bfloat16", "matmat_device_ms"):
        for which in ("parent", "change"):
            summary[f"{key}_{which}"] = [r.get(key) for r in runs
                                         if r["which"] == which]
    print(json.dumps({"summary": summary, "ok": not failed}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
