#!/usr/bin/env python3
"""Does a ``torch.profiler`` trace keep every launch of the port's decode
in the states ``chip_smoke.py``'s cluster phase leaves its process in,
and what takes the launches it loses?

    python3 scripts/trace_probe.py [--seed N] [--calls 20] [--takes 3]

Builds the coded LM head of the cluster phase (a random bf16 (3072,
32064) head, ``proposed``, n=6, s=2, card workers) and the inputs of its
``decode_matmul`` row (the fleet's decode of the head), then traces
``--calls`` launches of that decode, and as many of a library kernel
(``torch.add``), ``--takes`` times in each state, in this order:

  fresh            nothing but the plan;
  memory_alive     a memory-transport cluster of the head after 25 rounds;
  memory_closed    after it shut down;
  imports_alive    six spawned processes that import torch, no CUDA;
  imports_closed   after they exited;
  contexts_alive   six spawned processes that each open a CUDA context
                   on the card (nothing of the port);
  contexts_closed  after they exited;
  pipe_alive       a pipe-transport cluster (six card children) after 5
                   rounds;
  pipe_closed      after its shutdown reaped the children;
  raced            after one racing round (``done=None``) under
                   ``StragglerFaults``, that cluster shut down too.

In the last state it also traces the decode with a 0.5 s margin on
either side of the calls (against 0.05 s), and with one untraced-for-
count ``torch.add`` and a synchronise first inside the window (primed).

Prints one JSON line per take: the state, the launches the counters
saw, the port kernels and all device activities the trace holds, the
host's kernel-launch calls it holds (``cudaLaunchKernel`` and kin), which
of those calls (by order) have no device activity of their correlation
id, and the gaps (us) from each launch call to the next.  A short trace
is what this measures, so it does not fail the script; a failing step
does.  Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing as mp
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from chip_smoke import kernel_of  # noqa: E402
from repro_torch.api import compile_plan  # noqa: E402
from repro_torch.cluster import StragglerFaults  # noqa: E402
from repro_torch.kernels import bcsr_matmul, launch_counts  # noqa: E402
from repro_torch.kernels.decode_matmul import (  # noqa: E402
    launch_decode,
    prepare_decode,
)


def _child(cuda: bool, ready, stop) -> None:
    """A spawned process that imports torch and, with ``cuda``, opens a
    CUDA context on the card; it waits for ``stop``."""
    import torch as t  # noqa: PLC0415
    if cuda:
        t.zeros(1, device="cuda")
        t.cuda.synchronize()
    ready.set()
    stop.wait(120)


class Others:
    """Six spawned processes alive inside the ``with`` block."""

    def __init__(self, cuda: bool):
        ctx = mp.get_context("spawn")
        self.ready = [ctx.Event() for _ in range(6)]
        self.stop = ctx.Event()
        self.procs = [ctx.Process(target=_child, args=(cuda, r, self.stop))
                      for r in self.ready]

    def __enter__(self):
        for p in self.procs:
            p.start()
        for r in self.ready:
            if not r.wait(120):
                raise RuntimeError("a spawned process never became ready")
        return self

    def __exit__(self, *exc):
        self.stop.set()
        for p in self.procs:
            p.join(30)
        if any(p.exitcode != 0 for p in self.procs):
            raise RuntimeError(f"exit codes {[p.exitcode for p in self.procs]}")


def traced(fn, margin: float, prime: bool):
    """(host events, device events) of ``fn()`` in one profiler trace,
    each (name, start ns, end ns, correlation id), in start order."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(margin)
        if prime:
            torch.add(torch.zeros(1, device="cuda"), 1.0)
            torch.cuda.synchronize()
        fn()
        torch.cuda.synchronize()
        time.sleep(margin)
    host, dev = [], []
    for e in prof.profiler.kineto_results.events():
        row = (e.name(), e.start_ns(), e.end_ns(), e.correlation_id())
        (dev if "CUDA" in str(e.device_type()) else host).append(row)
    return sorted(host, key=lambda a: a[1]), sorted(dev, key=lambda a: a[1])


def take(state: str, what: str, fn, calls: int, port: bool,
         margin: float = 0.05, prime: bool = False) -> dict:
    before = launch_counts()
    host, dev = traced(lambda: [fn() for _ in range(calls)], margin, prime)
    counted = {k: v - before[k] for k, v in launch_counts().items()}
    mine = [a for a in dev if (kernel_of(a[0]) is not None) == port
            and (port or "add" in a[0].lower() or "elementwise" in a[0])]
    launches = [h for h in host if "LaunchKernel" in h[0]]
    if prime:
        launches = launches[1:]
    seen = {a[3] for a in dev}
    row = {
        "state": state, "what": what, "calls": calls, "margin_s": margin,
        "primed": prime, "counters": counted if port else None,
        "device_kernels_of_call": len(mine),
        "device_activities": len(dev),
        "host_launch_calls": len(launches),
        "launch_calls_without_device_record": [
            i for i, h in enumerate(launches) if h[3] not in seen],
        "launch_gaps_us": [round((b[1] - a[1]) / 1e3, 1)
                           for a, b in zip(launches, launches[1:])],
        "first_device_after_first_launch_us": (
            (mine[0][1] - launches[0][1]) / 1e3 if mine and launches
            else None),
        "device_durations_us": [round((a[2] - a[1]) / 1e3, 2)
                                for a in mine],
    }
    row["whole"] = row["device_kernels_of_call"] == calls
    print(json.dumps(row), flush=True)
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--calls", type=int, default=20)
    ap.add_argument("--takes", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("trace_probe.py needs a CUDA device; none found")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    head = torch.randn(3072, 32064, device=dev, generator=gen,
                       dtype=torch.bfloat16)
    hidden = torch.randn(2, 3072, device=dev, generator=gen,
                         dtype=torch.bfloat16)
    plan = compile_plan(head, scheme="proposed", n=6, s=2, seed=args.seed,
                        backend="cuda", device=dev)
    faults = StragglerFaults(rng=np.random.default_rng(0))
    masks = [faults.mask(6, 2) for _ in range(5)]
    # the decode row's inputs: the k live (c_pad, 2) products of the head
    ex = plan.executor
    dplan = ex.cache.plan(masks[0])
    y = bcsr_matmul(ex.packed.a_data, ex.packed.a_idx, hidden.T.contiguous(),
                    dplan.rows_dev, mb=ex.packed.mb, counts=ex.packed.counts)
    y = y.view(ex.k, ex.packed.c_pad, -1).contiguous()
    kw = {"c": ex.packed.c, "r": ex.r}
    layout = prepare_decode(dplan.hinv_dev, y, "mv", **kw)
    a = torch.zeros(1024, device=dev)

    def decode():
        return launch_decode(layout, dplan.hinv_dev, y, None)

    def library():
        return torch.add(a, 1.0)

    rows = []

    def probe(state: str) -> None:
        torch.cuda.synchronize()
        for _ in range(args.takes):
            rows.append(take(state, "decode_matmul", decode, args.calls,
                             True))
        rows.append(take(state, "torch.add", library, args.calls, False))

    decode()
    library()
    probe("fresh")
    with plan.to_cluster(transport="memory") as cl:
        for i in range(25):
            cl.matvec(hidden, masks[i % 5])
        probe("memory_alive")
    probe("memory_closed")
    with Others(cuda=False):
        probe("imports_alive")
    probe("imports_closed")
    with Others(cuda=True):
        probe("contexts_alive")
    probe("contexts_closed")
    with plan.to_cluster(transport="pipe") as cl:
        for m in masks:
            cl.matvec(hidden, m)
        probe("pipe_alive")
    probe("pipe_closed")
    with plan.to_cluster(transport="memory", faults=StragglerFaults(
            time_scale=0.05, seed=args.seed)) as race:
        race.matvec(hidden)
    probe("raced")
    for _ in range(args.takes):
        rows.append(take("raced", "decode_matmul", decode, args.calls, True,
                         margin=0.5))
        rows.append(take("raced", "decode_matmul", decode, args.calls, True,
                         prime=True))
    summary = {}
    for r in rows:
        key = (f"{r['state']}/{r['what']}"
               + (f"/margin {r['margin_s']}" if r["margin_s"] != 0.05 else "")
               + ("/primed" if r["primed"] else ""))
        summary.setdefault(key, []).append(
            f"{r['device_kernels_of_call']}/{r['calls']}")
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
