"""``python -m repro_torch.obs``: trace live fleet rounds and export them.

Runs a small coded matvec workload with one deliberately slow worker,
then prints the straggler-attribution table and Prometheus metrics and
writes a Chrome trace (open at https://ui.perfetto.dev).  The plan and
the workers run on the card (``bcsr_matmul`` in each worker, the
fleet's decode by ``decode_matmul``) unless ``--device cpu`` asks for
the host.
"""

from __future__ import annotations

import argparse

import numpy as np


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.obs",
        description="trace fleet rounds, attribute stragglers, export")
    p.add_argument("--transport", default="memory",
                   choices=("memory", "pipe", "tcp"))
    p.add_argument("--rounds", type=int, default=8)
    p.add_argument("--slow-worker", type=int, default=2,
                   help="worker id to slow down (-1: none)")
    p.add_argument("--slowdown", type=float, default=40.0)
    p.add_argument("--out", default="trace.json",
                   help="Chrome trace output path")
    p.add_argument("--device", default="cuda",
                   help="where the plan and the workers compute: the "
                        "card (default) or 'cpu'")
    args = p.parse_args(argv)

    import torch  # noqa: PLC0415 (heavy; after arg errors)

    from ..api import compile_plan  # noqa: PLC0415
    from ..api.fleet import CodedFleet  # noqa: PLC0415
    from ..cluster.faults import adversarial_faults  # noqa: PLC0415
    from . import (  # noqa: PLC0415
        Tracer, attribute, prometheus_text, write_chrome_trace)

    n, k, b = 8, 6, 4
    dev = torch.device(args.device)
    rng = np.random.default_rng(7)
    mask = np.kron(rng.random((16, 12)) >= 0.9, np.ones((8, 8)))
    A = torch.from_numpy((rng.standard_normal((128, 96)) * mask)
                         .astype(np.float32))
    plan = compile_plan(A, scheme="proposed", n=n, s=n - k,
                        backend="cuda" if dev.type == "cuda" else "packed",
                        device=dev)
    xs = [torch.from_numpy(rng.standard_normal((b, 128)).astype(np.float32))
          for _ in range(args.rounds)]

    faults = None
    if args.slow_worker >= 0:
        faults = adversarial_faults([args.slow_worker],
                                    slowdown=args.slowdown,
                                    time_scale=2e-3)
    tracer = Tracer()
    with CodedFleet(n, transport=args.transport, faults=faults,
                    tracer=tracer, device=dev) as fleet:
        h = fleet.attach(plan)
        for x in xs:
            h.matvec(x)
        rep = attribute(tracer.events())
        print(f"# {len(rep.rounds)} traced rounds on "
              f"{args.transport!r} transport, workers on {dev}")
        print(rep.table())
        print()
        tot = rep.phase_totals()
        width = max(len(k_) for k_ in tot)
        print("# critical-chain phase totals (s)")
        for name, v in sorted(tot.items(), key=lambda kv: -kv[1]):
            print(f"  {name:<{width}} {v:.4f}")
        print(f"\n# wasted work: {rep.wasted_work():.1f} units")
        print("\n# prometheus")
        print(prometheus_text(fleet=fleet, tracer=tracer))
        n_ev = write_chrome_trace(args.out, tracer, fleet=fleet)
    print(f"wrote {n_ev} trace events to {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
