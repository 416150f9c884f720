"""The benchmark of the PyTorch / CUDA port (``repro_torch``) on one H100.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Runs one cell of ``BENCHMARK.json`` (see ``harness.py``): sets it up from
the seed, measures for ``--seconds``, compares the window's sampled
results with the plain reference, and prints one JSON object as the last
line of standard output, after diagnostic lines and the compared numbers
beside their limits on standard error.  Exits 2 without a result where
there is no card, the cell cannot be resolved, or the measuring process
has loaded JAX or the JAX package.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    harness.set_environment()
    try:
        result = harness.run_cell(args.workload, args.seed, args.seconds,
                                  bool(args.trace))
    except harness.BenchError as exc:
        print(f"bench: {exc}", file=sys.stderr, flush=True)
        return 2
    for name, check in result["checks"].items():
        limit = check.get("limit", check.get("limit_min"))
        print(f"check {name} {check['value']!r} limit {limit!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
