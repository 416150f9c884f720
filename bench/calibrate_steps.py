"""Readings that a decode-step cell's ``correct`` limits are set from,
on the card (``calibrate.py`` is the head cell's: it reads each call's
straggler amplification, which a decode step has none of).

    python3 bench/calibrate_steps.py --workload <cell> --seeds 1 2 ... \
        [--control-seeds 3] [--seconds 3]

For every seed, one short run of the cell (``harness.run_cell``, all in
this process) gives the program's reading of each compared number; for
the first ``--control-seeds`` seeds each control gives its reading on
the same inputs and sampled steps: ``control`` (``System.control``: the
reference one precision step below the configuration's) and
``cache_control`` (``System.cache_control``: only the latent cache one
step below).  Prints one JSON line per seed and a summary: the
program's largest reading, each control's smallest, and the configured
limit.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    harness.set_environment()
    lower: dict = {}
    upper: dict = {"control": {}, "cache_control": {}}
    limits = None
    for i, seed in enumerate(args.seeds):
        keep: dict = {}
        res = harness.run_cell(args.workload, seed, args.seconds, False,
                               keep=keep)
        limits = {k: v["limit"] for k, v in res["checks"].items()
                  if "limit" in v}
        row = {"seed": seed, "correct": res["correct"],
               "program": {k: v for k, v in keep["found"].items()
                           if not k.startswith("per_call")},
               "metrics": {k: v["value"] for k, v in res["metrics"].items()}}
        for k, v in row["program"].items():
            lower[k] = max(lower.get(k, v), v)
        if i < args.control_seeds:
            system = keep["system"]
            items = [item for item, _ in keep["samples"]]
            for kind, rows in upper.items():
                start = time.perf_counter()
                found = system.check(list(zip(
                    items, getattr(system, kind)(items))))
                row[kind] = {k: v for k, v in found.items()
                             if not k.startswith("per_call")}
                row[kind]["seconds"] = time.perf_counter() - start
                for k, v in row[kind].items():
                    if k != "seconds":
                        rows[k] = min(rows.get(k, v), v)
        print(json.dumps(row), flush=True)
        del keep
    print(json.dumps({"summary": args.workload, "lower": lower,
                      "upper": upper, "limits": limits}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
