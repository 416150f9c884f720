"""Readings that a decode-step cell's ``correct`` limits are set from, on
the card, with every control its system defines: ``control`` and
``cache_control`` (every decode-step system's) and ``dense_control`` (a
sparse-attention system's).  It covers ``calibrate_steps.py``'s cells
too.

    python3 bench/calibrate_controls.py --workload <cell> --seeds 1 2 ... \
        [--control-seeds 1] [--seconds 3]

For every seed, one short run of the cell (``harness.run_cell``, all in
this process) gives the program's reading of each compared number; for
the first ``--control-seeds`` seeds each control (a method of the
cell's ``System`` that answers the sampled steps) gives its reading on
the same inputs and sampled steps.  Prints one JSON line per seed and a
summary: the program's largest reading, each control's smallest, and
the configured limit.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

import harness  # noqa: E402


# the controls a decode-step system may define
CONTROLS = ("control", "cache_control", "dense_control")


def readings(found: dict) -> dict:
    return {k: v for k, v in found.items() if not k.startswith("per_call")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, default=1)
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    harness.set_environment()
    lower: dict = {}
    upper: dict = {}
    limits = None
    for i, seed in enumerate(args.seeds):
        keep: dict = {}
        res = harness.run_cell(args.workload, seed, args.seconds, False,
                               keep=keep)
        limits = {k: v["limit"] for k, v in res["checks"].items()
                  if "limit" in v}
        row = {"seed": seed, "correct": res["correct"],
               "program": readings(keep["found"]),
               "metrics": {k: v["value"] for k, v in res["metrics"].items()}}
        for k, v in row["program"].items():
            lower[k] = max(lower.get(k, v), v)
        if i < args.control_seeds:
            system = keep["system"]
            items = [item for item, _ in keep["samples"]]
            for kind in CONTROLS:
                if not hasattr(system, kind):
                    continue
                rows = upper.setdefault(kind, {})
                start = time.perf_counter()
                found = system.check(list(zip(
                    items, getattr(system, kind)(items))))
                row[kind] = readings(found)
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
