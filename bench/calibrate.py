"""Readings that the limits of ``correct`` are set from, on the card.

    python3 bench/calibrate.py --workload <cell> --seeds 1 2 ... \
        [--control-seeds 3] [--seconds 3]

For every seed, one short run of the cell's timed path (``harness.
run_cell``, all in this process) gives the program's reading of each
compared number.  For the first ``--control-seeds`` seeds, the control
gives its reading of the same numbers on the same inputs and sampled
calls: the plain reference, one precision step below the configuration's
(``reference/*.control``), in the program's place.  Prints one JSON line
per seed and a summary: the lower reading (the program's largest), the
upper one (the control's smallest) and the configured limit.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

import harness  # noqa: E402


def control_reading(system, samples) -> dict:
    """The compared numbers with the control in the program's place: the
    same inputs and sampled calls, each output the control's."""
    return system.check([(item, system.control(item)) for item, _ in samples])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, default=3)
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
        found = keep["found"]
        row = {"seed": seed, "correct": res["correct"],
               "program": dict(found),
               "metrics": {k: v["value"] for k, v in res["metrics"].items()},
               "amplification": [keep["system"].amplification(item["done"])
                                 for item, _ in keep["samples"]]}
        for k, v in row["program"].items():
            if not k.startswith("per_call"):
                lower[k] = max(lower.get(k, v), v)
        if i < args.control_seeds:
            row["control"] = control_reading(keep["system"], keep["samples"])
            for k, v in row["control"].items():
                if not k.startswith("per_call"):
                    upper[k] = min(upper.get(k, v), v)
        print(json.dumps(row), flush=True)
        del keep
    print(json.dumps({"summary": args.workload, "lower": lower,
                      "upper": upper, "limits": limits}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
