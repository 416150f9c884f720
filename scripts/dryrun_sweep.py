"""The port's dry run over every (arch x shape) cell at once.

    PYTHONPATH=src python scripts/dryrun_sweep.py --out build/sweep \
        [--lanes 8] [--smoke] [--microbatches 4]

What ``python -m repro_torch.launch.dryrun --all`` does, with one
process per cell, ``--lanes`` of them at a time (longest first: the
prefills, deepest arch first, then the train cells), so a host's cores
share the work.  Every artifact goes to ``--out``, then the roofline
over them to ``--out/roofline.json``.  One JSON line per cell (its
status, trace and process seconds, the roofline's three terms and the
dominant one), then a summary line; the exit code is 1 if any cell is
an ``error``.  Host only: the cells run on meta tensors over a ``fake``
process group.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.analysis.roofline import analyze_cell  # noqa: E402
from repro_torch.configs import ARCH_IDS, SHAPES, get_config  # noqa: E402

ORDER = {"prefill_32k": 0, "train_4k": 1, "decode_32k": 2, "long_500k": 3}


def run_cell(arch: str, shape: str, args) -> dict:
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
           "--shape", shape, "--out", str(args.out), "--microbatches",
           str(args.microbatches)] + (["--smoke"] if args.smoke else [])
    t0 = time.perf_counter()
    p = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                       env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    return {"arch": arch, "shape": shape, "rc": p.returncode,
            "process_s": round(time.perf_counter() - t0, 1),
            "stderr": p.stderr[-1500:] if p.returncode else ""}


def artifact(args, arch: str, shape: str) -> dict:
    suffix = (f"__mb{args.microbatches}" if args.microbatches != 4 else "") \
        + ("__smoke" if args.smoke else "")
    return json.loads((args.out / f"{arch}__{shape}__32x8{suffix}.json")
                      .read_text())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "sweep")
    ap.add_argument("--lanes", type=int, default=os.cpu_count() or 4)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--microbatches", type=int, default=4)
    args = ap.parse_args(argv)
    args.out.mkdir(parents=True, exist_ok=True)
    layers = {a: get_config(a).n_layers for a in ARCH_IDS}
    cells = sorted(((a, s) for a in ARCH_IDS for s in SHAPES),
                   key=lambda c: (ORDER[c[1]], -layers[c[0]]))
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(args.lanes) as pool:
        runs = list(pool.map(lambda c: run_cell(*c, args), cells))
    rows, errors = [], 0
    for run in runs:
        art = artifact(args, run["arch"], run["shape"])
        row = {**run, "status": art["status"],
               "trace_s": art.get("compile_s")}
        if art["status"] == "ok":
            terms = analyze_cell(art)
            row.update({k: terms[k] for k in ("t_compute_s", "t_memory_s",
                                              "t_collective_s", "dominant",
                                              "projected_mfu")})
        elif art["status"] == "error":
            errors += 1
            row["error"] = art["error"]
        else:
            row["reason"] = art["reason"]
        rows.append(row)
        print(json.dumps(row), flush=True)
    (args.out / "roofline.json").write_text(json.dumps(rows, indent=1))
    print(json.dumps({"cells": len(rows), "errors": errors,
                      "ok": sum(r["status"] == "ok" for r in rows),
                      "skipped": sum(r["status"] == "skipped" for r in rows),
                      "wall_s": round(time.perf_counter() - t0, 1),
                      "lanes": args.lanes}), flush=True)
    return 1 if errors else 0


if __name__ == "__main__":
    sys.exit(main())
