"""Roofline synthesis: three terms per (arch x shape x mesh) cell.

Inputs: the dry-run JSON artifacts (collective bytes counted as the step
dispatched them, per-rank memory, status) + the analytic FLOP/HBM
models of ``analysis.flops`` (the dry run's own per-rank count is
recorded beside them as ``hlo_flops_raw``, the reference's key).

    compute    = FLOPs / (cards * 989e12 bf16 FLOP/s)
    memory     = HBM bytes per card / 3.35e12 B/s
    collective = per-card collective bytes / 50e9 B/s InfiniBand
                 (the counted collectives are each rank's own, so the
                 bytes are already per card)

The constants are the H100 SXM data sheet's (``launch.mesh``).  Every
collective byte is charged at the InfiniBand rate: a 256-card mesh spans
32 nodes, so the 'data' (and 'pod') collectives cross InfiniBand, while
'model' ones stay on the node's NVLink (450e9 B/s each way); charging
everything at the slower rate upper-bounds the term, as the reference
charges all of a multi-pod cell at its slower link.

Reported per cell: all three terms (seconds), the dominant term, the
MODEL_FLOPS/total ratio, and projected MFU = MODEL_FLOPS /
(cards * peak * max-term).

Usage:  python -m repro_torch.analysis.roofline --artifacts artifacts/dryrun
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from ..configs import SHAPES, get_config, get_smoke_config
from ..launch.mesh import HBM_BW, IB_BW, PEAK_FLOPS_BF16, mesh_name
from .flops import cell_flops, cell_hbm_bytes

COLLECTIVE_BW = IB_BW   # bytes/s per card every collective is charged at
MICRO = 4               # must match dryrun build_cell default


def analyze_cell(art: dict) -> dict | None:
    if art.get("status") != "ok":
        return None
    cfg = (get_smoke_config if art.get("smoke") else get_config)(art["arch"])
    shape = SHAPES[art["shape"]]
    chips = art["devices"]

    micro = art.get("microbatches", MICRO)
    rep = cell_flops(cfg, shape, microbatches=micro)
    hbm = cell_hbm_bytes(cfg, shape, chips, microbatches=micro)

    t_compute = rep.total / (chips * PEAK_FLOPS_BF16)
    t_memory = hbm["total"] / HBM_BW
    # ring all-reduce moves ~2x the payload (reduce-scatter + all-gather
    # phases); other collectives ~1x of their output bytes.
    coll_bytes = sum((2.0 if k == "all-reduce" else 1.0) * v
                     for k, v in art["collective_bytes"].items())
    t_coll = coll_bytes / COLLECTIVE_BW

    t_step = max(t_compute, t_memory, t_coll)
    dominant = {t_compute: "compute", t_memory: "memory",
                t_coll: "collective"}[t_step]
    mfu = rep.model_flops / (chips * PEAK_FLOPS_BF16 * t_step) \
        if t_step else 0.0
    return {
        "arch": art["arch"], "shape": art["shape"], "mesh": art["mesh"],
        "opts": art.get("opts", []), "microbatches": micro,
        "chips": chips,
        "t_compute_s": t_compute, "t_memory_s": t_memory,
        "t_collective_s": t_coll, "t_step_s": t_step,
        "dominant": dominant,
        "analytic_flops": rep.total,
        "model_flops": rep.model_flops,
        "useful_ratio": rep.useful_ratio,
        "projected_mfu": mfu,
        "hbm_breakdown": hbm,
        "collective_bytes": art["collective_bytes"],
        "hlo_flops_raw": art.get("flops"),
        "memory_analysis": art.get("memory", {}),
    }


def load_artifacts(art_dir: Path) -> list[dict]:
    out = []
    for f in sorted(art_dir.glob("*.json")):
        out.append(json.loads(f.read_text()))
    return out


def markdown_table(rows: list[dict]) -> str:
    hdr = ("| arch | shape | mesh | compute (s) | memory (s) | coll (s) | "
           "dominant | useful ratio | proj. MFU |")
    sep = "|" + "---|" * 9
    lines = [hdr, sep]
    for r in rows:
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} "
            f"| {r['t_compute_s']:.3e} | {r['t_memory_s']:.3e} "
            f"| {r['t_collective_s']:.3e} | **{r['dominant']}** "
            f"| {r['useful_ratio']:.2f} | {r['projected_mfu'] * 100:.1f}% |")
    return "\n".join(lines)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--artifacts", type=Path, default=Path("artifacts/dryrun"))
    ap.add_argument("--out", type=Path, default=Path("artifacts/roofline.json"))
    ap.add_argument("--mesh", default=mesh_name(False),
                    help="restrict table to one mesh (32x8, one pod)")
    args = ap.parse_args(argv)

    arts = load_artifacts(args.artifacts)
    rows, skipped = [], []
    for a in arts:
        if a.get("status") == "skipped":
            skipped.append(a)
            continue
        r = analyze_cell(a)
        if r:
            rows.append(r)
    table_rows = [r for r in rows if r["mesh"] == args.mesh]
    print(markdown_table(table_rows))
    print(f"\n{len(skipped)} skipped cells (long_500k on quadratic archs)")
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(rows, indent=2))
    print(f"wrote {args.out} ({len(rows)} analyzed cells)")


if __name__ == "__main__":
    main()
