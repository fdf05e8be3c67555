"""Render the dry-run roofline table (H100 constants) as markdown.

    PYTHONPATH=src python -m repro_torch.analysis.report [--dir results/dryrun_torch]
        [--summary]

The counterpart of ``repro.analysis.report``. Every figure is computed from
``op_cost``'s counts and the datasheet constants of ``roofline``; none is
measured.
"""

from __future__ import annotations

import argparse
import json

from repro_torch.analysis.roofline import load_reports
from repro_torch.configs import skipped_cells


def fmt_s(x: float) -> str:
    if x >= 1.0:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x * 1e3:.2f}ms"
    return f"{x * 1e6:.1f}µs"


def one_sentence(rep) -> str:
    """What would move the dominant term down."""
    b = rep.bottleneck
    if b == "compute":
        if rep.useful_flops_fraction < 0.30:
            return ("compute-bound with low useful fraction — cut remat "
                    "recompute / duplicate work")
        return "compute-bound near useful FLOPs — increase per-rank batch"
    if b == "memory":
        if rep.kind == "decode":
            return ("HBM-bound on weight+KV streaming — shrink bytes "
                    "touched (KV layout, window slicing, quantized KV)")
        return ("HBM-bound — fuse the elementwise chains around the "
                "kernels to stop materializing intermediates")
    return ("collective-bound — reshard to cut all-gather/all-reduce "
            "volume or overlap with compute")


def markdown_table(dirpath: str) -> str:
    reports = load_reports(dirpath)
    lines = [
        "| arch | shape | mesh | compute | memory | collective | bottleneck "
        "| MODEL_FLOPs/counted | roofline frac | next lever |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in sorted(reports, key=lambda r: (r.arch, r.shape, r.mesh)):
        lines.append(
            f"| {r.arch} | {r.shape} | {r.mesh} | {fmt_s(r.compute_s)} "
            f"| {fmt_s(r.memory_s)} | {fmt_s(r.collective_s)} "
            f"| {r.bottleneck} | {r.useful_flops_fraction:.2f} "
            f"| {r.roofline_fraction:.3f} | {one_sentence(r)} |")
    for arch, shape, why in skipped_cells():
        lines.append(f"| {arch} | {shape} | — | — | — | — | — | — | — "
                     f"| SKIP({why}) |")
    return "\n".join(lines)


def summary(dirpath: str) -> dict:
    reports = load_reports(dirpath)
    worst = sorted(reports, key=lambda r: r.roofline_fraction)[:5]
    coll = sorted(reports, key=lambda r: (r.collective_s / max(1e-12, r.step_time_s)),
                  reverse=True)[:5]
    return {
        "n_cells": len(reports),
        "worst_fraction": [(r.arch, r.shape, r.mesh, round(r.roofline_fraction, 4))
                           for r in worst],
        "most_collective_bound": [
            (r.arch, r.shape, r.mesh, round(r.collective_s / max(1e-12, r.step_time_s), 3))
            for r in coll],
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="results/dryrun_torch")
    ap.add_argument("--summary", action="store_true")
    args = ap.parse_args(argv)
    if args.summary:
        print(json.dumps(summary(args.dir), indent=1))
    else:
        print(markdown_table(args.dir))


if __name__ == "__main__":
    main()
