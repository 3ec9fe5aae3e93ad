"""The roofline table: ``results/dryrun_torch/*.json`` (the dry-run's
cells, launch/dryrun.py) -> one line per cell and a markdown table (the
reference's ``benchmarks/roofline_table.py``). It reads files only, on
the host whatever the device.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch parallax-lm \\
        --shape train_4k
    PYTHONPATH=src python -m repro_torch.benchmarks.run roofline
"""
from __future__ import annotations

import glob
import json
import os

from repro_torch.benchmarks.common import RESULTS, emit


def rows(pattern: str = "*.json", out_dir=None) -> list:
    out_dir = out_dir or os.path.join(RESULTS, "dryrun_torch")
    out = []
    for f in sorted(glob.glob(os.path.join(out_dir, pattern))):
        with open(f) as fh:
            out.append(json.load(fh))
    return out


def main(device: str = "cuda", out_dir=None) -> list:
    found = rows(out_dir=out_dir)
    if not found:
        emit("roofline/none", 0.0, "no dry-run cells under "
             f"{out_dir or os.path.join(RESULTS, 'dryrun_torch')}: run "
             "python -m repro_torch.launch.dryrun first")
    for d in found:
        tag = f"{d['arch']}/{d['shape']}/{d['mesh']}"
        if not d.get("ok"):
            emit(f"roofline/{tag}", 0.0, "FAILED")
            continue
        r = d["roofline"]
        emit(f"roofline/{tag}", r["bound_s"] * 1e6,
             f"compute_ms={r['compute_s'] * 1e3:.1f};"
             f"memory_ms={r['memory_s'] * 1e3:.1f};"
             f"collective_ms={r['collective_s'] * 1e3:.1f};"
             f"dominant={r['dominant']};"
             f"useful_flops={r['useful_flops_fraction']:.2f};"
             f"roofline_frac={r['roofline_fraction']:.3f};"
             f"peak_GB={d['memory_analysis']['peak_bytes'] / 1e9:.1f};"
             f"device=host (dry-run files; --device {device} unused)")
    return found


def markdown(out_dir=None) -> str:
    lines = ["| arch | shape | mesh | compute s | memory s | collective s | "
             "dominant | MODEL/counted flops | roofline frac | peak GB/card |",
             "|---|---|---|---|---|---|---|---|---|---|"]
    for d in rows(out_dir=out_dir):
        if not d.get("ok"):
            why = str(d.get("error") or d.get("contract", {}).get(
                "findings"))
            lines.append(f"| {d['arch']} | {d['shape']} | {d['mesh']} | "
                         f"FAILED: {why[:40]} | | | | | | |")
            continue
        r = d["roofline"]
        lines.append(
            f"| {d['arch']} | {d['shape']} | {d['mesh']} "
            f"| {r['compute_s']:.3f} | {r['memory_s']:.3f} "
            f"| {r['collective_s']:.3f} | {r['dominant']} "
            f"| {r['useful_flops_fraction']:.2f} "
            f"| {r['roofline_fraction']:.3f} "
            f"| {d['memory_analysis']['peak_bytes'] / 1e9:.1f} |")
    return "\n".join(lines)


if __name__ == "__main__":
    main()
