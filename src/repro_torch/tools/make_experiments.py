"""An experiments page from the port's records (the reference's
``tools/make_experiments.py``): the dry-run's cells as the roofline table
(``results/dryrun_torch/*.json``, ``benchmarks/roofline_table.py``) and a
line for each of the port's benchmark records (``results/torch_*.json``),
under a header that states the hardware record they are priced on. It
writes only the path it is given.

    PYTHONPATH=src python -m repro_torch.tools.make_experiments \\
        [-o results/EXPERIMENTS_torch.md] [--dryrun-dir DIR]
"""
from __future__ import annotations

import argparse
import glob
import json
import os

from repro_torch.benchmarks.common import RESULTS
from repro_torch.benchmarks.roofline_table import markdown, rows
from repro_torch.utils.roofline import HW

OUT = os.path.join(RESULTS, "EXPERIMENTS_torch.md")


def header() -> str:
    return f"""# EXPERIMENTS (the PyTorch port)

Hardware record: {HW.name}, the NVIDIA H100 SXM datasheet's figures
(utils/roofline.py): {HW.peak_flops / 1e12:.0f} bf16 TFLOP/s dense,
{HW.hbm_bw / 1e12:.2f} TB/s HBM3, {HW.hbm_bytes / 1e9:.0f} GB of device
memory, {HW.link_bw / 1e9:.0f} GB/s NVLink a card each way, one link tier
unless a fitted profile (``python -m repro_torch.tools.
profile_collectives fit``) gives the inter-host one. Meshes: 16x16
(data, model; 256 cards) and 2x16x16 (pod, data, model; 512 cards).

## Conventions (the dry-run, launch/dryrun.py)

* A cell is one step as rank 0 of a record-only mesh on the meta device:
  nothing is computed and no kernel is launched, so every number below is
  counted, none is timed.
* **FLOPs**: the dry step's counted operations (ATen's formulas and the
  kernels' own counts), remat recompute included.
* **collective bytes**: the step's record, each collective at the dtype
  it carries, ring factors applied (all-reduce 2(N-1)/N, the others
  (N-1)/N).
* **memory term**: utils/traffic.py's streaming-traffic model.
* **peak bytes/card**: the peak of the step's live storages.
* **roofline fraction** = (model FLOPs / (cards x peak)) / the largest
  of the compute, memory and collective terms.
"""


def benchmark_lines(results: str = RESULTS) -> list:
    out = []
    for f in sorted(glob.glob(os.path.join(results, "torch_*.json"))):
        try:
            with open(f) as fh:
                d = json.load(fh)
        except (OSError, ValueError):
            continue
        keys = ", ".join(sorted(d)) if isinstance(d, dict) else type(d)
        out.append(f"* `{os.path.relpath(f, results)}`: {keys}")
    return out


def page(dryrun_dir=None, results: str = RESULTS) -> str:
    parts = [header()]
    cells = rows(out_dir=dryrun_dir)
    parts.append("\n## Dry-run cells and their roofline\n\n" + (
        markdown(out_dir=dryrun_dir) if cells else
        "No dry-run cell yet: `python -m repro_torch.launch.dryrun`."))
    lines = benchmark_lines(results)
    parts.append("\n## Benchmark records (results/)\n\n" + (
        "\n".join(lines) if lines else
        "None yet: `python -m repro_torch.benchmarks.run`."))
    return "\n".join(parts) + "\n"


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(prog="repro_torch.tools.make_experiments")
    ap.add_argument("-o", "--out", default=OUT)
    ap.add_argument("--dryrun-dir", default=None)
    ap.add_argument("--results", default=RESULTS)
    args = ap.parse_args(argv)
    text = page(args.dryrun_dir, args.results)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        f.write(text)
    print(f"wrote {args.out}")
    return args.out


if __name__ == "__main__":
    main()
