"""Paper Figure 13 (12) through the port: roofline-bound training
throughput as workers are added — the data axis over {1, 2, 4, 8, 16}
with the model axis at 16, ``ShapeConfig("scale", 4096, 16·data,
"train")`` (16 sequences a replica), ``RunConfig(capacity_mode="capped",
remat="full")``; each point a dry-run (launch/dryrun.py) on that mesh,
normalised to the 16-card point (the reference's
``benchmarks/fig13_scaling.py``).

The bound is max(counted FLOPs / peak, utils/traffic.py's bytes / HBM
rate, recorded wire bytes / link rate) on the H100 record: a
projection, not a measurement; it runs on the host whatever the device.

    PYTHONPATH=src python -m repro_torch.benchmarks.run fig13
"""
from __future__ import annotations

import os

from repro_torch.benchmarks.common import emit
from repro_torch.configs import RunConfig, ShapeConfig
from repro_torch.launch.dryrun import run_cells
from repro_torch.launch.mesh import MeshShape

ARCHS = ("phi3-medium-14b", "command-r-35b", "parallax-lm")
DATA = (1, 2, 4, 8, 16)
MODEL = 16


def shape_for(data: int) -> ShapeConfig:
    return ShapeConfig("scale", 4096, 16 * data, "train")


def scaling(archs=ARCHS, data=DATA, workers: int = 0) -> dict:
    """{arch: [{"chips", "tok_s", "normalized", "dominant"}, ...]}."""
    workers = workers or (os.cpu_count() or 1)
    rc = RunConfig(capacity_mode="capped", remat="full")
    cells = [dict(arch=a, shape_name=shape_for(n), run_cfg=rc,
                  verbose=False, mesh=MeshShape((n, MODEL),
                                                ("data", "model")))
             for a in archs for n in data]
    res = iter(run_cells(cells, workers))
    out = {}
    for arch in archs:
        rows = []
        for n in data:
            r = next(res)
            if not r["ok"]:
                raise RuntimeError(f"fig13: {arch} on ({n}, {MODEL}) "
                                   f"failed: {r.get('error')}")
            roof = r["roofline"]
            rows.append({"chips": r["chips"], "dominant": roof["dominant"],
                         "tok_s": shape_for(n).tokens / roof["bound_s"]})
        for row in rows:
            row["normalized"] = row["tok_s"] / rows[0]["tok_s"]
        out[arch] = rows
    return out


def main(device: str = "cuda", archs=ARCHS) -> dict:
    out = scaling(archs)
    for arch, rows in out.items():
        for r in rows:
            emit(f"fig13/{arch}/chips{r['chips']}", 0.0,
                 f"tok_s={r['tok_s']:.0f};"
                 f"normalized={r['normalized']:.2f}x_of_16chip;"
                 f"dominant={r['dominant']};"
                 f"device=host (dry-run, priced on the H100 record; "
                 f"--device {device} unused)")
    return out


if __name__ == "__main__":
    main()
