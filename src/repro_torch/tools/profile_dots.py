"""The counted operations of one dry-run cell by operator and argument
shapes, largest first, with the total (the reference's
``tools/profile_dots.py``, whose HLO dot census the dry step's count
replaces: ``launch/dryrun.py::DryCount``). The total is the cell's
``flop_count["flops"]``: ATen's counted operations and the kernels'.

    PYTHONPATH=src python -m repro_torch.tools.profile_dots \\
        --arch parallax-lm --shape train_4k [--top 15] [--mesh 16x16]

Runs on the host on the meta device (no card, no kernel launched).
"""
from __future__ import annotations

import argparse

from repro_torch.configs import RunConfig, get_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import DryMesh


def dot_census(arch: str, shape, run_cfg: RunConfig, mesh="production",
               multi_pod: bool = False) -> dict:
    """-> {"total": counted operations a card, "aten", "kernels",
    "kernel_calls", "rows": [(key, flops, calls)] largest first}."""
    cfg = get_config(arch)
    shape = dryrun._resolve_shape(shape)
    dmesh = dryrun._resolve_mesh(mesh, multi_pod)
    model, rt, plan, opt = dryrun.build_cell(cfg, shape, run_cfg, dmesh)
    by_op: dict = {}
    dry = dryrun.dry_step(model, rt, plan, opt, by_op=by_op)
    rows = sorted(((k, v[0], v[1]) for k, v in by_op.items()),
                  key=lambda r: -r[1])
    return {"total": dry.flops, "aten": dry.aten_flops,
            "kernels": dry.kernel_flops, "kernel_calls": dry.kernel_calls,
            "rows": rows, "mesh": dryrun.mesh_name(dmesh)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="repro_torch.tools.profile_dots")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--mesh", default="production",
                    help="production, none, or DxM")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--remat", default="full")
    ap.add_argument("--explicit-sp", action="store_true")
    ap.add_argument("--top", type=int, default=15)
    args = ap.parse_args(argv)
    mesh = args.mesh
    if mesh == "none":
        mesh = None
    elif mesh != "production":
        mesh = DryMesh(tuple(int(x) for x in mesh.split("x")),
                       ("data", "model"))
    out = dot_census(args.arch, args.shape,
                     RunConfig(capacity_mode="capped", remat=args.remat,
                               explicit_sp=args.explicit_sp),
                     mesh=mesh, multi_pod=args.multi_pod)
    print(f"total counted flops/card: {out['total']:.3e} (aten "
          f"{out['aten']:.3e}, kernels {out['kernels']:.3e} "
          f"{out['kernel_calls']}) on {out['mesh']}")
    for key, fl, n in out["rows"][:args.top]:
        print(f"{fl:.2e} x{n:4d}  {key[:110]}")
    return out


if __name__ == "__main__":
    main()
