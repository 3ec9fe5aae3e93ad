"""The environment in one report (the reference's ``tools/check_env.py``
for the port): Python, torch and its CUDA, the cards, ``nvcc``, the
kernels' build directory, the scatter-tile autotune cache, the elastic
remesh and attribution eligibility (through ``launch/mesh.py``'s
``shrink_mesh`` / ``slice_for_process``), the topology, the fused-apply
eligibility, the serving engine's buckets and the port's lint; then PASS
or WARN. Imports no JAX.

    PYTHONPATH=src python -m repro_torch.tools.check_env [--json]
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

import torch

from repro_torch import compat

OPTIONAL_DEPS = ("hypothesis", "triton")


def _nvcc() -> dict:
    path = compat.nvcc_path()
    if path is None:
        return {"path": None, "version": None}
    try:
        out = subprocess.run([path, "--version"], capture_output=True,
                             text=True, timeout=60).stdout
        version = out.strip().splitlines()[-1] if out.strip() else None
    except (OSError, subprocess.SubprocessError) as e:
        version = f"{type(e).__name__}: {e}"
    return {"path": path, "version": version}


def _build_dir() -> dict:
    """Where ``kernels/_build.py`` puts the kernels' libraries, and which
    of them are built (a call on the card builds the missing ones)."""
    from repro_torch.kernels import _build
    built = sorted(n for n in _build.KERNELS
                   if _build.library_path(n).exists())
    d = _build.BUILD_DIR
    return {"path": str(d), "exists": d.exists(),
            "writable": os.access(d if d.exists() else d.parent.parent,
                                  os.W_OK),
            "kernels": len(_build.KERNELS), "built": built}


def _autotune_status() -> dict:
    from repro_torch.kernels import autotune
    st = autotune.cache_status()
    st["measurement_allowed"] = autotune.measurement_allowed()
    return st


def _ranks() -> int:
    """Ranks a launcher gives one card each (NCCL); gloo ranks may share a
    card, so a gloo mesh has as many as it is given."""
    return max(torch.cuda.device_count(), 1)


def _remesh_eligibility() -> dict:
    """Can the elastic remesh shrink a data axis here? On one rank a card
    (NCCL) it needs two cards; gloo ranks sharing a card can always."""
    from repro_torch.launch.mesh import MeshShape, shrink_mesh
    n = _ranks()
    axes = ("data", "model")
    return {"cards": torch.cuda.device_count(),
            "max_data_parallel_nccl": n,
            "can_shrink_nccl": shrink_mesh(MeshShape((n, 1), axes), 0)
            is not None,
            "can_shrink_gloo": shrink_mesh(MeshShape((2, 1), axes), 0)
            is not None}


def _attribution_eligibility() -> dict:
    """Can heartbeat attribution do real work? Per-slice beats need two
    data slices; an eviction resolves by host (``shrink_mesh(
    drop_process_index=...)``) only where each data slice is one host's,
    which needs more than one host; on one host it drops the attributed
    grid slice. The stale fallback needs no mesh shape."""
    from repro_torch.launch.mesh import MeshShape, slice_for_process
    n, hosts = _ranks(), 1
    mesh = MeshShape((max(n, 2), 1), ("data", "model"), hosts=hosts)
    owned = [slice_for_process(mesh, h) for h in range(hosts)]
    return {"heartbeats_comparable": True,    # gloo ranks: >= 2 slices
            "process_eviction": hosts > 1 and all(s is not None
                                                  for s in owned),
            "grid_eviction": True, "probation_readmit": True,
            "stale_fallback": True}


def _topology() -> dict:
    from repro_torch.utils.roofline import HW
    return {"hosts": 1, "cards": torch.cuda.device_count(),
            "hierarchical_hw": HW.hierarchical, "record": HW.name}


def _fused_apply_eligibility() -> dict:
    from repro_torch.configs.base import RunConfig
    cfg = RunConfig()
    reasons = []
    if not cfg.fused_apply:
        reasons.append("fused_apply disabled")
    if cfg.optimizer not in ("adamw", "momentum"):
        reasons.append(f"optimizer {cfg.optimizer} has no fused update")
    if cfg.zero_stage != 0:
        reasons.append(f"zero_stage {cfg.zero_stage} shards the moments")
    if not cfg.opau:
        reasons.append("opau off (no aggregated update)")
    if not cfg.bucket_bytes:
        reasons.append("bucket_bytes 0 (per-tensor exchange)")
    return {"eligible": not reasons, "blockers": reasons,
            "optimizer": cfg.optimizer}


def _serving() -> dict:
    from repro_torch.runtime.server import (MIN_BUCKET, ServerConfig,
                                            prefill_buckets)
    scfg = ServerConfig()
    buckets = prefill_buckets(scfg.max_seq, MIN_BUCKET)
    return {"paged_families": ["dense", "moe", "vlm"],
            "toy_families": ["lstm", "ssm", "hybrid", "encdec"],
            "max_seq": scfg.max_seq, "prefill_buckets": buckets}


def _analysis() -> dict:
    try:
        from repro_torch.analysis.lint import lint_repo
        found = lint_repo()
        return {"available": True, "lint_findings": len(found),
                "clean": not found, "kinds": sorted({f.kind for f in found})}
    except Exception as e:
        return {"available": False, "clean": False,
                "error": f"{type(e).__name__}: {e}"}


def collect() -> dict:
    cuda = torch.cuda.is_available()
    report = {
        "python": sys.version.split()[0],
        "torch": torch.__version__,
        "torch_cuda": torch.version.cuda,
        "cuda_available": cuda,
        "device_count": torch.cuda.device_count(),
        "devices": [torch.cuda.get_device_name(i)
                    for i in range(torch.cuda.device_count())],
        "hopper": cuda and compat.is_hopper(),
        "nvcc": _nvcc(),
        "build": _build_dir(),
        "backends": {"nccl": compat.nccl_available(),
                     "gloo": compat.gloo_available()},
        "kernel_autotune": _autotune_status(),
        "remesh": _remesh_eligibility(),
        "attribution": _attribution_eligibility(),
        "topology": _topology(),
        "fused_apply": _fused_apply_eligibility(),
        "serving": _serving(),
        "analysis": _analysis(),
        "optional_deps": {n: importlib.util.find_spec(n) is not None
                          for n in OPTIONAL_DEPS},
    }
    # the port runs here; the card's kernels need a Hopper card and nvcc
    report["ok"] = bool(report["analysis"]["clean"])
    report["card_ready"] = bool(report["hopper"] and report["nvcc"]["path"])
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.tools.check_env")
    ap.add_argument("--json", action="store_true",
                    help="one machine-readable line")
    args = ap.parse_args(argv)
    r = collect()
    if args.json:
        print(json.dumps(r))
        return 0 if r["ok"] else 1
    print(f"python {r['python']}  torch {r['torch']}  cuda "
          f"{r['torch_cuda']}  cards={r['device_count']} {r['devices']}")
    nv = r["nvcc"]
    print(f"nvcc: {nv['path'] or 'not found'}"
          + (f" ({nv['version']})" if nv["version"] else ""))
    b = r["build"]
    print(f"kernel build dir: {b['path']} (exists={b['exists']}, "
          f"writable={b['writable']}; built {len(b['built'])} of "
          f"{b['kernels']})")
    at = r["kernel_autotune"]
    print(f"kernel autotune: cache {at['state']} ({at['entries']} entries, "
          f"{at['backend_entries']} for this device) at {at['path']}  "
          f"measurement={'allowed' if at['measurement_allowed'] else 'OFF'}")
    fa = r["fused_apply"]
    print("fused apply: " + (f"eligible (optimizer={fa['optimizer']})"
                             if fa["eligible"] else
                             "NOT eligible: " + "; ".join(fa["blockers"])))
    rm, att = r["remesh"], r["attribution"]
    print(f"elastic remesh: shrink on nccl ranks={rm['can_shrink_nccl']} "
          f"(cards={rm['cards']}), on gloo ranks={rm['can_shrink_gloo']}; "
          f"attribution: eviction by "
          f"{'host' if att['process_eviction'] else 'grid slice'}, "
          f"probation/readmit={att['probation_readmit']}, stale "
          f"fallback=always")
    t = r["topology"]
    print(f"topology: hosts={t['hosts']} record={t['record']} "
          f"two-tier pricing={t['hierarchical_hw']} (fit one with "
          f"python -m repro_torch.tools.profile_collectives fit)")
    an = r["analysis"]
    print("static analysis: " + (
        ("lint clean" if an["clean"] else
         f"{an['lint_findings']} finding(s) {an['kinds']}")
        if an["available"] else f"UNAVAILABLE ({an['error']})"))
    sv = r["serving"]
    print(f"serving: paged engine for {'/'.join(sv['paged_families'])} "
          f"({len(sv['prefill_buckets'])} prefill buckets at max_seq="
          f"{sv['max_seq']}); {'/'.join(sv['toy_families'])} -> ToyServer")
    if not r["ok"]:
        print("WARN: the port's lint has findings")
    elif not r["card_ready"]:
        print("WARN: no Hopper card with nvcc here: the kernels run their "
              "plain versions (CPU tensors) only")
    else:
        print("PASS")
    return 0 if r["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
