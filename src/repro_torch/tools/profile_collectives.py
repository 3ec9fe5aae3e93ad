"""Collective profiling (the reference's ``tools/profile_collectives.py``
for the port).

dump: the largest collectives of one dry-run cell, from its record
(``launch/dryrun.py``: one step as rank 0 of a record-only ``DryMesh``;
the reference reads the compiled HLO):

    PYTHONPATH=src python -m repro_torch.tools.profile_collectives dump \\
        --arch parallax-lm --shape train_4k [--top 25]

fit: time all-reduces of several sizes over ranks (``launch/mesh.py::
spawn``), fit α + β·b per link tier by least squares, and write the
``hw_profile.json`` that ``RunConfig.hw_profile`` (``--hw-profile``)
feeds to ``core/cost_model.py::load_hw_profile``:

    PYTHONPATH=src python -m repro_torch.tools.profile_collectives fit \\
        --ranks 2 [--hosts 1] [--device cpu] -o hw_profile.json

With ``--hosts H > 1`` the ranks lie on a (pod, data) mesh and the sums
over ``pod`` fit the inter tier. The ranks run on the card unless
``--device cpu``; several ranks share one card over gloo (NCCL when every
rank has a card of its own), so a gloo profile times the host's staging
of the buffers, not a link: the file says which backend it timed.
"""
from __future__ import annotations

import argparse
import collections
import json
import sys
import time


def _build_parser():
    ap = argparse.ArgumentParser(prog="repro_torch.tools."
                                      "profile_collectives")
    sub = ap.add_subparsers(dest="cmd")
    dp = sub.add_parser("dump", help="largest collectives of one cell")
    dp.add_argument("--arch", required=True)
    dp.add_argument("--shape", required=True)
    dp.add_argument("--multi-pod", action="store_true")
    dp.add_argument("--remat", default="block")
    dp.add_argument("--comm-mode", default="hybrid")
    dp.add_argument("--top", type=int, default=25)
    fp = sub.add_parser("fit", help="fit α/β link constants, emit a profile")
    fp.add_argument("--ranks", type=int, default=2)
    fp.add_argument("--hosts", type=int, default=1,
                    help="host groups; > 1 adds a pod axis and fits the "
                         "inter tier")
    fp.add_argument("--sizes", type=int, nargs="+",
                    default=[1 << 12, 1 << 16, 1 << 20, 1 << 23],
                    help="buffer sizes (bytes) to time")
    fp.add_argument("--iters", type=int, default=10,
                    help="timed repetitions per size (the least is kept)")
    fp.add_argument("--device", default="cuda", help="cpu or cuda")
    fp.add_argument("-o", "--out", default="hw_profile.json")
    return ap


def dump(arch: str, shape: str, *, multi_pod: bool = False,
         remat: str = "block", comm_mode: str = "hybrid") -> dict:
    """-> {"by_kind": {kind: wire bytes}, "rows": [(wire bytes, kind,
    axes, dtype, elems, in_backward)] largest first} of the cell's one
    dry step."""
    from repro_torch.configs import RunConfig
    from repro_torch.core import collectives as coll
    from repro_torch.launch.dryrun import lower_cell
    dry, _, _, _ = lower_cell(
        arch, shape, multi_pod=multi_pod,
        run_cfg=RunConfig(comm_mode=comm_mode, capacity_mode="capped",
                          remat=remat))
    rows, agg = [], collections.defaultdict(float)
    for ev in dry.record.events:
        w = coll.wire_bytes(ev)
        agg[ev.kind] += w
        rows.append((w, ev.kind, "+".join(ev.axes), ev.dtype, ev.elems,
                     ev.in_backward))
    rows.sort(key=lambda r: -r[0])
    return {"by_kind": dict(agg), "rows": rows}


def _fit_line(xs, ys):
    """Least squares t = α + b/β over (wire bytes, seconds) samples ->
    (α seconds, β bytes/s)."""
    n = len(xs)
    mx, my = sum(xs) / n, sum(ys) / n
    sxx = sum((x - mx) ** 2 for x in xs)
    sxy = sum((x - mx) * (y - my) for x, y in zip(xs, ys))
    slope = sxy / sxx if sxx else 0.0
    alpha = my - slope * mx
    return max(alpha, 0.0), (1.0 / slope if slope > 0 else float("inf"))


def _time_ranks(rank, world, hosts, sizes, iters, device):
    """One rank: the least wall seconds of an all-reduce of each size over
    each tier's axis (the card synchronized after each)."""
    import torch
    from repro_torch.core import collectives as coll
    from repro_torch.launch.mesh import make_mesh
    dev = torch.device("cpu") if device == "cpu" else \
        torch.device("cuda", torch.cuda.current_device())
    mesh = make_mesh((hosts, world // hosts), ("pod", "data"), device=dev)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    tiers = {"intra": "data"}
    if hosts > 1:
        tiers["inter"] = "pod"
    out = {}
    for tier, axis in tiers.items():
        for size in sizes:
            x = torch.ones(max(size // 4, 1), dtype=torch.float32,
                           device=dev)
            coll.all_reduce(x, axis, mesh)          # warm
            sync()
            best = float("inf")
            for _ in range(iters):
                coll.barrier(mesh)
                t0 = time.perf_counter()
                coll.all_reduce(x, axis, mesh)
                sync()
                best = min(best, time.perf_counter() - t0)
            out[f"{tier}_{size}"] = best
    return out, mesh.backend


def fit(ranks: int, hosts: int = 1, sizes=(1 << 12, 1 << 16, 1 << 20,
                                            1 << 23),
        iters: int = 10, device: str = "cuda") -> dict:
    """Time and fit; -> the profile (``load_hw_profile``'s fields
    ``link_latency`` / ``link_bw``, and ``inter_*`` with hosts > 1)."""
    import torch
    from repro_torch.launch.mesh import spawn
    if ranks % hosts:
        raise ValueError(f"ranks={ranks} not divisible by hosts={hosts}")
    backend = "nccl" if device != "cpu" and \
        torch.cuda.device_count() >= ranks else "gloo"
    res = spawn(_time_ranks, ranks, backend, device,
                args=(hosts, list(sizes), iters, device), timeout=600)
    samples, backend = res[0]
    tiers = {"intra": ranks // hosts}
    if hosts > 1:
        tiers["inter"] = hosts
    prof = {"ranks": ranks, "hosts": hosts, "backend": backend,
            "device": device, "samples": samples}
    if backend == "gloo":
        prof["note"] = ("gloo stages every buffer through the host: "
                        "these are the host's times, not a link's")
    for tier, n in tiers.items():
        ring = lambda b: 2.0 * (n - 1) / n * b if n > 1 else 0.0
        xs = [ring(s) for s in sizes]
        ys = [samples[f"{tier}_{s}"] for s in sizes]
        alpha, beta = _fit_line(xs, ys)
        if tier == "intra":
            prof["link_latency"], prof["link_bw"] = alpha, beta
        else:
            prof["inter_latency"], prof["inter_bw"] = alpha, beta
    return prof


def main(argv=None) -> int:
    ap = _build_parser()
    args = ap.parse_args(argv)
    if args.cmd is None:
        ap.print_help()
        return 2
    if args.cmd == "dump":
        out = dump(args.arch, args.shape, multi_pod=args.multi_pod,
                   remat=args.remat, comm_mode=args.comm_mode)
        print({k: f"{v / 1e9:.3f}GB" for k, v in out["by_kind"].items()})
        for w, kind, axes, dtype, elems, bwd in out["rows"][:args.top]:
            print(f"{w / 1e9:8.4f}GB {kind:15s} over {axes:12s} {dtype:9s} "
                  f"{elems:>12d} elems{'  (in backward)' if bwd else ''}")
        return 0
    prof = fit(args.ranks, args.hosts, args.sizes, args.iters, args.device)
    with open(args.out, "w") as f:
        json.dump(prof, f, indent=1)
    print(f"wrote {args.out} ({prof['backend']} on {prof['device']}):")
    print(f"  intra: alpha={prof['link_latency']:.3e}s "
          f"beta={prof['link_bw']:.3e}B/s")
    if args.hosts > 1:
        print(f"  inter: alpha={prof['inter_latency']:.3e}s "
              f"beta={prof['inter_bw']:.3e}B/s")
    if "note" in prof:
        print(f"  {prof['note']}")
    print("use via RunConfig(hw_profile=...) or launch/train.py "
          "--hw-profile")
    return 0


if __name__ == "__main__":
    sys.exit(main())
