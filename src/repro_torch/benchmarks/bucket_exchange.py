"""Bucketed against per-tensor dense-gradient exchange (core/buckets.py),
read from the record of the collectives each step issued
(``core/collectives.py::record``) in place of the reference's HLO (its
``benchmarks/bucket_exchange.py``).

The same training step of reduced seamless-m4t-medium (26 dense
parameter tensors, f32) on 4 ranks in four comparisons:

  * per-tensor (bucket_bytes=0) against bucketed: all-reduces a step and
    their wire bytes (equal: bucketing fuses messages, it does not change
    what is exchanged), and the largest loss difference over 3 steps;
  * overlap on against off at the same buckets: the same bytes, each
    bucket issued inside the backward or after it, the median step time,
    and a loss difference of exactly 0.0 (the exchange is the same sum);
  * ring against two-level on a ("pod", "data", "model") mesh with a
    fitted inter-host profile: the cost model's seconds for both
    schedules, the buckets the argmin sends two-level, and the loss
    difference against the ring on the same mesh.

Every step's record is also checked against its plan's contract
(analysis/contract.py). The ranks run on ``--device`` (the card by
default: several ranks share it over gloo, so the step times are host
staging, not exchange times). Writes ``results/torch_exchange.json``.

    PYTHONPATH=src python -m repro_torch.benchmarks.run buckets [--device cpu]
"""
from __future__ import annotations

import json
import os
import tempfile
import time

from repro_torch.benchmarks.common import (RESULTS, device_name, emit,
                                           run_on_mesh)

ARCH = "seamless-m4t-medium"
MESH, POD_MESH = (4, 1), (2, 2, 1)
KW = dict(attention_impl="naive", remat="none", param_dtype="float32",
          compute_dtype="float32", wire_dtype="float32")
# a synthetic inter-host tier (12.5 GB/s, 10 us): only the inter keys, so
# the intra tier keeps the card's record (the reference's)
HW_POD = {"inter_bw": 12.5e9, "inter_latency": 10e-6}
STEPS = 6
OUT = os.path.join(RESULTS, "torch_exchange.json")


def _drive(mesh, cfg, shape, ds, **kw) -> dict:
    """One runner's 6 steps; the first recorded and checked."""
    import torch
    from repro_torch.analysis.contract import check_contract
    from repro_torch.configs import RunConfig
    from repro_torch.core import collectives as coll
    from repro_torch.core import cost_model
    from repro_torch.core.transform import get_runner
    run = get_runner(cfg, shape, RunConfig(**KW, **kw), mesh=mesh, seed=0)
    dev = run.rt.device
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    losses, times = [], []
    for i in range(STEPS):
        sync()
        t0 = time.perf_counter()
        if i == 0:
            with coll.record() as rec:
                m = run.run(ds.batch(i))
        else:
            m = run.run(ds.batch(i))
        losses.append(float(m["loss"]))
        sync()
        times.append(time.perf_counter() - t0)
    ar = [e for e in rec.events if e.kind == "all-reduce"]
    bp = run.plan.bucket_plan
    prices = {}
    if bp is not None:
        for b in bp.buckets:
            for k, v in cost_model.dense_schedule_seconds(
                    b.nbytes, bp.dims, bp.hw).items():
                prices[k] = prices.get(k, 0.0) + v
    return {
        "all_reduce_count": len(ar),
        "all_gather_count": sum(e.kind == "all-gather" for e in rec.events),
        "all_reduce_wire_bytes": sum(coll.wire_bytes(e) for e in ar),
        "collective_wire_bytes": sum(coll.wire_bytes(e)
                                     for e in rec.events),
        "buckets_in_backward": sum(e.in_backward for e in ar),
        "findings": [str(f) for f in check_contract(run.plan, rec)],
        "losses": losses[:3],
        "median_step_s": sorted(times[3:])[len(times[3:]) // 2],
        "bucket_stats": bp.stats() if bp is not None else None,
        "schedule_prices_s": prices,
    }


def exchange_rank(rank: int, world: int, shape: tuple, device: str) -> dict:
    """The four comparisons' runs on this rank."""
    from repro_torch.configs import ShapeConfig, get_config, reduced
    from repro_torch.data import SyntheticLM
    from repro_torch.launch.mesh import make_mesh, rank_device
    dev = rank_device(device, rank)
    cfg = reduced(get_config(ARCH))
    tshape = ShapeConfig("bench", 32, 8, "train")
    ds = SyntheticLM(cfg.vocab_size, 32, 8, is_encdec=True,
                     frames_dim=cfg.d_model, frames_len=8)
    mesh = make_mesh(shape, ("data", "model"), device=dev)
    pod = make_mesh(POD_MESH, ("pod", "data", "model"), device=dev)
    fd, hw_path = tempfile.mkstemp(suffix=".json")
    with os.fdopen(fd, "w") as f:
        json.dump(HW_POD, f)
    try:
        go = lambda m, **kw: _drive(m, cfg, tshape, ds, **kw)
        return {
            "per_tensor": go(mesh, bucket_bytes=0),
            "bucketed": go(mesh, bucket_bytes=4 * 1024 * 1024),
            "overlap_on": go(mesh, bucket_bytes=256 * 1024, overlap=True),
            "overlap_off": go(mesh, bucket_bytes=256 * 1024, overlap=False),
            "ring": go(pod, bucket_bytes=1024 * 1024),
            "two_level": go(pod, bucket_bytes=1024 * 1024,
                            hw_profile=hw_path),
        }
    finally:
        os.unlink(hw_path)


def _diverge(a: dict, b: dict) -> float:
    return max(abs(x - y) for x, y in zip(a["losses"], b["losses"]))


def run(device="cuda") -> dict:
    """The comparisons on 4 ranks (rank 0's record; the losses agree on
    every rank) with the reference's structural checks."""
    ranks = run_on_mesh(exchange_rank, MESH, device, args=(device,))
    r = ranks[0]
    res = {
        "device": device_name(device), "world": len(ranks),
        "n_dense_params": r["bucketed"]["bucket_stats"]["n_params_bucketed"],
        "per_tensor": r["per_tensor"], "bucketed": r["bucketed"],
        "loss_divergence": _diverge(r["per_tensor"], r["bucketed"]),
        "overlap": {"on": r["overlap_on"], "off": r["overlap_off"],
                    "loss_divergence": _diverge(r["overlap_on"],
                                                r["overlap_off"]),
                    "step_time_ratio": r["overlap_off"]["median_step_s"]
                    / r["overlap_on"]["median_step_s"]},
        "topology": {"ring": r["ring"], "two_level": r["two_level"],
                     "loss_divergence": _diverge(r["ring"],
                                                 r["two_level"])},
    }
    flat, fused = r["per_tensor"], r["bucketed"]
    ov = res["overlap"]
    two = r["two_level"]["bucket_stats"]
    prices = r["two_level"]["schedule_prices_s"]
    checks = {
        "every step carries out its plan": all(
            not x["findings"] for x in r.values()),
        "the ranks agree": all(
            q[k]["losses"] == r[k]["losses"] for q in ranks for k in r),
        "bucketing cuts all-reduces": fused["all_reduce_count"]
        < flat["all_reduce_count"],
        "bucketing keeps the all-reduce bytes": fused[
            "all_reduce_wire_bytes"] == flat["all_reduce_wire_bytes"],
        "bucketed losses within 2e-5": res["loss_divergence"] < 2e-5,
        "overlap keeps the bytes": ov["on"]["collective_wire_bytes"]
        == ov["off"]["collective_wire_bytes"],
        "overlap is the same sum": ov["loss_divergence"] == 0.0,
        "overlap issues inside the backward": ov["on"][
            "buckets_in_backward"] > 0
        and ov["off"]["buckets_in_backward"] == 0,
        "the fitted tier takes two-level": two["n_two_level"] >= 1
        and two["hosts"] == 2
        and r["ring"]["bucket_stats"]["n_two_level"] == 0
        and prices["two_level"] < prices["ring"],
        "two-level losses within 2e-5": res["topology"][
            "loss_divergence"] < 2e-5,
    }
    res["checks"] = checks
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"bucket_exchange: {failed}: "
                             f"{json.dumps(res, default=str)[:3000]}")
    return res


def main(device="cuda", out: str = OUT) -> dict:
    res = run(device)
    flat, fused = res["per_tensor"], res["bucketed"]
    stats = fused["bucket_stats"]
    dev = f"device={res['device']}"
    emit("buckets/all_reduce_count", fused["all_reduce_count"],
         f"per_tensor={flat['all_reduce_count']};"
         f"n_dense={res['n_dense_params']};{dev}")
    emit("buckets/wire_bytes", fused["collective_wire_bytes"],
         f"per_tensor={flat['collective_wire_bytes']:.0f};"
         f"all_reduce={fused['all_reduce_wire_bytes']:.0f};"
         f"per_tensor_all_reduce={flat['all_reduce_wire_bytes']:.0f};{dev}")
    emit("buckets/est_exchange_us", stats["est_seconds"] * 1e6,
         f"per_tensor_us={stats['est_seconds_unbucketed'] * 1e6:.1f};"
         f"n_buckets={stats['n_buckets']};{dev}")
    emit("buckets/loss_divergence", res["loss_divergence"],
         f"steps=3;dtype=f32;{dev}")
    ov = res["overlap"]
    emit("buckets/overlap_step_us", ov["on"]["median_step_s"] * 1e6,
         f"no_overlap_us={ov['off']['median_step_s'] * 1e6:.1f};"
         f"ratio={ov['step_time_ratio']:.3f};"
         f"divergence={ov['loss_divergence']};{dev}")
    topo = res["topology"]
    two = topo["two_level"]
    prices = two["schedule_prices_s"]
    emit("buckets/two_level_est_us", prices["two_level"] * 1e6,
         f"ring_same_hw_us={prices['ring'] * 1e6:.1f};"
         f"n_two_level={two['bucket_stats']['n_two_level']};"
         f"hosts={two['bucket_stats']['hosts']};"
         f"divergence={topo['loss_divergence']};{dev}")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        json.dump(res, f, indent=2, sort_keys=True)
    print(f"wrote {os.path.normpath(out)}", flush=True)
    return res
