"""Kernel benchmarks through the port (the port of
``benchmarks/kernel_bench.py``), written to ``results/torch_kernels.json``
(never ``BENCH_kernels.json``):

  * each kernel against its plain version (kernels/ref.py) at the
    reference's shapes — flash_attention at (1, 512, 8, 64) and (1, 1024,
    8, 128) bf16 causal; embed_gather and embed_scatter_add at (Vs, E, N)
    = (4096, 512, 1024) and (32768, 1024, 4096) f32; wkv at (2, 512, 4,
    64) f32 — on the card the kernel's time beside the plain version's
    and its largest difference from it (embed kernels bit for bit; flash
    within 2e-2, wkv within 1e-4); on the CPU the wrapper is the plain
    version, so only its time;
  * the fused bucket-apply (``Optimizer.update_fused`` over the flat
    post-all-reduce buffers and the fused m/v layout) against the
    per-parameter apply over the same buffers sliced into leaves: 16
    leaves of (512, 512) f32 in 4 buckets, the states bit for bit equal
    (asserted) and both times;
  * the autotune sweep (kernels/autotune.py) of the one-pass scatter at
    (4096, 256, 128) and at parallax-lm's table ((800,000, 512), 2,560
    bf16 rows): on the card every measured R, the chosen one and tuned
    <= fixed (asserted: the argmin includes R = 0); the roofline's ranking
    beside it; on the CPU nothing is measured;
  * the switch contrasts: ``fused_apply`` on and off on gloo (4, 1) ranks
    (the reference's 8 fake devices) and ``kernel_autotune`` on and off
    on ``device`` (reduced parallax-lm, deterministic algorithms), each a
    0.0 loss divergence (asserted): neither switch may change the math.

    PYTHONPATH=src python -m repro_torch.benchmarks.run kernels [--device cpu]
"""
from __future__ import annotations

import json
import os
import statistics
import tempfile

import torch

from repro_torch.benchmarks.common import (RESULTS, device_name, emit,
                                           run_on_mesh, time_fn)
from repro_torch.kernels import ops, ref

OUT = os.path.join(RESULTS, "torch_kernels.json")
FLASH_SHAPES = [(1, 512, 8, 64), (1, 1024, 8, 128)]
EMBED_SHAPES = [(4096, 512, 1024), (32768, 1024, 4096)]
WKV_SHAPES = [(2, 512, 4, 64)]
SWEEP_SHAPES = [(4096, 256, 128, torch.float32),
                (800_000, 512, 2560, torch.bfloat16)]
SWITCH_STEPS = 5


def _ms(fn, device) -> float:
    """Median ms of ``fn()``: CUDA events over 20 calls after 3 on the
    card, ``common.time_fn`` (host clock) on the CPU."""
    if torch.device(device).type != "cuda":
        return time_fn(fn, device=device) * 1e3
    for _ in range(3):
        fn()
    times = []
    for _ in range(20):
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def _compare(name: str, kernel, plain, device, tol: float) -> dict:
    """Time the wrapper and its plain version; on the card hold the one
    against the other (``tol`` 0: bit for bit)."""
    row = {"plain_ms": _ms(plain, device)}
    if torch.device(device).type == "cuda":
        got, want = kernel(), plain()
        got = got[0] if isinstance(got, tuple) else got
        want = want[0] if isinstance(want, tuple) else want
        err = float((got.float() - want.float()).abs().max())
        assert err <= tol, f"{name}: {err} from its plain version " \
            f"(bar {tol})"
        row.update(kernel_ms=_ms(kernel, device), max_abs_err=err)
    return row


def kernel_paths(device: str = "cuda") -> dict:
    dev = torch.device(device)
    gen = torch.Generator(device="cpu").manual_seed(0)
    out = {}
    for b, s, h, d in FLASH_SHAPES:
        q, k, v = (torch.randn((b, s, h, d), generator=gen)
                   .to(torch.bfloat16).to(dev) for _ in range(3))
        with torch.no_grad():
            out[f"flash/b{b}s{s}h{h}d{d}"] = _compare(
                "flash_attention", lambda: ops.flash_attention(q, k, v),
                lambda: ref.flash_attention_ref(q, k, v), device, 2e-2)
    for vs, e, n in EMBED_SHAPES:
        table = torch.randn((vs, e), generator=gen).to(dev)
        ids = torch.randint(-vs // 2, 2 * vs, (n,), generator=gen,
                            dtype=torch.int32)
        uniq = torch.unique(ids)
        uids = torch.cat([uniq, torch.full((n - len(uniq),), 2 * vs,
                                           dtype=torch.int32)])
        ids, uids = ids.to(dev), uids.to(dev)
        rows = torch.randn((n, e), generator=gen).to(dev)
        out[f"embed_gather/v{vs}e{e}n{n}"] = _compare(
            "embed_gather", lambda: ops.embed_gather(table, ids),
            lambda: ref.embed_gather_ref(table, ids, 0), device, 0.0)
        out[f"embed_scatter_add/v{vs}e{e}n{n}"] = _compare(
            "embed_scatter_add", lambda: ops.embed_scatter_add(uids, rows,
                                                               vs),
            lambda: ref.embed_scatter_add_ref(uids, rows, vs), device, 0.0)
    for b, s, h, e in WKV_SHAPES:
        r, kk, v = (torch.randn((b, s, h, e), generator=gen).to(dev)
                    for _ in range(3))
        lw = -torch.exp(torch.randn((b, s, h, e), generator=gen) * 0.3
                        - 1).to(dev)
        u = (torch.randn((h, e), generator=gen) * 0.1).to(dev)
        st = torch.zeros((b, h, e, e), device=dev)
        out[f"wkv/b{b}s{s}h{h}e{e}"] = _compare(
            "wkv", lambda: ops.wkv(r, kk, v, lw, u, st),
            lambda: ref.wkv_chunked_ref(r, kk, v, lw, u, st), device, 1e-4)
    return out


def fused_apply_bench(device: str = "cuda") -> dict:
    """The fused bucket-apply against the per-parameter apply over the
    same flat buffers: one update each from equal states, bit for bit
    equal (asserted by ``main``), and the median time of each."""
    from repro_torch.core.buckets import Bucket, BucketPlan
    from repro_torch.optim.optimizer import adamw, fuse_state, unfuse_state
    dev = torch.device(device)
    shape, n_leaves, per = (512, 512), 16, 4
    sz = shape[0] * shape[1]
    gen = torch.Generator(device="cpu").manual_seed(3)
    init = {f"w{i:02d}": torch.randn(shape, generator=gen)
            for i in range(n_leaves)}
    bufs = [torch.randn(per * sz, generator=gen).to(dev)
            for _ in range(n_leaves // per)]
    bp = BucketPlan(
        buckets=[Bucket(key=("allreduce", "float32", ()),
                        idx=tuple(range(k * per, (k + 1) * per)),
                        sizes=(sz,) * per, nbytes=per * sz * 4)
                 for k in range(n_leaves // per)],
        batch_axes=("data",), replicas=1, n_params=n_leaves,
        wire_bytes=n_leaves * sz * 4, bucket_bytes=per * sz * 4)
    names = list(init)
    opt = adamw(1e-2, weight_decay=0.1, clip_norm=1.0)

    def leaves(bufs):
        """The per-leaf gradients the unfused path materialises."""
        return {names[i]: bufs[k][j * sz:(j + 1) * sz].view(shape).clone()
                for k, b in enumerate(bp.buckets)
                for j, i in enumerate(b.idx)}

    def state():
        return opt.init({n: torch.nn.Parameter(t.clone().to(dev))
                         for n, t in init.items()})

    s_pp, s_fu = state(), fuse_state(state(), bp)
    s_pp, _ = opt.update(s_pp, leaves(bufs))
    s_fu, _ = opt.update_fused(s_fu, leaves(bufs), bufs, bp)
    back = unfuse_state(s_fu, bp)
    bit_equal = all(
        torch.equal(getattr(s_pp, part)[n], getattr(back, part)[n])
        for part in ("params", "m", "v") for n in names)
    t_pp, t_fu = state(), fuse_state(state(), bp)
    pp_ms = _ms(lambda: opt.update(t_pp, leaves(bufs)), device)
    fu_ms = _ms(lambda: opt.update_fused(t_fu, leaves(bufs), bufs, bp),
                device)
    return {"per_param_ms": pp_ms, "fused_ms": fu_ms,
            "speedup": pp_ms / fu_ms, "bit_equal": bool(bit_equal),
            "n_leaves": n_leaves, "n_buckets": len(bp.buckets),
            "param_bytes": n_leaves * sz * 4}


def autotune_sweep(device: str = "cuda") -> dict:
    """The measured sweep at two shapes (fresh, in memory: no cache file
    is read or written) and the roofline's ranking of the candidates."""
    from repro_torch.kernels import autotune
    from repro_torch.utils import roofline
    out = {}
    for vs, e, n, dtype in SWEEP_SHAPES:
        best, us = autotune.tune("scatter", vs, e, n, dtype, cache={},
                                 device=device)
        item = torch.empty((), dtype=dtype).element_size()
        row = {"shape": [vs, e, n], "dtype": str(dtype).removeprefix(
            "torch."), "best_block": best,
               "sweep_us": {str(k): v for k, v in us.items()},
               "est_us": {str(r): roofline.embed_tile_seconds(
                   n, e, r, item, vs) * 1e6
                   for r in roofline.kernel_tile_candidates(vs)}}
        if us:
            row.update(fixed_us=us[0], tuned_us=us[best])
        out[f"v{vs}e{e}n{n}"] = row
    return out


def _switch_losses(run_cfg, device: str, steps: int = SWITCH_STEPS,
                   mesh=None) -> tuple:
    from repro_torch.configs import ShapeConfig, get_config, reduced
    from repro_torch.core.transform import get_runner
    from repro_torch.data import SyntheticLM
    cfg = reduced(get_config("parallax-lm"))
    shape = ShapeConfig("bench", 32, 8, "train")
    ds = SyntheticLM(cfg.vocab_size, 32, 8)
    run = get_runner(cfg, shape, run_cfg, mesh=mesh, seed=0,
                     device=None if mesh is not None else device)
    losses = [float(run.run(ds.batch(i))["loss"]) for i in range(steps)]
    return run, losses


F32 = dict(param_dtype="float32", compute_dtype="float32",
           wire_dtype="float32")


def fused_switch_rank(rank, world, shape, device) -> dict:
    """One rank of the fused_apply switch: reduced parallax-lm on a
    (4, 1) mesh, f32, capped buffers, the dense exchange in buckets;
    fused_apply on, then off, from the same seed."""
    from repro_torch.configs import RunConfig
    from repro_torch.launch.mesh import make_mesh, rank_device
    mesh = make_mesh(shape, ("data", "model"),
                     device=rank_device(device, rank))
    out = {}
    for fused in (True, False):
        rc = RunConfig(**F32, comm_mode="mpi", capacity_mode="capped",
                       bucket_bytes=256 * 1024, fused_apply=fused)
        run, losses = _switch_losses(rc, device, mesh=mesh)
        out[str(fused)] = {"losses": losses,
                           "fused_flag": bool(run.plan.fused_apply)}
    return out


def switches(device: str = "cuda") -> dict:
    """fused_apply on / off over gloo (4, 1) ranks, kernel_autotune on /
    off on ``device``: the loss divergence of each."""
    from repro_torch.configs import RunConfig
    ranks = run_on_mesh(fused_switch_rank, (4, 1), device, args=(device,))
    on, off = ranks[0]["True"], ranks[0]["False"]
    res = {"fused": {
        "on_losses": on["losses"][:3], "off_losses": off["losses"][:3],
        "loss_divergence": max(abs(a - b) for a, b in
                               zip(on["losses"], off["losses"])),
        "fused_flag": on["fused_flag"] and not off["fused_flag"]}}
    det = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    cache = tempfile.mkdtemp(prefix="autotune_")
    old = os.environ.get("REPRO_TORCH_AUTOTUNE_CACHE")
    os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = os.path.join(cache, "t.json")
    try:
        _, fixed = _switch_losses(RunConfig(**F32), device, 3)
        run, tuned = _switch_losses(RunConfig(**F32, kernel_autotune=True),
                                    device, 3)
    finally:
        torch.use_deterministic_algorithms(det)
        if old is None:
            os.environ.pop("REPRO_TORCH_AUTOTUNE_CACHE")
        else:
            os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = old
    res["autotune"] = {
        "fixed_losses": fixed, "tuned_losses": tuned,
        "loss_divergence": max(abs(a - b) for a, b in zip(fixed, tuned)),
        "tiles": list(run.plan.table_tiles.get("embed", (0, 0)))}
    return res


def main(device: str = "cuda") -> dict:
    dev = device_name(device)
    res = {"device": dev, "kernels": kernel_paths(device),
           "fused_apply": fused_apply_bench(device),
           "autotune": autotune_sweep(device),
           "switches": switches(device)}
    for name, r in res["kernels"].items():
        if "kernel_ms" in r:
            emit(f"kernels/{name}", r["kernel_ms"] * 1e3,
                 f"plain_ms={r['plain_ms']:.4f};"
                 f"max_abs_err={r['max_abs_err']:.3g};device={dev}")
        else:
            emit(f"kernels/{name}_plain", r["plain_ms"] * 1e3,
                 f"the wrapper is its plain version here;device={dev}")
    fa = res["fused_apply"]
    emit("kernels/apply_fused", fa["fused_ms"] * 1e3,
         f"per_param_ms={fa['per_param_ms']:.3f};"
         f"speedup={fa['speedup']:.2f};bit_equal={fa['bit_equal']};"
         f"device={dev}")
    for name, r in res["autotune"].items():
        if "tuned_us" in r:
            emit(f"kernels/autotune_scatter/{name}", r["tuned_us"],
                 f"fixed_us={r['fixed_us']:.1f};block={r['best_block']};"
                 f"device={dev}")
        else:
            emit(f"kernels/autotune_scatter/{name}", 0.0,
                 f"not measured: the plain scatter has no tile;device={dev}")
    sw = res["switches"]
    emit("kernels/fused_switch_divergence", sw["fused"]["loss_divergence"],
         f"steps={SWITCH_STEPS};dtype=f32;mesh=(4,1) gloo;device={dev}")
    emit("kernels/autotune_switch_divergence",
         sw["autotune"]["loss_divergence"],
         f"steps=3;dtype=f32;tiles={sw['autotune']['tiles']};device={dev}")
    check(res)
    os.makedirs(RESULTS, exist_ok=True)
    with open(OUT, "w") as f:
        json.dump(res, f, indent=2, sort_keys=True)
    print(f"wrote {os.path.normpath(OUT)}")
    return res


def check(res: dict) -> None:
    """The contracts: the fused apply bit for bit; the sweep's argmin
    never loses to R = 0; neither switch moves the f32 losses."""
    assert res["fused_apply"]["bit_equal"], res["fused_apply"]
    for r in res["autotune"].values():
        if "tuned_us" in r:
            assert r["tuned_us"] <= r["fixed_us"], r
    sw = res["switches"]
    assert sw["fused"]["fused_flag"], sw["fused"]
    assert sw["fused"]["loss_divergence"] == 0.0, sw["fused"]
    assert sw["autotune"]["loss_divergence"] == 0.0, sw["autotune"]


if __name__ == "__main__":
    main()
