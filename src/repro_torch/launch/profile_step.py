"""Where the time of one training step goes, on the card.

    PYTHONPATH=src python -m repro_torch.launch.profile_step

Drives the same main path as chip_smoke.py (full-width parallax-lm,
ShapeConfig("lm1b", 20, 128), default RunConfig) and prints JSON lines:

  stages    per-step device time of the forward (lookup, LSTM, head, loss),
            the backward, and the update (OPSW cast, clipping, AdamW), from
            CUDA events with a synchronize between stages;
  profile   torch.profiler over 3 steady steps (``profiled``): per step,
            device time by kernel class and the top kernels by name, and
            the device's idle share (1 - union of kernel intervals /
            profiled wall window).

The chrome trace goes to results/profile_step/trace.json. Needs a card;
without one it exits non-zero.
"""
from __future__ import annotations

import json
import statistics
import sys
import time
from collections import defaultdict
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import RunConfig, ShapeConfig, get_config
from repro_torch.core.transform import get_runner, opsw_cast
from repro_torch.data import SyntheticLM

STEPS = 3
OUT = Path(__file__).resolve().parents[3] / "results" / "profile_step"

# kernel-name fragment -> class, first match wins
CLASSES = (
    ("gather_rows", "embed_gather"), ("gather_bulk", "embed_gather"),
    ("scatter_rows", "embed_scatter_add"),
    ("scatter_fused", "embed_scatter_add"),
    ("flash_fwd", "flash_attention"),
    ("wkv_fwd", "wkv"), ("wkv_tc", "wkv"), ("wkv_step", "wkv"),
    ("nvjet", "gemm"), ("gemm", "gemm"), ("xmma", "gemm"),
    ("cutlass", "gemm"),
    ("reduce_kernel", "reduction"),
    ("sort", "sort_scan"), ("radix", "sort_scan"), ("scan", "sort_scan"),
    ("index", "index"), ("scatter_gather", "index"), ("gather", "index"),
    ("fill", "fill"), ("Memset", "fill"),
    ("Memcpy", "copy"),
    ("elementwise", "elementwise"),
)


def _class(name: str) -> str:
    for frag, cls in CLASSES:
        if frag in name:
            return cls
    return "other"


def _emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def _stage_times(runner, batches) -> dict:
    """Forward / backward / update device times of each step (CUDA events,
    synchronized between stages so each bracket holds one stage)."""
    model, opt = runner.model, runner.optimizer
    state, plan = runner.state, runner.plan
    out = defaultdict(list)
    for b in batches:
        b = {k: torch.as_tensor(v).to(runner.rt.device)
             for k, v in b.items()}
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        torch.cuda.synchronize()
        ev[0].record()
        loss, _ = model.loss_fn(b)
        ev[1].record()
        loss.backward()
        ev[2].record()
        grads = {n: p.grad for n, p in state.params.items()}
        for p in state.params.values():
            p.grad = None
        state, _ = opt.update(state, opsw_cast(grads, plan))
        del grads
        ev[3].record()
        torch.cuda.synchronize()
        for k, (a, z) in zip(("forward_ms", "backward_ms", "update_ms"),
                             zip(ev, ev[1:])):
            out[k].append(a.elapsed_time(z))
    return {k: statistics.median(v) for k, v in out.items()}


def _union_us(intervals) -> float:
    busy, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy


def profiled(fn, per: int, trace_path: Path, top: int = 10) -> dict:
    """Run ``fn`` once under torch.profiler and return its device time per
    unit (``per`` units in the call): wall and kernel ms, kernel ms by
    class, the top kernels by name, and the device's idle share (1 - union
    of kernel intervals / the profiled wall window). The chrome trace goes
    to ``trace_path``."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_class, by_name = defaultdict(float), defaultdict(float)
    for e in kern:
        us = e.time_range.elapsed_us()
        by_class[_class(e.name)] += us
        by_name[e.name] += us
    busy = _union_us((e.time_range.start, e.time_range.end) for e in kern)
    names = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    trace_path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(trace_path))
    return {"device_kernels": len(kern),
            "wall_ms": wall_us / 1e3 / per,
            "kernel_ms": sum(by_class.values()) / 1e3 / per,
            "idle_share": (1.0 - busy / wall_us) if kern else None,
            "by_class_ms": {k: v / 1e3 / per for k, v in
                            sorted(by_class.items(), key=lambda kv: -kv[1])},
            "top_kernels_ms": [[n[:120], v / 1e3 / per] for n, v in names]}


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("profile_step: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("parallax-lm")
    shape = ShapeConfig("lm1b", seq_len=20, global_batch=128, kind="train")
    runner = get_runner(cfg, shape, RunConfig(), device="cuda")
    ds = SyntheticLM(cfg.vocab_size, shape.seq_len, shape.global_batch)
    warm = [ds.batch(i) for i in range(2)]
    for b in warm:
        runner.run(b)
    torch.cuda.synchronize()
    stages = _stage_times(runner, [ds.batch(i) for i in range(2, 5)])
    _emit({"phase": "stages", "device": torch.cuda.get_device_name(0),
           **stages, "step_ms": sum(stages.values())})

    batches = [ds.batch(i) for i in range(5, 5 + STEPS)]

    def steps():
        for b in batches:
            runner.run(b)

    _emit({"phase": "profile", "steps": STEPS,
           **profiled(steps, STEPS, OUT / "trace.json", top=15)})

if __name__ == "__main__":
    main()
