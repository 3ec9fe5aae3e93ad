"""Where the time of one training step goes, on the card.

    PYTHONPATH=src python -m repro_torch.launch.profile_step \
        [--arch parallax-lm|parallax-nmt|phi3-medium-14b|
                seamless-m4t-medium|hymba-1.5b|chameleon-34b|rwkv6-7b]

Drives the same training path as chip_smoke.py's ``main`` (full-width
parallax-lm, ShapeConfig("lm1b", 20, 128), default RunConfig), its
``nmt`` (full-width parallax-nmt, ShapeConfig("wmt", 50, 128), the
reference's two-table knobs, AdamW at 1e-4) or its ``dense_train``
(phi3-medium-14b at its published width with 8 of 40 layers,
ShapeConfig("train", 512, 8), default RunConfig, Zipf(1.3) tokens), or one
of the other families' training paths at the same shape and RunConfig
(``seamless_train``, ``hymba_train``, ``chameleon_train``, ``rwkv_train``;
the depths in ``CELLS``), and prints JSON lines:

  stages    per-step device time of the forward (lookup, LSTM, head, loss),
            the backward, and the update (OPSW cast, clipping, AdamW), from
            CUDA events with a synchronize between stages;
  profile   torch.profiler over 3 steady steps (``profiled``): per step,
            device time by kernel class and the top kernels by name, and
            the device's idle share (1 - union of kernel intervals /
            profiled wall window).

The chrome trace goes to results/profile_step/trace.json (parallax-nmt:
nmt_trace.json). Needs a card; without one it exits non-zero.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import sys
import time
from collections import defaultdict
from pathlib import Path
from typing import NamedTuple, Optional

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import (ModelConfig, RunConfig, ShapeConfig,
                                get_config)
from repro_torch.core.transform import get_runner, opsw_cast
from repro_torch.data import SyntheticLM

STEPS = 3
OUT = Path(__file__).resolve().parents[3] / "results" / "profile_step"


class Cell(NamedTuple):
    """A training path chip_smoke.py drives and this script profiles."""
    shape: ShapeConfig
    run: RunConfig
    data: dict                  # SyntheticLM options
    trace: str                  # the chrome trace's file name
    n_layers: Optional[int] = None  # the depth kept (None: published)


# arch -> its cell: chip_smoke.py's main, nmt and dense_train. parallax-nmt
# takes the reference's two-table knobs and AdamW at 1e-4: at the default
# 1e-3 its full-width loss spikes by the third step (in bf16 and f32, with
# the embed kernels or their plain versions alike: the model's math).
# phi3-medium-14b keeps 8 of its 40 layers: all 40 layers' bf16 params and
# grads with f32 AdamW moments (~176 GB) do not fit the card's 80 GB.
# The other families at launch/train.py's default shape and RunConfig, at
# ~12 B a parameter: seamless-m4t-medium (0.98 B parameters, 12 + 12
# layers, 128 stub frames a row) and hymba-1.5b (1.47 B) whole;
# chameleon-34b at 4 of 48 layers (3.84 B, ~46 GB; all 48 would be
# ~34 B, ~400 GB) and rwkv6-7b at 8 of 32 (2.28 B, ~27 GB; all 32 are
# 7.5 B, ~90 GB). chameleon trains with AdamW at 1e-5: Adam's first step
# moves every weight by ~lr whatever its gradient, and at d 8,192 its loss
# jumps at step 2 at 1e-3 and at 1e-4 (12.08 -> 39.2, above 12.08 still at
# step 12); phi3 at d 5,120 recovers at 1e-3
_TRAIN = ShapeConfig("train", seq_len=512, global_batch=8, kind="train")
CELLS = {
    "parallax-lm": Cell(ShapeConfig("lm1b", seq_len=20, global_batch=128,
                                    kind="train"), RunConfig(), {},
                        "trace.json"),
    "parallax-nmt": Cell(ShapeConfig("wmt", seq_len=50, global_batch=128,
                                     kind="train"),
                         RunConfig(capacity_mode="capped",
                                   capacity_factor=1.5, link_latency=0.0,
                                   table_zipf=(("embed", 1.3),),
                                   table_alpha=(("enc_embed", 0.99),),
                                   learning_rate=1e-4),
                         {"is_encdec": True, "src_zipf_a": 0.0},
                         "nmt_trace.json"),
    "phi3-medium-14b": Cell(ShapeConfig("train", seq_len=512, global_batch=8,
                                        kind="train"), RunConfig(),
                            {"zipf_a": 1.3}, "phi3_trace.json", n_layers=8),
    "seamless-m4t-medium": Cell(_TRAIN, RunConfig(),
                                {"zipf_a": 1.3, "is_encdec": True,
                                 "frames_dim": 1024, "frames_len": 128},
                                "seamless_trace.json"),
    "hymba-1.5b": Cell(_TRAIN, RunConfig(), {"zipf_a": 1.3},
                       "hymba_trace.json"),
    "chameleon-34b": Cell(_TRAIN, RunConfig(learning_rate=1e-5),
                          {"zipf_a": 1.3}, "chameleon_trace.json",
                          n_layers=4),
    "rwkv6-7b": Cell(_TRAIN, RunConfig(), {"zipf_a": 1.3}, "rwkv_trace.json",
                     n_layers=8),
}


def cell_config(arch: str) -> ModelConfig:
    """``arch``'s published config at its cell's depth."""
    cfg, n = get_config(arch), CELLS[arch].n_layers
    return cfg if n is None else dataclasses.replace(cfg, n_layers=n)


class MeshCell(NamedTuple):
    """A training path chip_smoke.py drives on a process mesh of gloo
    ranks sharing the card."""
    arch: str
    mesh: tuple                 # (data, model)
    shape: ShapeConfig
    run: RunConfig
    data: dict                  # SyntheticLM options
    n_layers: Optional[int] = None  # the depth kept (None: published)


# chip_smoke.py's mesh_card_zero, mesh_card_dp, mesh_card_moe_tp and
# mesh_card_toy. The first two at the config's dtypes (bf16, AdamW at
# 1e-3, remat block, chunked attention), seq 512 and global batch 4,
# Zipf(1.3) tokens; ``table_alpha`` 1.0 prices the
# table's dense exchange below the gatherv push (the hybrid argmin at the
# estimated alpha picks mpi_gatherv, whose push scatters repeats on the
# plain version), so every rank pushes its unique ids one-pass.
# mesh_card_zero: phi3-medium-14b at its published width with 2 of its 40
# layers on (2, 1), ZeRO-1 (each rank half of every dense moment): its
# 1.71 B parameters are 3.4 GB of bf16 weights, 3.4 GB of gradients and
# 13.7 GB of f32 moments a rank at zero_stage 0, two ranks on one card.
# mesh_card_dp: hymba-1.5b whole (1.47 B parameters) on (2, 2) under dp
# (the model axis a batch axis: one row a rank) with ZeRO-1 over both
# axes (each rank a quarter of every dense moment): ~12 GB a rank.
# mesh_card_moe_tp and mesh_card_toy are served, not trained (their shape
# the engine's decode cell). mesh_card_moe_tp: grok-1-314b at its
# published width with 2 of its 64 layers on (1, 2) under moe_exec "tp",
# each rank every expert's d_ff/2 block: 2 layers of experts are 19.3 GB
# of bf16, 9.7 GB a rank, plus the stacked w_gate's 12.9 GB f32 draw at
# init. mesh_card_toy: ToyServer on rwkv6-7b whole on (1, 2) and on
# hymba-1.5b at 8 of its 32 layers on (2, 2): four gloo ranks step a
# hymba layer at ~19 ms (~190 host-staged collectives a 32-layer step
# took 608 ms a rank), so the whole model's ~320 device steps would take
# ~190 s of the script's limit.
MESH_CELLS = {
    "mesh_card_zero": MeshCell(
        "phi3-medium-14b", (2, 1), ShapeConfig("train", 512, 4, "train"),
        RunConfig(zero_stage=1, table_alpha=(("embed", 1.0),)),
        {"zipf_a": 1.3}, n_layers=2),
    "mesh_card_dp": MeshCell(
        "hymba-1.5b", (2, 2), ShapeConfig("train", 512, 4, "train"),
        RunConfig(dense_strategy="dp", zero_stage=1,
                  table_alpha=(("embed", 1.0),)),
        {"zipf_a": 1.3}),
    "mesh_card_moe_tp": MeshCell(
        "grok-1-314b", (1, 2), ShapeConfig("serve", 4096, 4, "decode"),
        RunConfig(moe_exec="tp", attention_impl="pallas"), {}, n_layers=2),
    "mesh_card_toy": MeshCell(
        "rwkv6-7b", (1, 2), ShapeConfig("serve", 2048, 4, "decode"),
        RunConfig(), {}),
    "mesh_card_toy_hymba": MeshCell(
        "hymba-1.5b", (2, 2), ShapeConfig("serve", 2048, 4, "decode"),
        RunConfig(), {}, n_layers=8),
}


def mesh_cell_config(name: str) -> ModelConfig:
    """``MESH_CELLS[name]``'s published config at its depth."""
    cell = MESH_CELLS[name]
    cfg = get_config(cell.arch)
    return (cfg if cell.n_layers is None
            else dataclasses.replace(cfg, n_layers=cell.n_layers))


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


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=sorted(CELLS), default="parallax-lm")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("profile_step: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = cell_config(args.arch)
    shape, rc, data_kw, trace, _ = CELLS[args.arch]
    runner = get_runner(cfg, shape, rc, device="cuda")
    ds = SyntheticLM(cfg.vocab_size, shape.seq_len, shape.global_batch,
                     **data_kw)
    warm = [ds.batch(i) for i in range(2)]
    for b in warm:
        runner.run(b)
    torch.cuda.synchronize()
    stages = _stage_times(runner, [ds.batch(i) for i in range(2, 5)])
    _emit({"phase": "stages", "arch": cfg.name,
           "device": torch.cuda.get_device_name(0),
           **stages, "step_ms": sum(stages.values())})

    batches = [ds.batch(i) for i in range(5, 5 + STEPS)]

    def steps():
        for b in batches:
            runner.run(b)

    _emit({"phase": "profile", "arch": cfg.name, "steps": STEPS,
           **profiled(steps, STEPS, OUT / trace, top=15)})

if __name__ == "__main__":
    main()
