#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises, so the script exits non-zero
and never prints the final line:

  1. banner   torch/CUDA versions, the card and its power limit, the
              process-group backends this torch has; TF32 off.
  2. build    nvcc builds the ten kernel libraries from src/repro_torch/
              kernels/csrc (one process per source, in parallel) into
              build/repro_torch/; -Xptxas -v's registers and spills.
  3. kernels  each kernel against its plain version on the card at the main
              paths' shapes and at edge cases: the embedding kernels bit for
              bit (torch.equal of the raw bits; embed_gather on the route
              ops.gather_route gives each case — the bulk kernel at
              parallax-lm's table and at phi3-medium-14b's and rwkv6-7b's,
              with the ids of a 2,048-token prefill and of a 4-slot decode
              step; the element kernel at E = 100 bf16 and at tables off a
              16-byte boundary — and the one-pass embed_scatter_add at the
              main shapes, a shard owning none of the ids (M = 8), one
              owning half (M = 2), ids out of order, -0.0 rows, Vs below
              one block and E = 100), the gather timed beside its element
              kernel and the scatter beside PR 11's zero fill + dump-row
              kernel and the library's zeros + index_copy_, an empty
              kernel's launch floor under the same timer,
              flash_attention within 2e-5 at f32 and 2e-2 at bf16 on the
              route ops.flash_route gives each case (bf16 at D 64/128:
              the tensor-core kernel, also at Sq 96/Sk 160 and 160/96
              causal, B 4 with Sq 200, an 8-row q tile and strided views;
              f32 and D 16/32: the scalar kernel), timed at the engine's
              prefill buckets 256..2,048 beside SDPA, wkv
              within 1e-4 at f32 and 5e-2 at bf16 of both its plain
              versions (chunked and sequential) on the route
              ops.wkv_route gives each case (bf16 with E 64 and S > 1:
              the tensor-core kernel; S = 1: the step kernel; else the
              scalar one) at rwkv6-7b's prefill (f32 and bf16 lw) and
              decode shapes, the reference's sweep, chunk 1/16/20/48/64,
              ragged S 2,047 and 100, a strided view, the step route at
              B 1 and 4, a tc prefill continued by 8 step tokens, chunk 16
              against 48, and clamped cases (chunk * |lw| > 80, held
              against the chunked version only); a misaligned view must
              raise on the tc route. Tolerances are absolute and relative,
              the reference's own bars; the difference is summation order.
              Kernel, plain and library-call times (CUDA events, median of
              50 runs, L2 flushed before each) beside the bound.
  4. parity   reduced parallax-lm at f32, the same parameters and batches,
              3 steps on the CPU and on the card, with the default RunConfig
              and with local_agg=False: losses within rtol 1e-4 (GEMM and
              index_add_ summation order differ on the card, and without
              local aggregation index_add_ adds repeated ids with atomics),
              the embed_* census metrics equal, the no-LA push through the
              plain scatter (no kernel launch).
  5. serve_parity  reduced phi3-medium-14b at f32, attention "pallas": the
              same parameters and prompts through Server(device="cpu") and
              Server(device="cuda"): prefill logits within rtol 1e-4, greedy
              tokens equal (at most 2 may differ, the reference's own
              allowance for argmax near-ties; any difference is printed).
  6. rwkv_parity  reduced rwkv6-7b at f32, the same parameters on the CPU
              and on the card: make_prefill_step logits and final carry
              within rtol 1e-4 (and 1e-4 of the max-abs scale), ToyServer
              greedy tokens equal (at most 2 may differ).
  7. rwkv_recurrence  rwkv6-7b at full width with n_layers cut to 2, f32,
              one 300-token prompt (9 chunks and a ragged 12): the chunked
              make_prefill_step and 300 one-token make_decode_step calls
              give the same last logits and every layer's carry within 1e-4
              of their max-abs scale.
  8. main     full-width parallax-lm, ShapeConfig("lm1b", 20, 128) and the
              default RunConfig (bf16): get_runner(..., device="cuda"), 10
              steps of SyntheticLM batches. Every loss finite, the last below
              the first, each embedding kernel launched exactly once per
              step, the gather on the bulk route and the scatter on the
              one-pass kernel. Then main_no_la: 3 such steps under
              RunConfig(local_agg=False), their pushes through the plain
              scatter (no embed_scatter_add launch), step ms and losses.
     Then the mesh path (launch/mesh.py ranks, spawned processes):
     mesh_one_rank: the same 3 first steps through get_runner(...,
              mesh=make_mesh((1, 1))) over a one-rank NCCL group: the plan
              (mpi_gatherv), losses equal to main's bit for bit, step ms,
              peak memory, launches (3 bulk gathers, the push through the
              plain scatter). mesh_card: 4 ranks on the one card over gloo
              (NCCL takes one card per rank; gloo stages what it has no
              CUDA path for through the host, so no time here is a
              multi-GPU exchange time): (a) reduced parallax-lm at f32 on a
              (2, 2) mesh, 3 steps under the six flag sets of the
              reference's correctness test (hybrid, ps, mpi, no LA, no
              OPAU, no OPSW), losses within 5e-4 + 1e-4 i of the one-device
              card run on the same batches and the embed_* census the plan
              implies; (b) full-width parallax-lm, bf16, RunConfig(
              comm_mode="ps") on (1, 4): each rank holds 200,000 table rows,
              pulls at row_offset m * 200,000 on the bulk route and pushes
              through the one-pass scatter, 3 each in 3 steps; losses
              within rel 1e-2 of main's; per-rank step ms and peak memory.
  9. serve    full-width phi3-medium-14b (40 layers, nothing cut), bf16,
              Server(..., RunConfig(attention_impl="pallas"),
              ServerConfig(max_batch=4, max_seq=2048)) on the card: 8
              requests with prompts of 200..1800 tokens, 16 new tokens each.
              All complete, no cross-slot mismatch, flash_attention launched
              40 times per prefill, every launch on the tensor-core route,
              embed_gather once per prefill and per decode step, all on the
              bulk route. TTFT, inter-token gaps and decode tokens/s over
              the run's window,
              prefill ms per bucket, one synthetic decode step (lens 1024),
              peak memory, clocks and power.
 10. rwkv_serve  full-width rwkv6-7b (32 layers, nothing cut), bf16,
              ToyServer(..., ServerConfig(max_batch=4, max_seq=2048)) on
              the card: 8 requests with prompts of 16..64 tokens (an
              unsourced smoke mix), 16 new tokens each, greedy. All
              complete; wkv launched n_layers times per device step (decode
              steps plus the teacher-forced prompt steps), every one on the
              step route, embed_gather once per device step (and once in
              the prefill below), all on the bulk route. TTFT, inter-token
              gaps and tokens/s over the run's window, one
              decode step over 4 slots, one 2,048-token make_prefill_step
              (its ms; 32 wkv launches, all on the tensor-core route), peak
              memory.

Each path (main, main_no_la, mesh_one_rank, mesh_card, serve,
rwkv_serve) runs with every launch count set to 0 just before it and read
just after: the mesh phases in each rank's own process (mesh_card's (a)
and (b) each so, the path's launches their sum, rank 0's), rwkv_serve's
serve loop and its 2,048-token prefill each so (the path's launches their
sum).

Then the card's name and power limit (nvidia-smi), one JSON line of the
kernels' numbers, and last {"ok": true, "device": {...}}.

It imports the port (src/repro_torch) and nothing of the JAX package.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from dataclasses import replace
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import compat  # noqa: E402
from repro_torch.configs import (RunConfig, ShapeConfig, get_config,  # noqa: E402
                                 reduced)
from repro_torch.core.embedding import dedupe  # noqa: E402
from repro_torch.core.runtime import Runtime  # noqa: E402
from repro_torch.core.transform import (analyze, get_runner,  # noqa: E402
                                        init_params_, make_decode_step,
                                        make_prefill_step)
from repro_torch.data import SyntheticLM  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.launch.mesh import make_mesh, spawn  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.runtime.server import (Request, Server,  # noqa: E402
                                        ServerConfig, ToyServer, bucket_len)
from repro_torch.utils.roofline import HW  # noqa: E402
from repro_torch.utils.tree import named_parameters  # noqa: E402
from repro_torch.weights import load_reference_params  # noqa: E402

VOCAB, E, SEQ, BATCH = 800_000, 512, 20, 128      # parallax-lm, lm1b cell
TIMED_RUNS, WARMUP = 50, 5
KERNELS = {
    "embed_gather": {
        "route": "cuda",
        # rows of whole 16-byte units, every full-width path's route
        "source": "src/repro_torch/kernels/csrc/embed_gather_bulk.cu",
        "replaces": "src/repro/kernels/embed_gather.py:29",
        "design": ("bulk route: warps of independent copiers, each row one "
                   "cp.async.bulk into a lane's shared-memory slot "
                   "(mbarrier complete_tx) and one bulk store out; unowned "
                   "rows a bulk store of a zero tile; other rows: the "
                   "element route, a thread per 16 B or element"),
        "element_source": "src/repro_torch/kernels/csrc/embed_gather.cu",
    },
    "embed_scatter_add": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/embed_scatter_fused.cu",
        "replaces": "src/repro/kernels/embed_scatter.py:36",
        "design": ("one pass: short blocks of ~64 KB of output in launch "
                   "order, each mapping its rows to source ids in shared "
                   "memory and writing every row once (zeros or the "
                   "widened pushed row); no fill, no dump row"),
        "dump_row_source": "src/repro_torch/kernels/csrc/embed_scatter.cu",
    },
    "flash_attention": {
        "route": "cuda",
        # bf16 with D in {64, 128}, the full-width path's route
        "source": "src/repro_torch/kernels/csrc/flash_attention_tc.cu",
        "replaces": "src/repro/kernels/flash_attention.py:67",
        "design": ("bf16, D 64/128: wgmma m64n128k16 (S from shared "
                   "memory, P.V with P in registers), TMA 4-D tensor maps "
                   "with the 128 B swizzle, a 2-stage K/V mbarrier ring, "
                   "one producer thread and two consumer warpgroups "
                   "(setmaxnreg 24/240); f32 and D 16/32: scalar f32 FMAs"),
        "scalar_source": "src/repro_torch/kernels/csrc/flash_attention.cu",
    },
    # the three routes of ops.wkv (ops.wkv_route), one row each; "wkv" is
    # the scalar route (f32, narrow heads), which no full-width path takes
    "wkv": {
        "route": "cuda",
        "wkv_route": "scalar",
        "source": "src/repro_torch/kernels/csrc/wkv.cu",
        "replaces": "src/repro/kernels/wkv.py:68",
        "design": "f32 and E 16/32, S > 1: scalar f32 FMAs, state in shared "
                  "memory",
    },
    "wkv_tc": {
        "route": "cuda",
        "wkv_route": "tc",
        "source": "src/repro_torch/kernels/csrc/wkv_tc.cu",
        "replaces": "src/repro/kernels/wkv.py:68",
        "design": "bf16, E 64, S > 1: mma.sync m16n8k16 with bf16 hi/lo "
                  "operands, a TMA ring of chunk tiles, factor / product / "
                  "state warpgroups pipelined over chunks",
    },
    "wkv_step": {
        "route": "cuda",
        "wkv_route": "step",
        "source": "src/repro_torch/kernels/csrc/wkv_step.cu",
        "replaces": "src/repro/kernels/wkv.py:68",
        "design": "S = 1, f32 and bf16: one pass over the state, 16-byte "
                  "loads, warp-shuffle sums",
    },
}
# the kernels each path must launch (embed_scatter_add is a backward kernel;
# serving has no backward); rwkv_serve's wkv launches by route
PATH_KERNELS = {"main": ("embed_gather", "embed_scatter_add"),
                # local_agg=False: repeated ids take the plain scatter
                "main_no_la": ("embed_gather",),
                # the 1 x 1 mesh plans mpi_gatherv: its push (repeats
                # possible in general) takes the plain scatter
                "mesh_one_rank": ("embed_gather",),
                # ps on (1, 4): each rank's owner push is one-pass
                "mesh_card": ("embed_gather", "embed_scatter_add"),
                "serve": ("embed_gather", "flash_attention"),
                "rwkv_serve": ("embed_gather", "wkv_tc", "wkv_step")}
CENSUS = ("embed_rows", "embed_unique", "embed_dropped")
WKV_ROWS = {"scalar": "wkv", "tc": "wkv_tc", "step": "wkv_step"}
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
WKV_TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}
SERVE_BATCH, SERVE_MAX_SEQ = 4, 2048                # both serve phases
RWKV, RWKV_PREFILL = "rwkv6-7b", 2048
F32_CORE_FLOPS = 67e12      # f32 FMA rate of the CUDA cores (H100 SXM sheet)
# rwkv6 parameters that the seeded init leaves constant (zero mixes, zero
# decay LoRA factor, w0 and bonus): the parity phases draw them, so the
# data-dependent decay and the bonus are exercised. (scale, offset) of a
# normal draw; decays stay where chunk * |lw| <= 80 (the exact regime).
RWKV_DRAWN = {"tm.mu": (0.3, 0.0), "cm.mu": (0.3, 0.0),
              "tm.w_lora_b": (0.01, 0.0), "tm.w0": (0.3, -0.5),
              "tm.bonus": (0.3, 0.0)}


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

class Timer:
    """Median device time of a callable over CUDA events. Before each timed
    run a 256 MB buffer is zeroed: it evicts the 50 MB L2, as the main path
    finds the tables cold, and keeps the card busy while the host enqueues
    the timed call, so the events bracket device work."""

    def __init__(self, dev):
        self.flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)

    def ms(self, fn, runs: int = TIMED_RUNS) -> float:
        for _ in range(WARMUP):
            fn()
        torch.cuda.synchronize()
        pairs = []
        for _ in range(runs):
            self.flush.zero_()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            pairs.append((s, e))
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in pairs)


def host_ms(fn, calls: int = 200) -> float:
    """Host time to enqueue one call: ``calls`` back to back, timed before
    the synchronise, so a call whose device work is shorter than its host
    work is measured by the latter."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t
    torch.cuda.synchronize()
    return dt / calls * 1e3


def bound_ms(nbytes: int) -> float:
    return nbytes / HW.hbm_bw * 1e3


def ops_ms(flops: float) -> float:
    """Least time for ``flops`` at the card's bf16 tensor-core peak."""
    return flops / HW.peak_flops * 1e3


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_banner() -> dict:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False — this "
                 "script runs on a card")
    cap = compat.capability()
    check(compat.is_hopper(), f"compute capability {cap}, want (9, 0)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    info = {
        "phase": "banner",
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "python": sys.version.split()[0],
        "device": torch.cuda.get_device_name(0), "capability": list(cap),
        "count": torch.cuda.device_count(),
        "nvidia_smi": nvidia_smi("name,power.limit"),
        "nvcc": compat.nvcc_path(),
        "backends": {"nccl": compat.nccl_available(),
                     "gloo": compat.gloo_available()},
        "tf32": [torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32],
    }
    emit(info)
    return info


def phase_build() -> None:
    t0 = time.perf_counter()
    res = _build.build_all()
    for name in res:
        _build.load(name)
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
          "ptxas": {n: [ln for ln in r["log"].splitlines()
                        if "registers" in ln or "spill" in ln]
                    for n, r in res.items()}})


def _main_ids(dev) -> torch.Tensor:
    """The dedupe buffer of the main path's first batch (capacity = tokens,
    ascending unique ids padded with the sentinel VOCAB)."""
    toks = SyntheticLM(VOCAB, SEQ, BATCH).batch(0)["tokens"]
    flat = torch.from_numpy(np.ascontiguousarray(toks)).reshape(-1).to(dev)
    uids, _, _ = dedupe(flat, SEQ * BATCH, VOCAB, True)
    return uids


def _unique_sorted(rng, n: int, lo: int, hi: int, dev) -> torch.Tensor:
    """Sorted ids, unique among owned rows, with negatives and ids >= vs —
    the shape of tests/test_kernels.py's dedupe-buffer generator."""
    uniq = np.unique(rng.integers(lo, hi, size=4 * n))[:n]
    pad = np.full(max(n - uniq.size, 0), hi, np.int64)
    ids = np.concatenate([uniq, pad])[:n].astype(np.int32)
    return torch.from_numpy(ids).to(dev)


def _bits(t: torch.Tensor) -> torch.Tensor:
    """The raw bits of a bf16 or f32 tensor, so that torch.equal tells
    -0.0 from +0.0."""
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def _misaligned(table: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``table`` whose base lies one element past a
    16-byte boundary (the element route's case)."""
    flat = torch.empty(table.numel() + 1, dtype=table.dtype,
                       device=table.device)
    view = flat[1:].view(table.shape)
    view.copy_(table)
    return view


def _scatter_fns(ids, rows, vs: int, e: int) -> dict:
    """The push's function three ways on the same inputs: the one-pass
    kernel; PR 11's function (a zeroed (Vs + 1, E) buffer, the dump-row
    kernel, the slice); and the library's same function, timed whole
    (torch.zeros, index_copy_ of the widened rows with unowned ids sent to
    row Vs, the slice)."""
    dev = rows.device

    def dump_row():
        out = torch.zeros((vs + 1, e), dtype=torch.float32, device=dev)
        ops.scatter_into(ids, rows, out, vs)
        return out[:vs]

    def library():
        owned = (ids >= 0) & (ids < vs)
        dst = torch.where(owned, ids.long(), vs)
        out = torch.zeros((vs + 1, e), dtype=torch.float32, device=dev)
        return out.index_copy_(0, dst, rows.float())[:vs]

    return {"kernel": lambda: ops.embed_scatter_add(ids, rows, vs),
            "dump_row": dump_row, "library": library}


def phase_kernels(dev) -> dict:
    ops.reset_launch_counts()
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    rng = np.random.default_rng(0)
    uids = _main_ids(dev)
    n = uids.shape[0]
    t32 = torch.randn((VOCAB, E), generator=gen, device=dev)
    t16 = t32.to(torch.bfloat16)
    small32 = torch.randn((1000, 100), generator=gen, device=dev)
    small16 = small32.to(torch.bfloat16)
    off_ids = torch.from_numpy(rng.integers(
        -1000, VOCAB + 400_000 + 1000, size=n).astype(np.int32)).to(dev)
    small_ids = torch.from_numpy(rng.integers(
        -50, 1050, size=300).astype(np.int32)).to(dev)

    errs = {k: 0.0 for k in KERNELS}
    cases = []

    def hold(kernel: str, case: str, got, want):
        torch.cuda.synchronize()
        check(got.dtype == want.dtype and got.shape == want.shape,
              f"{kernel}/{case}: {got.dtype}{tuple(got.shape)} vs "
              f"{want.dtype}{tuple(want.shape)}")
        err = float((got.float() - want.float()).abs().max()) \
            if got.numel() else 0.0
        check(torch.equal(_bits(got), _bits(want)),
              f"{kernel}/{case}: not bitwise equal to the plain version "
              f"(max abs err {err})")
        errs[kernel] = max(errs[kernel], err)
        cases.append(f"{kernel}/{case}")

    def hold_gather(case, table, ids, off):
        route = ops.gather_route(table.shape[1] * table.element_size(),
                                 table.data_ptr())
        bulk0 = ops.embed_gather.launches_bulk
        got = ops.embed_gather(table, ids, off)
        check(ops.embed_gather.launches_bulk - bulk0 == (route == "bulk"),
              f"embed_gather/{case}: not launched on its {route} route")
        hold("embed_gather", f"{case}_{route}", got,
             ref.embed_gather_ref(table, ids, off))

    for case, table, ids, off in (
            ("main_bf16", t16, uids, 0), ("main_f32", t32, uids, 0),
            ("row_offset_bf16", t16, off_ids, 400_000),
            ("row_offset_f32", t32, off_ids, 400_000),
            ("narrow_e100_bf16", small16, small_ids, 0),
            ("narrow_e100_f32", small32, small_ids, 0),
            ("misaligned_bf16", _misaligned(t16), uids, 0),
            ("misaligned_f32", _misaligned(t32), uids, 0)):
        hold_gather(case, table, ids, off)
    # E = 100 in bf16 and the two misaligned tables; E = 100 in f32 (400 B
    # rows) is whole 16-byte units
    check(sum(c.endswith("_element") for c in cases) == 3,
          f"embed_gather: the element route took {cases}")
    torch.cuda.empty_cache()

    rows32 = torch.randn((n, E), generator=gen, device=dev)
    edge_ids = _unique_sorted(rng, n, -VOCAB // 4, VOCAB + VOCAB // 4, dev)
    small_rows32 = torch.randn((300, 100), generator=gen, device=dev)
    small_sc_ids = _unique_sorted(rng, 300, -100, 1100, dev)
    shuffled = uids[torch.randperm(n, generator=gen, device=dev)]
    signed_zero = rows32.clone()
    signed_zero[::3, ::5] = -0.0
    few = torch.from_numpy(rng.permutation(np.arange(-4, 12))
                           .astype(np.int32)).to(dev)
    for case, ids, rows, vs in (
            ("main_bf16", uids, rows32.to(torch.bfloat16), VOCAB),
            ("main_f32", uids, rows32, VOCAB),
            ("unowned_bf16", edge_ids, rows32.to(torch.bfloat16), VOCAB),
            ("unowned_f32", edge_ids, rows32, VOCAB),
            # a ps shard at M = 8 that owns none of the ids
            ("no_owned_id_m8", uids + VOCAB // 8, rows32, VOCAB // 8),
            # a shard at M = 2 owning about half of 2,560 spread ids
            ("half_owned_m2", _unique_sorted(rng, n, 0, VOCAB, dev),
             rows32.to(torch.bfloat16), VOCAB // 2),
            ("out_of_order_bf16", shuffled, rows32.to(torch.bfloat16),
             VOCAB),
            ("negative_zero_f32", uids, signed_zero, VOCAB),
            ("vs_below_a_block", few, rows32[:16], 5),
            ("narrow_e100_bf16", small_sc_ids,
             small_rows32.to(torch.bfloat16), 1000),
            ("narrow_e100_f32", small_sc_ids, small_rows32, 1000)):
        fused0 = ops.embed_scatter_add.launches_fused
        got = ops.embed_scatter_add(ids, rows, vs)
        check(ops.embed_scatter_add.launches_fused - fused0 == 1,
              f"embed_scatter_add/{case}: not on the one-pass kernel")
        hold("embed_scatter_add", case, got,
             ref.embed_scatter_add_ref(ids, rows, vs))
    del t32, rows32, signed_zero
    torch.cuda.empty_cache()

    # ---- timing at the main path's shapes: bf16 table, bf16 wire rows ----
    timer = Timer(dev)
    floor = _build.load("launch_floor")
    floor_ms = timer.ms(
        lambda: floor(torch.cuda.current_stream(dev).cuda_stream))
    owned = int(((uids >= 0) & (uids < VOCAB)).sum())
    clamped = uids.long().clamp(0, VOCAB - 1)
    g_bytes = (owned + n) * E * 2 + 4 * n
    gather = {
        "kernel_ms": timer.ms(lambda: ops.embed_gather(t16, uids, 0)),
        # PR 11's kernel, the element route, on the same inputs
        "element_ms": timer.ms(lambda: ops.gather_element(t16, uids, 0)),
        "plain_ms": timer.ms(lambda: ref.embed_gather_ref(t16, uids, 0)),
        # index_select reads a (clamped) row for every id and zeroes none:
        # the nearest single PyTorch call, timed only
        "library_ms": timer.ms(lambda: torch.index_select(t16, 0, clamped)),
        "floor_ms": floor_ms,
        "bytes": g_bytes, "bound_ms": bound_ms(g_bytes),
    }
    rows16 = torch.randn((n, E), generator=gen, device=dev).to(torch.bfloat16)
    fns = _scatter_fns(uids, rows16, VOCAB, E)
    # the function's bytes: every output byte written once, rows and ids
    # read once
    s_bytes = VOCAB * E * 4 + n * E * 2 + 4 * n
    all_owned = torch.from_numpy(rng.permutation(VOCAB)[:n]
                                 .astype(np.int32)).to(dev)
    none_owned = all_owned + VOCAB
    dump_buf = torch.zeros((VOCAB + 1, E), dtype=torch.float32, device=dev)
    scatter = {
        "kernel_ms": timer.ms(fns["kernel"]),
        # PR 11's function: zero fill, dump-row kernel, slice
        "dump_row_ms": timer.ms(fns["dump_row"]),
        # the dump-row kernel alone, into a buffer zeroed outside the timing
        "dump_row_kernel_ms": timer.ms(
            lambda: ops.scatter_into(uids, rows16, dump_buf, VOCAB)),
        "plain_ms": timer.ms(
            lambda: ref.embed_scatter_add_ref(uids, rows16, VOCAB)),
        "library_ms": timer.ms(fns["library"]),
        # the write rate the card gives a plain fill of the same output
        "fill_ms": timer.ms(
            lambda: torch.zeros((VOCAB, E), dtype=torch.float32,
                                device=dev)),
        # the dump-row test: 2,560 ids all owned, then none
        "all_owned_ms": timer.ms(
            lambda: ops.embed_scatter_add(all_owned, rows16, VOCAB)),
        "none_owned_ms": timer.ms(
            lambda: ops.embed_scatter_add(none_owned, rows16, VOCAB)),
        "floor_ms": floor_ms,
        "bytes": s_bytes, "bound_ms": bound_ms(s_bytes),
    }
    del t16, dump_buf, rows16
    torch.cuda.empty_cache()
    gather["shape"] = (f"parallax-lm: table ({VOCAB}, {E}) bf16, {n} ids "
                       f"({owned} owned; one training step's dedupe buffer)")
    scatter["shape"] = (f"parallax-lm: ({VOCAB}, {E}) f32 gradient from "
                        f"{n} bf16 rows ({owned} owned)")
    gather_serve = _serve_gather(dev, gen, timer, hold_gather,
                                 "phi3-medium-14b", _serve_ids(dev), "serve")
    gather_rwkv = _serve_gather(dev, gen, timer, hold_gather, RWKV,
                                _rwkv_ids(dev), "rwkv")
    flash = _flash_kernels(dev, gen, timer, errs, cases)
    wkv = _wkv_kernels(dev, gen, timer, errs, cases)
    res = {"phase": "kernels", "cases": cases, "n_ids": n, "owned": owned,
           "max_abs_err": errs, "launches": ops.launch_counts(),
           "embed_gather": gather, "embed_gather_serve": gather_serve,
           "embed_gather_rwkv": gather_rwkv,
           "embed_scatter_add": scatter, "flash_attention": flash, **wkv}
    emit(res)
    return res


def _serve_ids(dev) -> dict:
    """The ids the serve path hands embed_gather (phi3-medium-14b, exact
    capacity): the dedupe buffer of the serve phase's first prefill (its
    first prompt, 1,561 tokens zero-padded to the 2,048 bucket) and of one
    decode step's 4 tokens (batch 4, one token each)."""
    vs = get_config("phi3-medium-14b").vocab_size
    rng = np.random.default_rng(0)
    prompt = _serve_prompts(rng, vs)[1][0]
    toks = np.zeros(bucket_len(len(prompt), SERVE_MAX_SEQ), np.int32)
    toks[:len(prompt)] = prompt
    step = rng.integers(0, vs, size=SERVE_BATCH).astype(np.int32)
    out = {}
    for case, flat in (("prefill", toks), ("decode", step)):
        ids = torch.from_numpy(flat).to(dev)
        out[case], _, _ = dedupe(ids, min(ids.numel(), vs), vs, True)
    return out


def _rwkv_prompt(vocab: int) -> np.ndarray:
    """The 2,048-token prompt of rwkv_serve's make_prefill_step."""
    return np.random.default_rng(1).integers(
        0, vocab, size=(1, RWKV_PREFILL)).astype(np.int32)


def _rwkv_ids(dev) -> dict:
    """The ids the rwkv6 path hands embed_gather (exact capacity): the
    dedupe buffer of a 2,048-token prompt and of one 4-slot decode step."""
    vs = get_config(RWKV).vocab_size
    step = np.random.default_rng(2).integers(0, vs, size=SERVE_BATCH)
    out = {}
    for case, flat in (("prefill", _rwkv_prompt(vs)[0]),
                       ("decode", step.astype(np.int32))):
        ids = torch.from_numpy(flat).to(dev)
        out[case], _, _ = dedupe(ids, min(ids.numel(), vs), vs, True)
    return out


def _serve_gather(dev, gen, timer: Timer, hold_gather, arch: str,
                  ids: dict, tag: str) -> dict:
    """embed_gather at a serve path's shapes: ``arch``'s table (phi3-
    medium-14b's (100,352, 5,120), rwkv6-7b's (65,536, 4,096)) in bf16 (the
    served dtype) and f32, held bit for bit against its plain version on
    the route ``ops.gather_route`` gives it; kernel, element-route, plain
    and library times of the bf16 prefill and decode lookups beside their
    byte bounds."""
    cfg = get_config(arch)
    vs, d = cfg.vocab_size, cfg.d_model
    t32 = torch.randn((vs, d), generator=gen, device=dev)
    t16 = t32.to(torch.bfloat16)
    for case, uids in ids.items():
        for tname, table in (("bf16", t16), ("f32", t32)):
            hold_gather(f"{tag}_{case}_{tname}", table, uids, 0)
    del t32
    res = {}
    for case, uids in ids.items():
        n = uids.shape[0]
        owned = int(((uids >= 0) & (uids < vs)).sum())
        clamped = uids.long().clamp(0, vs - 1)
        nbytes = (owned + n) * d * 2 + 4 * n
        res[case] = {
            "shape": f"{arch}: table ({vs}, {d}) bf16, {n} ids "
                     f"({owned} owned)",
            "kernel_ms": timer.ms(lambda: ops.embed_gather(t16, uids, 0)),
            "element_ms": timer.ms(
                lambda: ops.gather_element(t16, uids, 0)),
            "plain_ms": timer.ms(lambda: ref.embed_gather_ref(t16, uids, 0)),
            "library_ms": timer.ms(
                lambda: torch.index_select(t16, 0, clamped)),
            "bytes": nbytes, "bound_ms": bound_ms(nbytes),
            "bound_by": "bytes"}
    return res


def _flash_work(b, sq, h, d, itemsize) -> dict:
    """Operations and bytes of one causal self-attention call: QK^T and P.V
    over the unmasked (q, k) pairs, 2 per FMA; q, k, v read and o written
    once."""
    flops = 4 * d * b * h * sq * (sq + 1) // 2
    nbytes = 4 * b * sq * h * d * itemsize
    t_ops, t_bytes = ops_ms(flops), bound_ms(nbytes)
    return {"flops": flops, "bytes": nbytes, "ops_bound_ms": t_ops,
            "bytes_bound_ms": t_bytes, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def _flash_kernels(dev, gen, timer: Timer, errs: dict, cases: list) -> dict:
    """flash_attention against its plain version at the serve path's main
    shape (one 2,048-token prefill of phi3-medium-14b: B 1, H 40, D 128,
    causal) and at edge cases, in f32 and bf16, each case on the route
    ``ops.flash_route`` gives it (bf16 at D 64 and 128: the tensor-core
    kernel; f32 and the narrow heads: the scalar one); times at the engine's
    prefill buckets (B 1, H 40, D 128, causal, bf16) beside SDPA's, and the
    f32 route's at the main shape."""
    def qkv(b, sq, sk, h, d, dtype):
        return [torch.randn((b, s_, h, d), generator=gen, device=dev)
                .to(dtype) for s_ in (sq, sk, sk)]

    def strided(b, s_, h, d, dtype):
        """q, k, v as non-contiguous (B, S, H, D) views, each a half of
        the last dimension of a (B, H, S, 2D) buffer."""
        base = torch.randn((3, b, h, s_, 2 * d), generator=gen,
                           device=dev).to(dtype)
        q = base[0, ..., :d].transpose(1, 2)
        return [q] + [base[i, ..., d:].transpose(1, 2) for i in (1, 2)]

    def hold(name, q, k, v, causal):
        route = ops.flash_route(q.dtype, q.shape[-1])
        tc0 = ops.flash_attention.launches_tc
        got = ops.flash_attention(q, k, v, causal=causal)
        want = ref.flash_attention_ref(q, k, v, causal=causal)
        torch.cuda.synchronize()
        check(ops.flash_attention.launches_tc - tc0 == (route == "tc"),
              f"flash_attention/{name}: not launched on its {route} route")
        check(got.dtype == want.dtype and got.shape == want.shape,
              f"flash_attention/{name}: {got.dtype}{tuple(got.shape)} vs "
              f"{want.dtype}{tuple(want.shape)}")
        diff = (got.float() - want.float()).abs()
        tol = FLASH_TOL[q.dtype]
        bad = diff > tol + tol * want.float().abs()
        err = float(diff.max())
        check(not bool(bad.any()) and bool(torch.isfinite(got).all()),
              f"flash_attention/{name}: {int(bad.sum())} elements outside "
              f"{tol} (max abs err {err})")
        errs["flash_attention"] = max(errs["flash_attention"], err)
        worst[name] = {"route": route, "max_abs_err": err}
        cases.append(f"flash_attention/{name}")

    worst = {}
    for case, (b, sq, sk, h, d), causals, dtypes in (
            ("main", (1, 2048, 2048, 40, 128), (True,), None),
            ("ragged", (1, 200, 200, 4, 64), (True, False), None),
            ("cross_lengths", (2, 96, 160, 2, 64), (False,), None),
            ("b2_d32", (2, 64, 64, 8, 32), (True, False), None),
            ("b2_d16", (2, 16, 16, 4, 16), (True, False), None),
            # the tensor-core route's edges, at phi3's head width
            ("sq96_sk160_d128", (2, 96, 160, 4, 128), (True, False),
             (torch.bfloat16,)),
            ("sq160_sk96_d128", (2, 160, 96, 4, 128), (True, False),
             (torch.bfloat16,)),
            ("b4_sq200_d128", (4, 200, 200, 40, 128), (True,),
             (torch.bfloat16,)),
            # one q tile of 8 rows: the engine's smallest prefill bucket
            ("sq8_d128", (1, 8, 8, 40, 128), (True, False),
             (torch.bfloat16,))):
        for dtype in dtypes or (torch.bfloat16, torch.float32):
            q, k, v = qkv(b, sq, sk, h, d, dtype)
            for causal in causals:
                hold(f"{case}_{'causal' if causal else 'full'}_"
                     f"{str(dtype).removeprefix('torch.')}", q, k, v, causal)
    for d, dtype in ((128, torch.bfloat16), (64, torch.bfloat16),
                     (64, torch.float32)):
        q, k, v = strided(2, 300, 8, d, dtype)
        check(not q.is_contiguous() and not k.is_contiguous(),
              "strided case made contiguous views")
        hold(f"strided_d{d}_causal_{str(dtype).removeprefix('torch.')}", q,
             k, v, True)

    # ---- timing at the engine's prefill buckets, bf16, causal ----
    sdpa = torch.nn.functional.scaled_dot_product_attention
    b, h, d = 1, 40, 128
    by_len = {}
    for s_ in (256, 512, 1024, 2048):
        q, k, v = qkv(b, s_, s_, h, d, torch.bfloat16)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))  # (B, H, S, D)
        work = _flash_work(b, s_, h, d, 2)
        t = timer.ms(lambda: ops.flash_attention(q, k, v))
        by_len[s_] = {
            "kernel_ms": t,
            # cuDNN / flash SDPA on a (B, H, S, D) view: timed only, never
            # called by the port
            "library_ms": timer.ms(lambda: sdpa(qt, kt, vt, is_causal=True)),
            "tflops": work["flops"] / t / 1e9,
            "share_of_bound": work["bound_ms"] / t, **work}
    main = by_len[2048]
    q32, k32, v32 = (x.float() for x in (q, k, v))
    # host time per call at the 128-token bucket, where a prefill is
    # host-bound: the tensor-core route encodes three tensor maps a call
    s_ = 128
    q_, k_, v_ = qkv(b, s_, s_, h, d, torch.bfloat16)
    qt_, kt_, vt_ = (x.transpose(1, 2) for x in (q_, k_, v_))
    q32_, k32_, v32_ = (x.float() for x in (q_, k_, v_))
    host = {"shape": f"({b}, {s_}, {h}, {d}), causal",
            "tc_bf16": host_ms(lambda: ops.flash_attention(q_, k_, v_)),
            "scalar_f32": host_ms(
                lambda: ops.flash_attention(q32_, k32_, v32_)),
            "library_bf16": host_ms(
                lambda: sdpa(qt_, kt_, vt_, is_causal=True))}
    return {
        "shape": (f"phi3-medium-14b prefill: ({b}, 2048, {h}, {d}) bf16, "
                  "causal"),
        "max_abs_err_by_case": worst, "by_len": by_len,
        "host_ms_per_call": host,
        "kernel_ms": main["kernel_ms"],
        "plain_ms": timer.ms(lambda: ref.flash_attention_ref(q, k, v)),
        "library_ms": main["library_ms"],
        # the f32 route (the scalar kernel) at the main shape
        "f32_ms": timer.ms(lambda: ops.flash_attention(q32, k32, v32)),
        **{key: main[key] for key in ("flops", "bytes", "ops_bound_ms",
                                      "bytes_bound_ms", "bound_ms",
                                      "bound_by", "tflops",
                                      "share_of_bound")},
    }


def _wkv_inputs(gen, b, s, h, e, dtype, lw_dtype=None, *, decay=(0.5, -1.0),
                bonus=0.1, state=0.1) -> list:
    """r, k, v (0.5 N), lw = -exp(a N + c), bonus and state (scaled N), as
    test_wkv_sweep draws them; r/k/v in ``dtype``, lw in ``lw_dtype``
    (default ``dtype``), bonus and state f32."""
    dev = gen.device
    rkv = [(torch.randn((b, s, h, e), generator=gen, device=dev) * 0.5)
           .to(dtype) for _ in range(3)]
    a, c = decay
    lw = -torch.exp(torch.randn((b, s, h, e), generator=gen, device=dev) * a
                    + c)
    u = torch.randn((h, e), generator=gen, device=dev) * bonus
    st = torch.randn((b, h, e, e), generator=gen, device=dev) * state
    return rkv + [lw.to(lw_dtype or dtype), u, st]


def _wkv_work(b, s, h, e, chunk, itemsize, lw_itemsize) -> tuple:
    """(bytes, FLOP) of one wkv call: r, k, v, lw read and out written
    once, bonus read, the state read and written; per (b, h) and chunk of
    n tokens, the products this data needs — the strictly lower qf kf^T and
    its product with v (n(n-1)/2 E MACs each), qf state and kdec^T v (n E^2
    each), the bonus term (2 n E) — at 2 FLOP per MAC."""
    n_el = b * s * h * e
    nbytes = n_el * (4 * itemsize + lw_itemsize) + 2 * b * h * e * e * 4 \
        + h * e * 4
    c, macs = min(chunk, s), 0
    for c0 in range(0, s, c):
        n = min(c, s - c0)
        macs += n * (n - 1) * e + 2 * n * e * e + 2 * n * e
    return nbytes, 2 * macs * b * h


def _wkv_bound(route, b, s, h, e, chunk, itemsize, lw_itemsize) -> dict:
    """The least time of one wkv call on its route: the larger of its bytes
    at the memory rate and its FLOP at the rate of the units the route's
    kernel computes on — the bf16 tensor cores (tc, 989 TFLOP/s) or the f32
    CUDA cores (scalar and step, 67 TFLOP/s)."""
    nbytes, flops = _wkv_work(b, s, h, e, chunk, itemsize, lw_itemsize)
    rate = HW.peak_flops if route == "tc" else F32_CORE_FLOPS
    t_ops, t_bytes = flops / rate * 1e3, bound_ms(nbytes)
    return {"flops": flops, "bytes": nbytes, "flop_rate": rate,
            "ops_bound_ms": t_ops, "bytes_bound_ms": t_bytes,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def _scalar_wkv(args, chunk: int):
    """The scalar route's kernel (csrc/wkv.cu, the one kernel wkv had
    before the tc and step routes) launched directly, whatever the dtype:
    the in-call yardstick of the routes that replaced it at these shapes.
    Not counted as a launch of ops.wkv."""
    r, k, v, lw, u, st = args
    b, s, h, e = r.shape
    out = torch.empty_like(r)
    s_out = torch.empty_like(st)
    strides = [x for t in (r, k, v, lw, out) for x in t.stride()[:3]]
    err = _build.load("wkv")(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), lw.data_ptr(), u.data_ptr(),
        st.data_ptr(), out.data_ptr(), s_out.data_ptr(), b, s, h, e, chunk,
        r.element_size(), lw.element_size(), *strides,
        torch.cuda.current_stream().cuda_stream)
    check(err == 0, f"wkv.cu launch failed with cudaError {err}")
    return out, s_out


def _wkv_kernels(dev, gen, timer: Timer, errs: dict, cases: list) -> dict:
    """wkv against both plain versions (chunked: the kernels' own function;
    sequential: the reference's oracle) on the route ops.wkv_route gives
    each case, which its name carries: rwkv6-7b's 2,048-token prompt (bf16
    r/k/v with f32 lw as the model passes them, and with bf16 lw) and 4-slot
    decode step; the reference's sweep in f32 and bf16; chunk 1/16/20/48/64
    at E = 64; ragged S 2,047 and 100; a strided (B, H, S, E)-laid view; the
    step route at B 1 and 4; a tc prefill continued by 8 step-route tokens
    from its final state, against the sequential version over all of them;
    chunk 16 against 48; and clamped cases (chunk * |lw| > 80, f32 and bf16)
    held against the chunked version only, where the sequential recurrence
    differs. A misaligned view must raise on the tc route. Times of each
    route at the shape the main path gives it, beside the scalar kernel's
    (csrc/wkv.cu) at the same shape."""
    worst = {}

    def hold(name, got, want, tol, route):
        torch.cuda.synchronize()
        err = 0.0
        for g, w in zip(got, want):
            check(g.dtype == w.dtype and g.shape == w.shape,
                  f"wkv/{name}: {g.dtype}{tuple(g.shape)} vs "
                  f"{w.dtype}{tuple(w.shape)}")
            diff = (g.float() - w.float()).abs()
            bad = diff > tol + tol * w.float().abs()
            err = max(err, float(diff.max()))
            check(not bool(bad.any()) and bool(torch.isfinite(g).all()),
                  f"wkv/{name}: {int(bad.sum())} elements outside {tol} "
                  f"(max abs err {float(diff.max())})")
        errs[WKV_ROWS[route]] = max(errs[WKV_ROWS[route]], err)
        worst[name] = err
        cases.append(f"wkv/{name}")

    def run(case, args, chunk, sequential=True):
        """ops.wkv on ``args`` against the chunked (and sequential) plain
        version; the case's name gets its dtype and route."""
        r, lw = args[0], args[3]
        route = ops.wkv_route(r.dtype, r.shape[3], r.shape[1])
        tol = WKV_TOL[r.dtype]
        lw_name = ("" if lw.dtype == r.dtype else
                   "_lw_" + str(lw.dtype).removeprefix("torch."))
        name = (f"{case}_{str(r.dtype).removeprefix('torch.')}{lw_name}"
                f"_{route}")
        got = ops.wkv(*args, chunk=chunk)
        hold(f"{name}_vs_chunked", got,
             ref.wkv_chunked_ref(*args, chunk=chunk), tol, route)
        if sequential:
            hold(f"{name}_vs_sequential", got, ref.wkv_ref(*args), tol,
                 route)
        return got

    h, e = get_config(RWKV).n_heads, get_config(RWKV).head_dim
    bf16, f32 = torch.bfloat16, torch.float32
    shapes = {"prefill": (1, RWKV_PREFILL, h, e, 32),
              "decode": (SERVE_BATCH, 1, h, e, 32),
              "sweep_e16_c16": (1, 64, 2, 16, 16),
              "sweep_e32_c32": (2, 100, 3, 32, 32),
              "sweep_e64_c32": (1, 31, 1, 64, 32)}
    for case, (b, s_, hh, ee, chunk) in shapes.items():
        for dtype in (bf16, f32):
            model_shape = case in ("prefill", "decode")
            run(case, _wkv_inputs(gen, b, s_, hh, ee, dtype,
                                  f32 if model_shape else dtype), chunk)
    # the tc route: bf16 lw at the prompt, every chunk size, ragged lengths
    run("prefill", _wkv_inputs(gen, 1, RWKV_PREFILL, h, e, bf16, bf16), 32)
    for chunk in (16, 48, 64):
        run(f"chunk{chunk}", _wkv_inputs(gen, 2, 300, 4, 64, bf16, f32),
            chunk)
    # chunks that are not a multiple of the 16-row tile
    for chunk in (1, 20):
        run(f"chunk{chunk}", _wkv_inputs(gen, 2, 150, 4, 64, bf16, f32),
            chunk)
    run("ragged_s2047", _wkv_inputs(gen, 1, 2047, 8, 64, bf16, f32), 32)
    run("ragged_s100", _wkv_inputs(gen, 2, 100, 4, 64, bf16, f32), 32)
    # a view laid out (B, H, S, E), as strided in s and h as it gets
    args = _wkv_inputs(gen, 2, 200, 4, 64, bf16, f32)
    views = [t.transpose(1, 2).contiguous().transpose(1, 2)
             for t in args[:4]]
    check(not views[0].is_contiguous(), "the strided case is contiguous")
    got = run("strided", views + args[4:], 32)
    want = ops.wkv(*args, chunk=32)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(got, want)),
          "wkv/strided: a strided view and its contiguous copy differ")
    # the step route at B 1 and 4 (decode above) in both dtypes
    for dtype in (bf16, f32):
        run("step_b1", _wkv_inputs(gen, 1, 1, h, e, dtype, f32), 32)
    # a tc prefill continued by 8 step-route tokens from its final state
    args = _wkv_inputs(gen, 1, 308, 8, 64, bf16, f32)
    o, st = ops.wkv(*[t[:, :300] for t in args[:4]], *args[4:], chunk=32)
    outs = [o]
    for t in range(300, 308):
        o, st = ops.wkv(*[x[:, t:t + 1] for x in args[:4]], args[4], st)
        outs.append(o)
    hold("continuity_tc_then_8_step_bf16_vs_sequential",
         (torch.cat(outs, dim=1), st), ref.wkv_ref(*args), WKV_TOL[bf16],
         "step")
    # chunk invariance and the clamped cases (the chunked version only)
    args = _wkv_inputs(gen, 1, 96, 2, 16, f32, decay=(1.0, -1.5),
                       bonus=0.0, state=0.0)
    o16 = ops.wkv(*args, chunk=16)
    hold("chunk16_vs_chunk48_float32_scalar", o16, ops.wkv(*args, chunk=48),
         1e-4, "scalar")
    hold("chunk16_vs_chunked_float32_scalar", o16,
         ref.wkv_chunked_ref(*args, chunk=16), 1e-4, "scalar")
    seq_gap = {}
    for dtype in (f32, bf16):
        args = _wkv_inputs(gen, 1, 96, 4, 64, dtype, f32, decay=(0.1, 1.1),
                           bonus=0.2)
        check(float(-args[3][:, :32].sum(dim=1).min()) > 80,
              "the clamped case does not reach chunk * |lw| > 80")
        got = run("clamped", args, 32, sequential=False)
        seq_gap[str(dtype)] = float(
            (got[0].float() - ref.wkv_ref(*args)[0].float()).abs().max())
        check(seq_gap[str(dtype)] > 1e-1,
              f"clamped case: the sequential recurrence is only "
              f"{seq_gap[str(dtype)]} away, the clamps do not bite")
    # the tc route refuses a view its TMA maps cannot take
    args = _wkv_inputs(gen, 1, 64, 2, 64, bf16, f32)
    flat = torch.empty(args[0].numel() + 1, dtype=bf16, device=dev)
    odd = flat[1:].view(args[0].shape)
    try:
        ops.wkv(odd, *args[1:], chunk=32)
        check(False, "wkv/tc took a base pointer 2 bytes off alignment")
    except ValueError:
        cases.append("wkv/misaligned_bfloat16_tc_raises")

    res = {"wkv_max_abs_err_by_case": worst,
           "wkv_clamped_vs_sequential": seq_gap}
    timed = {"wkv_tc": ("prefill", (1, RWKV_PREFILL, h, e, 32), bf16, f32),
             "wkv_step": ("decode", (SERVE_BATCH, 1, h, e, 32), bf16, f32),
             "wkv": ("prefill", (1, RWKV_PREFILL, h, e, 32), f32, f32)}
    for row, (case, (b, s_, hh, ee, chunk), dtype, lw_dtype) in timed.items():
        args = _wkv_inputs(gen, b, s_, hh, ee, dtype, lw_dtype)
        route = ops.wkv_route(dtype, ee, s_)
        item = torch.tensor([], dtype=dtype).element_size()
        res[row] = {
            "shape": f"{RWKV} {case}: ({b}, {s_}, {hh}, {ee}) "
                     f"{str(dtype).removeprefix('torch.')} r/k/v, "
                     f"{str(lw_dtype).removeprefix('torch.')} lw, chunk "
                     f"{chunk}; route {route}",
            "kernel_ms": timer.ms(lambda: ops.wkv(*args, chunk=chunk)),
            "plain_ms": timer.ms(
                lambda: ref.wkv_chunked_ref(*args, chunk=chunk), 10),
            "library_ms": None,        # no single PyTorch call computes WKV
            "host_ms_per_call": host_ms(lambda: ops.wkv(*args, chunk=chunk)),
            **_wkv_bound(route, b, s_, hh, ee, chunk, item, 4)}
        if route != "scalar":
            # the scalar kernel at the same shape, in the same call
            res[row]["scalar_kernel_ms"] = timer.ms(
                lambda: _scalar_wkv(args, chunk))
    return res


def phase_parity() -> None:
    """Reduced parallax-lm at f32 on the CPU and on the card, the default
    RunConfig and local_agg=False (the no-LA ablation: the raw token stream
    is pushed through the plain accumulating scatter on both devices)."""
    cfg = reduced(get_config("parallax-lm"))
    shape = ShapeConfig("parity", 16, 4, "train")
    ds = SyntheticLM(cfg.vocab_size, shape.seq_len, shape.global_batch)
    out = {}
    for name, la in (("local_agg", True), ("no_local_agg", False)):
        rc = RunConfig(param_dtype="float32", compute_dtype="float32",
                       local_agg=la)
        cpu = get_runner(cfg, shape, rc, seed=0, device="cpu")
        params = {k: p.detach().clone()
                  for k, p in named_parameters(cpu.model).items()}
        gpu = get_runner(cfg, shape, rc, device="cuda",
                         params={k: p.to("cuda") for k, p in params.items()})
        rows = []
        ops.reset_launch_counts()
        for i in range(3):
            b = ds.batch(i)
            mc, mg = cpu.run(b), gpu.run(b)
            lc, lg = float(mc["loss"]), float(mg["loss"])
            check(math.isclose(lc, lg, rel_tol=1e-4),
                  f"{name} step {i}: cpu loss {lc} vs card {lg}")
            for k in ("embed_rows", "embed_unique", "embed_dropped"):
                check(float(mc[k]) == float(mg[k]),
                      f"{name} step {i}: {k} cpu {float(mc[k])} vs card "
                      f"{float(mg[k])}")
            rows.append({"cpu": lc, "cuda": lg, "rel": abs(lc - lg) / abs(lc),
                         "embed_unique": float(mg["embed_unique"])})
        counts = ops.launch_counts()
        want = 3 if la else 0      # no-LA pushes through the plain scatter
        check(counts["embed_scatter_add"] == want
              and counts["embed_gather"] == 3,
              f"{name}: launches {counts}")
        out[name] = rows
    emit({"phase": "parity", **out})


def _prompts(rng, lens, vocab: int) -> list:
    return [rng.integers(0, vocab, size=int(n)).astype(np.int32)
            for n in lens]


def _serve_prompts(rng, vocab: int, n: int = 8) -> tuple:
    """The serve phase's traffic: ``n`` prompts of 200..1800 tokens."""
    lens = rng.integers(200, 1801, size=n)
    return lens, _prompts(rng, lens, vocab)


def _drain(sv, prompts, new: int) -> dict:
    """Submit ``prompts`` to a Server or ToyServer and serve them all."""
    for i, p in enumerate(prompts):
        sv.submit(Request(i, p, max_new_tokens=new))
    done = sv.run_until_drained()
    return {r.uid: r for r in done}


def phase_serve_parity() -> None:
    """Reduced phi3-medium-14b at f32 on the CPU and on the card, the same
    parameters and prompts, attention through flash_attention."""
    cfg = reduced(get_config("phi3-medium-14b"))
    rc = RunConfig(attention_impl="pallas", param_dtype="float32",
                   compute_dtype="float32")
    scfg = ServerConfig(max_batch=2, max_seq=64)
    cpu = Server(cfg, rc, scfg, seed=0, device="cpu")
    gpu = Server(cfg, rc, scfg, device="cuda",
                 params={k: p.to("cuda") for k, p in cpu.params.items()})
    prompts = _prompts(np.random.default_rng(0), (5, 23, 40, 11),
                       cfg.vocab_size)
    logit_diff = logit_max = 0.0
    for p in prompts:
        lb = bucket_len(len(p), scfg.max_seq)
        toks = np.zeros((1, lb), np.int32)
        toks[0, :len(p)] = p
        lc, _ = cpu.model.prefill_cache_fn(torch.from_numpy(toks))
        lg, _ = gpu.model.prefill_cache_fn(torch.from_numpy(toks).cuda())
        lg = lg.cpu()
        check(torch.allclose(lg, lc, rtol=1e-4, atol=1e-5),
              f"prefill logits (prompt {len(p)}): max abs diff "
              f"{float((lg - lc).abs().max())}")
        logit_diff = max(logit_diff, float((lg - lc).abs().max()))
        logit_max = max(logit_max, float(lc.abs().max()))
    ops.reset_launch_counts()
    got = _drain(gpu, prompts, 8)
    flash = ops.launch_counts()["flash_attention"]
    want = _drain(cpu, prompts, 8)
    cpu.close()
    gpu.close()
    check(flash == cfg.n_layers * gpu.stats["prefill_calls"],
          f"flash_attention launched {flash} times in "
          f"{gpu.stats['prefill_calls']} prefills")
    diffs = [(u, i, a, b) for u in want
             for i, (a, b) in enumerate(zip(got[u].out_tokens,
                                            want[u].out_tokens)) if a != b]
    check(all(len(got[u].out_tokens) == len(want[u].out_tokens) == 8
              for u in want), "a request did not complete on both devices")
    check(len(diffs) <= 2, f"greedy tokens differ at {diffs}")
    emit({"phase": "serve_parity", "prompts": [len(p) for p in prompts],
          "max_abs_logit_diff": logit_diff, "max_abs_logit": logit_max,
          "token_diffs": diffs,
          "tokens": {u: r.out_tokens for u, r in got.items()},
          "flash_launches": flash})


def _draw_rwkv_params(params: dict, seed: int = 0) -> None:
    """Draw the parameters that rwkv6's seeded init leaves constant
    (RWKV_DRAWN), in place, from a CPU generator, so the same values land
    on every device."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in params.items():
            for suffix, (scale, offset) in RWKV_DRAWN.items():
                if name.endswith(suffix):
                    x = torch.randn(p.shape, generator=gen) * scale + offset
                    p.copy_(x.to(p.dtype))


def _scaled_close(got, want, tol: float, what: str, rtol: float = 0.0
                  ) -> float:
    """|got - want| <= tol * max|want| + rtol * |want| elementwise; returns
    the max abs difference."""
    got, want = got.float().cpu(), want.float().cpu()
    diff = (got - want).abs()
    scale = float(want.abs().max()) or 1.0
    check(bool(torch.isfinite(got).all()), f"{what}: non-finite values")
    check(bool((diff <= tol * scale + rtol * want.abs()).all()),
          f"{what}: max abs diff {float(diff.max())} at scale {scale}")
    return float(diff.max())


def phase_rwkv_parity() -> None:
    """Reduced rwkv6-7b at f32 on the CPU and on the card, the same
    parameters: the prefill step's logits and final carry, then ToyServer's
    greedy tokens."""
    cfg = reduced(get_config(RWKV))
    rc = RunConfig(param_dtype="float32", compute_dtype="float32")
    scfg = ServerConfig(max_batch=2, max_seq=64)
    cpu = ToyServer(cfg, rc, scfg, seed=0, device="cpu")
    _draw_rwkv_params(cpu.params)
    gpu = ToyServer(cfg, rc, scfg, device="cuda",
                    params={k: p.to("cuda") for k, p in cpu.params.items()})
    prompts = _prompts(np.random.default_rng(0), (5, 23, 40, 11),
                       cfg.vocab_size)
    diffs = {}
    for n in (1, 40, 70):
        toks = torch.from_numpy(np.random.default_rng(n).integers(
            0, cfg.vocab_size, (2, n)).astype(np.int32))
        lc, cc = make_prefill_step(cpu.model, cpu.rt, cpu.plan)(
            {"tokens": toks})
        lg, cg = make_prefill_step(gpu.model, gpu.rt, gpu.plan)(
            {"tokens": toks.cuda()})
        diffs[n] = [_scaled_close(g, c, 1e-4, f"prefill {what} ({n})",
                                  rtol=1e-4)
                    for what, g, c in zip(("logits", "tm_x", "state", "cm_x"),
                                          (lg, *cg), (lc, *cc))]
    ops.reset_launch_counts()
    got = _drain(gpu, prompts, 8)
    wkv_launches = ops.launch_counts()["wkv"]
    want = _drain(cpu, prompts, 8)
    steps = gpu.stats["decode_steps"] + sum(len(p) - 1 for p in prompts)
    check(wkv_launches == cfg.n_layers * steps,
          f"wkv launched {wkv_launches} times in {steps} device steps")
    token_diffs = [(u, i, a, b) for u in want
                   for i, (a, b) in enumerate(zip(got[u].out_tokens,
                                                  want[u].out_tokens))
                   if a != b]
    check(all(len(got[u].out_tokens) == len(want[u].out_tokens) == 8
              for u in want), "a request did not complete on both devices")
    check(len(token_diffs) <= 2, f"greedy tokens differ at {token_diffs}")
    emit({"phase": "rwkv_parity", "prefill_max_abs_diffs": diffs,
          "prompts": [len(p) for p in prompts], "token_diffs": token_diffs,
          "tokens": {u: r.out_tokens for u, r in got.items()},
          "wkv_launches": wkv_launches, "device_steps": steps})


def phase_rwkv_recurrence(dev, n_tokens: int = 300) -> None:
    """rwkv6-7b at full width (d 4,096, 64 heads of 64), n_layers cut to 2
    so it runs in f32: the chunked prefill over one prompt and one-token
    decode steps over the same prompt compute one recurrence."""
    cfg = replace(get_config(RWKV), n_layers=2)
    rc = RunConfig(param_dtype="float32", compute_dtype="float32")
    rt = Runtime(cfg, rc, ShapeConfig("recurrence", n_tokens, 1, "decode"),
                 device=dev)
    model = build_model(cfg, rt)
    rt.plan = analyze(model, rt)
    init_params_(model, 0)
    model.requires_grad_(False)
    _draw_rwkv_params(named_parameters(model))
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (1, n_tokens)).astype(np.int32)).to(dev)
    ops.reset_launch_counts()
    logits, carry = make_prefill_step(model, rt, rt.plan)({"tokens": toks})
    check(ops.launch_counts()["wkv"] == cfg.n_layers,
          f"prefill launched wkv {ops.launch_counts()['wkv']} times")
    cache = model.init_cache(1, n_tokens)
    step = make_decode_step(model, rt, rt.plan)
    for t in range(n_tokens):
        last, cache = step(cache, toks[:, t:t + 1], t)
    torch.cuda.synchronize()
    diffs = {"last_logits": _scaled_close(last[:, 0], logits[:, -1], 1e-4,
                                          "last logits")}
    for name, a, b in zip(("tm_x", "state", "cm_x"), carry, cache):
        for i in range(cfg.n_layers):
            diffs[f"{name}_{i}"] = _scaled_close(b[i], a[i], 1e-4,
                                                 f"layer {i} {name}")
    emit({"phase": "rwkv_recurrence", "tokens": n_tokens,
          "layers": cfg.n_layers, "d_model": cfg.d_model,
          "max_abs_diffs": diffs,
          "logit_scale": float(logits[:, -1].abs().max())})


def phase_serve(dev, n_requests: int = 8, new: int = 16) -> dict:
    """Full-width phi3-medium-14b served on the card."""
    cfg = get_config("phi3-medium-14b")
    scfg = ServerConfig(max_batch=SERVE_BATCH, max_seq=SERVE_MAX_SEQ)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    sv = Server(cfg, RunConfig(attention_impl="pallas"), scfg, seed=0)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated(dev)
    check(sv.rt.device.type == "cuda", f"served on {sv.rt.device}")
    rng = np.random.default_rng(0)
    lens, prompts = _serve_prompts(rng, cfg.vocab_size, n_requests)
    # the first call of each GEMM shape pays cuBLAS's heuristics: one short
    # request first, outside the counted run
    _drain(sv, _prompts(rng, (100,), cfg.vocab_size), 2)
    before = {k: sv.stats[k] for k in ("prefill_calls", "decode_steps")}
    sv.completed.clear()
    torch.cuda.reset_peak_memory_stats(dev)

    ops.reset_launch_counts()
    t = time.perf_counter()
    done = _drain(sv, prompts, new)
    wall = time.perf_counter() - t
    counts = ops.launch_counts()
    flash_tc = ops.flash_attention.launches_tc

    prefills = sv.stats["prefill_calls"] - before["prefill_calls"]
    steps = sv.stats["decode_steps"] - before["decode_steps"]
    serve_peak = torch.cuda.max_memory_allocated(dev)
    check(len(done) == n_requests, f"{len(done)} of {n_requests} completed")
    check(all(len(r.out_tokens) == new for r in done.values()),
          f"token counts {[len(r.out_tokens) for r in done.values()]}")
    check(sv.stats["cross_slot_mismatches"] == 0,
          f"{sv.stats['cross_slot_mismatches']} cross-slot mismatches")
    check(counts["flash_attention"] == cfg.n_layers * prefills,
          f"flash_attention launched {counts['flash_attention']} times in "
          f"{prefills} prefills")
    check(flash_tc == counts["flash_attention"],
          f"{counts['flash_attention'] - flash_tc} of "
          f"{counts['flash_attention']} prefill launches of flash_attention "
          "missed the tensor-core route")
    check(counts["embed_gather"] == prefills + steps,
          f"embed_gather launched {counts['embed_gather']} times in "
          f"{prefills} prefills + {steps} decode steps")
    check(counts["embed_gather_bulk"] == counts["embed_gather"],
          f"{counts['embed_gather'] - counts['embed_gather_bulk']} of "
          f"{counts['embed_gather']} gathers missed the bulk route")
    ttft = sorted(r.ttft for r in done.values())
    # decode over the counted window: every token after a request's first
    # comes from a decode step, with later requests' prefills interleaved
    tokens = sum(len(r.out_tokens) for r in done.values())
    window_s = (max(r.token_times[-1] for r in done.values())
                - min(r.t_first for r in done.values()))
    gaps = sorted(b - a for r in done.values()
                  for a, b in zip(r.token_times, r.token_times[1:]))

    # device times of one prefill per bucket and of one synthetic decode
    # step over the full batch at lens 1024, on the engine's own steps
    # (after the counted run)
    timer = Timer(dev)
    prefill_ms = {}
    for lb in sorted(sv.stats["buckets"]):
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, lb))
                                .astype(np.int32)).to(dev)
        prefill_ms[lb] = timer.ms(lambda: sv._prefill(
            sv.cache, sv.lens, sv.tok, toks, lb, 0, sv._gen), 3)
    active = torch.ones(scfg.max_batch, dtype=torch.bool, device=dev)
    sv.lens.fill_(1024)
    decode_ms = timer.ms(lambda: sv._decode(sv.cache, sv.lens, sv.tok,
                                             active, sv._gen), 10)
    sv.close()
    res = {"phase": "serve", "arch": cfg.name, "requests": n_requests,
           "prompt_lens": [int(x) for x in lens],
           "buckets": sorted(sv.stats["buckets"]),
           "prefill_calls": prefills, "decode_steps": steps,
           "launches": counts, "flash_attention_launches_tc": flash_tc,
           "ttft_ms_p50": ttft[len(ttft) // 2] * 1e3,
           "ttft_ms_max": ttft[-1] * 1e3,
           "prefill_ms_by_bucket": prefill_ms,
           "decode_step_ms_median": decode_ms,
           "decode_step_tokens_per_s": scfg.max_batch / (decode_ms / 1e3),
           "window_decode_tokens": tokens - n_requests,
           "window_decode_s": window_s,
           "window_decode_tokens_per_s": (tokens - n_requests) / window_s,
           "itl_ms_p50": gaps[len(gaps) // 2] * 1e3,
           "itl_ms_max": gaps[-1] * 1e3,
           "run_s": wall, "run_tokens_per_s": tokens / wall,
           "setup_s": setup_s, "init_peak_bytes": init_peak,
           "max_memory_allocated": serve_peak,
           "first_tokens": {u: r.out_tokens[:4] for u, r in done.items()},
           "nvidia_smi": nvidia_smi(
               "clocks.sm,power.draw,power.limit,temperature.gpu")}
    emit(res)
    return res


def phase_rwkv_serve(dev, n_requests: int = 8, new: int = 16) -> dict:
    """Full-width rwkv6-7b served on the card through ToyServer."""
    cfg = get_config(RWKV)
    scfg = ServerConfig(max_batch=SERVE_BATCH, max_seq=SERVE_MAX_SEQ)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    sv = ToyServer(cfg, RunConfig(), scfg, seed=0)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated(dev)
    check(sv.rt.device.type == "cuda", f"served on {sv.rt.device}")
    rng = np.random.default_rng(0)
    lens = rng.integers(16, 65, size=n_requests)
    prompts = _prompts(rng, lens, cfg.vocab_size)
    # the first call of each GEMM shape pays cuBLAS's heuristics: one short
    # request first, outside the counted run
    _drain(sv, _prompts(rng, (4,), cfg.vocab_size), 2)
    before = sv.stats["decode_steps"]
    sv.completed.clear()
    torch.cuda.reset_peak_memory_stats(dev)

    ops.reset_launch_counts()
    t = time.perf_counter()
    done = _drain(sv, prompts, new)
    wall = time.perf_counter() - t
    counts = ops.launch_counts()

    steps = sv.stats["decode_steps"] - before
    device_steps = steps + sum(len(p) - 1 for p in prompts)
    serve_peak = torch.cuda.max_memory_allocated(dev)
    check(len(done) == n_requests, f"{len(done)} of {n_requests} completed")
    check(all(len(r.out_tokens) == new for r in done.values()),
          f"token counts {[len(r.out_tokens) for r in done.values()]}")
    check(counts["wkv"] == cfg.n_layers * device_steps,
          f"wkv launched {counts['wkv']} times in {device_steps} device "
          "steps")
    check(counts["wkv_step"] == counts["wkv"],
          f"{counts['wkv'] - counts['wkv_step']} of {counts['wkv']} wkv "
          "launches of the serve loop missed the step route")
    check(counts["embed_gather"] == device_steps,
          f"embed_gather launched {counts['embed_gather']} times in "
          f"{device_steps} device steps")
    check(counts["embed_gather_bulk"] == counts["embed_gather"],
          f"{counts['embed_gather'] - counts['embed_gather_bulk']} of "
          f"{counts['embed_gather']} gathers missed the bulk route")
    ttft = sorted(r.ttft for r in done.values())
    tokens = sum(len(r.out_tokens) for r in done.values())
    window_s = (max(r.token_times[-1] for r in done.values())
                - min(r.t_first for r in done.values()))
    gaps = sorted(b - a for r in done.values()
                  for a, b in zip(r.token_times, r.token_times[1:]))

    # device times of one decode step over the 4 slots and of one
    # 2,048-token prefill (after the counted run)
    timer = Timer(dev)
    step_toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (
        SERVE_BATCH, 1)).astype(np.int32)).to(dev)
    decode_ms = timer.ms(lambda: sv.decode_step(sv.cache, step_toks, 0), 10)
    prefill = make_prefill_step(sv.model, sv.rt, sv.plan)
    ptoks = torch.from_numpy(_rwkv_prompt(cfg.vocab_size)).to(dev)
    ops.reset_launch_counts()
    logits, carry = prefill({"tokens": ptoks})
    torch.cuda.synchronize()
    prefill_counts = ops.launch_counts()
    check(prefill_counts["wkv"] == cfg.n_layers
          and prefill_counts["wkv_tc"] == cfg.n_layers,
          f"a {RWKV_PREFILL}-token prefill launched wkv "
          f"{prefill_counts['wkv']} times, {prefill_counts['wkv_tc']} on "
          "the tensor-core route")
    check(prefill_counts["embed_gather"] == 1
          and prefill_counts["embed_gather_bulk"] == 1,
          f"a {RWKV_PREFILL}-token prefill gathered "
          f"{prefill_counts['embed_gather']} times, "
          f"{prefill_counts['embed_gather_bulk']} on the bulk route")
    check(tuple(logits.shape) == (1, RWKV_PREFILL, cfg.vocab_size)
          and bool(torch.isfinite(logits).all())
          and all(bool(torch.isfinite(c).all()) for c in carry),
          "prefill logits or carry not finite, or of the wrong shape")
    del logits, carry
    prefill_ms = timer.ms(lambda: prefill({"tokens": ptoks}), 3)
    res = {"phase": "rwkv_serve", "arch": cfg.name, "requests": n_requests,
           "prompt_lens": [int(x) for x in lens],
           "decode_steps": steps, "device_steps": device_steps,
           # the path's launches: the serve loop's and the prefill's
           "launches": {k: counts[k] + prefill_counts[k] for k in counts},
           "serve_loop_launches": counts,
           "ttft_ms_p50": ttft[len(ttft) // 2] * 1e3,
           "ttft_ms_max": ttft[-1] * 1e3,
           "window_decode_tokens": tokens - n_requests,
           "window_decode_s": window_s,
           "window_decode_tokens_per_s": (tokens - n_requests) / window_s,
           "itl_ms_p50": gaps[len(gaps) // 2] * 1e3,
           "itl_ms_max": gaps[-1] * 1e3,
           "run_s": wall, "run_tokens_per_s": tokens / wall,
           "decode_step_ms_median": decode_ms,
           "decode_step_tokens_per_s": scfg.max_batch / (decode_ms / 1e3),
           "prefill_tokens": RWKV_PREFILL, "prefill_ms_median": prefill_ms,
           "prefill_launches": prefill_counts,
           "setup_s": setup_s, "init_peak_bytes": init_peak,
           "max_memory_allocated": serve_peak,
           "first_tokens": {u: r.out_tokens[:4] for u, r in done.items()},
           "nvidia_smi": nvidia_smi(
               "clocks.sm,power.draw,power.limit,temperature.gpu")}
    emit(res)
    return res


def _train(dev, rc: RunConfig, steps: int) -> dict:
    """``steps`` full-width parallax-lm steps on the card under ``rc``, the
    launch counts set to 0 just before them and read just after."""
    cfg = get_config("parallax-lm")
    shape = ShapeConfig("lm1b", seq_len=SEQ, global_batch=BATCH, kind="train")
    t0 = time.perf_counter()
    runner = get_runner(cfg, shape, rc, device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    ds = SyntheticLM(cfg.vocab_size, SEQ, BATCH)
    batches = [ds.batch(i) for i in range(steps)]
    torch.cuda.reset_peak_memory_stats(dev)
    losses, step_ms = [], []
    ops.reset_launch_counts()
    for b in batches:
        t = time.perf_counter()
        m = runner.run(b)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        losses.append(float(m["loss"]))
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    check(all(math.isfinite(x) for x in losses), f"non-finite loss {losses}")
    med = statistics.median(step_ms)
    return {"arch": cfg.name, "tokens_per_step": shape.tokens,
            "losses": losses, "step_ms": step_ms, "median_step_ms": med,
            "tokens_per_s": shape.tokens / (med / 1e3),
            "max_memory_allocated": peak, "launches": counts,
            "setup_s": build_s,
            "nvidia_smi": nvidia_smi(
                "clocks.sm,power.draw,power.limit,temperature.gpu")}


def phase_main(dev, steps: int = 10) -> dict:
    res = {"phase": "main", **_train(dev, RunConfig(), steps)}
    losses, counts = res["losses"], res["launches"]
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    for k in PATH_KERNELS["main"]:
        check(counts[k] == steps,
              f"{k} launched {counts[k]} times in {steps} steps")
    check(counts["embed_gather_bulk"] == steps
          and counts["embed_scatter_add_fused"] == steps,
          f"main: {counts['embed_gather_bulk']} of {steps} gathers on the "
          f"bulk route, {counts['embed_scatter_add_fused']} of {steps} "
          "scatters on the one-pass kernel")
    emit(res)
    return res


def phase_main_no_la(dev, steps: int = 3) -> dict:
    """The no-LA ablation at full width: RunConfig(local_agg=False) pushes
    the raw 2,560-token stream, whose ids repeat, through the plain
    accumulating scatter (no kernel launch); the pull still gathers on the
    bulk route."""
    res = {"phase": "main_no_la",
           **_train(dev, RunConfig(local_agg=False), steps)}
    counts = res["launches"]
    check(counts["embed_scatter_add"] == 0,
          f"no-LA launched embed_scatter_add {counts['embed_scatter_add']} "
          "times: repeated ids must take the plain scatter")
    check(counts["embed_gather"] == steps
          and counts["embed_gather_bulk"] == steps,
          f"no-LA gathers: {counts['embed_gather']} launches, "
          f"{counts['embed_gather_bulk']} on the bulk route, in {steps} "
          "steps")
    emit(res)
    return res


# ---------------------------------------------------------------------------
# the mesh phases: ranks are spawned processes (launch/mesh.py::spawn)
# ---------------------------------------------------------------------------

def _main_batches(steps: int) -> list:
    """The main phase's batches (SyntheticLM, seed 0)."""
    ds = SyntheticLM(get_config("parallax-lm").vocab_size, SEQ, BATCH)
    return [ds.batch(i) for i in range(steps)]


def _timed_steps(runner, batches, dev) -> dict:
    """Run ``batches`` through ``runner`` with every launch count set to 0
    just before and read just after: losses, step ms, launches, peak."""
    torch.cuda.reset_peak_memory_stats(dev)
    losses, step_ms, census = [], [], []
    ops.reset_launch_counts()
    for b in batches:
        t = time.perf_counter()
        m = runner.run(b)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        losses.append(float(m["loss"]))
        census.append({k: float(m[k]) for k in CENSUS})
    return {"losses": losses, "step_ms": step_ms, "census": census,
            "median_step_ms": statistics.median(step_ms),
            "launches": ops.launch_counts(),
            "max_memory_allocated": torch.cuda.max_memory_allocated(dev)}


def _one_rank(rank: int, world: int, steps: int) -> dict:
    """Full-width parallax-lm, default RunConfig, on a (1, 1) mesh over a
    one-rank NCCL group: the same seed and batches as main."""
    mesh = make_mesh((1, 1), ("data", "model"), device="cuda")
    cfg = get_config("parallax-lm")
    shape = ShapeConfig("lm1b", seq_len=SEQ, global_batch=BATCH,
                        kind="train")
    runner = get_runner(cfg, shape, RunConfig(), mesh=mesh)
    out = _timed_steps(runner, _main_batches(steps), mesh.device)
    out["plan"] = runner.plan.tables()
    out["methods"] = runner.plan.methods()
    out["bucketed"] = runner.plan.bucket_plan is not None
    return out


def phase_mesh_one_rank(main_losses: list, steps: int = 3) -> dict:
    """The mesh path through a one-rank NCCL group must reproduce main's
    first ``steps`` losses bit for bit: every collective over a group of
    one is the identity, and the plan (mpi_gatherv, as the reference
    plans a 1 x 1 mesh) pushes through the plain scatter, which gives the
    one-pass kernel's bits for the unique ids of a dedupe buffer."""
    (res,) = spawn(_one_rank, 1, "nccl", "cuda", args=(steps,),
                   timeout=600)
    check(res["plan"]["embed"]["method"] == "mpi_gatherv",
          f"mesh_one_rank plan {res['plan']}")
    check(res["losses"] == main_losses[:steps],
          f"mesh_one_rank losses {res['losses']} vs main "
          f"{main_losses[:steps]}")
    counts = res["launches"]
    check(counts["embed_gather"] == steps
          and counts["embed_gather_bulk"] == steps
          and counts["embed_scatter_add"] == 0,
          f"mesh_one_rank launches {counts}")
    res = {"phase": "mesh_one_rank", "backend": "nccl", "world": 1,
           "mesh": [1, 1], "main_losses": main_losses[:steps], **res}
    emit(res)
    return res


MESH_FLAGS = {"hybrid": {}, "ps": {"comm_mode": "ps"},
              "mpi": {"comm_mode": "mpi"}, "no_la": {"local_agg": False},
              "no_opau": {"opau": False}, "no_opsw": {"opsw": False}}
MESH_F32 = dict(param_dtype="float32", compute_dtype="float32",
                wire_dtype="float32")


def _reduced():
    return (reduced(get_config("parallax-lm")),
            ShapeConfig("mesh", 32, 4, "train"))


def _reduced_batches() -> list:
    cfg, shape = _reduced()
    ds = SyntheticLM(cfg.vocab_size, shape.seq_len, shape.global_batch)
    return [ds.batch(i) for i in range(3)]


def _card_rank(rank: int, world: int, named: dict, steps: int) -> dict:
    """One of four ranks on the one card over gloo: (a) reduced
    parallax-lm at f32 on a (2, 2) mesh under the six flag sets; (b)
    full-width parallax-lm, bf16, comm_mode ps on a (1, 4) mesh."""
    dev = torch.device("cuda", 0)
    mesh = make_mesh((2, 2), ("data", "model"), device=dev)
    cfg, shape = _reduced()
    out = {"reduced": {}}
    total = None
    for name, flags in MESH_FLAGS.items():
        runner = get_runner(cfg, shape, RunConfig(**MESH_F32, **flags),
                            mesh=mesh,
                            params=load_reference_params(named, dev))
        r = _timed_steps(runner, _reduced_batches(), dev)
        out["reduced"][name] = {
            "losses": r["losses"], "launches": r["launches"],
            "census": r["census"],
            "method": runner.plan.table_methods["embed"],
            "bucketed": runner.plan.bucket_plan is not None,
            "replicas": runner.rt.replicas}
        total = r["launches"] if total is None else {
            k: total[k] + v for k, v in r["launches"].items()}
    del runner
    torch.cuda.empty_cache()
    # (b): a new mesh over the same four ranks
    mesh = make_mesh((1, 4), ("data", "model"), device=dev)
    full = get_config("parallax-lm")
    lm1b = ShapeConfig("lm1b", seq_len=SEQ, global_batch=BATCH, kind="train")
    runner = get_runner(full, lm1b, RunConfig(comm_mode="ps"), mesh=mesh)
    r = _timed_steps(runner, _main_batches(steps), dev)
    out["full_ps"] = {**r, "plan": runner.plan.tables(),
                      "table_shard": list(runner.model.embed.shape),
                      "model_index": mesh.coords["model"]}
    out["launches"] = {k: total[k] + v for k, v in r["launches"].items()}
    return out


def _census(tokens: np.ndarray, method: str, bucketed: bool, n: int,
            local_agg: bool, vocab: int) -> dict:
    """The census the plan's exchange implies for one global batch: each
    replica's unique ids averaged over the replicas (a table on the dense
    exchange outside buckets: the global batch's)."""
    blocks = ([tokens] if method == "allreduce" and not bucketed
              else np.split(tokens, n))
    uniq = [np.unique(b).size if local_agg else b.size for b in blocks]
    t = blocks[0].size
    return {"embed_unique": float(np.mean(uniq)),
            "embed_rows": float(min(t, vocab) if local_agg else t),
            "embed_dropped": 0.0}


def phase_mesh_card(main_losses: list, steps: int = 3) -> dict:
    """Four ranks on the one card over gloo (NCCL takes one card per
    rank): (a) the reduced six flag sets on (2, 2) against the one-device
    card run on the same batches (the reference test's bar, 5e-4 + 1e-4 i)
    with the census the plan implies; (b) full-width ps on (1, 4): each
    rank pulls at row_offset m * 200,000 through the bulk gather and
    pushes through the one-pass scatter, 3 each, losses within rel 1e-2
    of main's. Gloo moves CUDA tensors through the host: its times are not
    a multi-GPU exchange time."""
    cfg, shape = _reduced()
    one = get_runner(cfg, shape, RunConfig(**MESH_F32), device="cuda")
    named = {k: p.detach().cpu().numpy()
             for k, p in named_parameters(one.model).items()}
    batches = _reduced_batches()
    single = []
    for b in batches:
        single.append(float(one.run(b)["loss"]))
    del one
    ranks = spawn(_card_rank, 4, "gloo", "cuda", args=(named, steps),
                  timeout=900)
    reduced_rows = {}
    for name, flags in MESH_FLAGS.items():
        rs = [r["reduced"][name] for r in ranks]
        got = rs[0]["losses"]
        check(all(r["losses"] == got for r in rs),
              f"mesh_card {name}: ranks disagree {[r['losses'] for r in rs]}")
        for i, (a, b) in enumerate(zip(got, single)):
            check(abs(a - b) < 5e-4 + 1e-4 * i,
                  f"mesh_card {name} step {i}: {got} vs one device {single}")
        reduced_rows[name] = {"losses": got, "method": rs[0]["method"],
                              "bucketed": rs[0]["bucketed"],
                              "max_abs_diff": max(abs(a - b) for a, b in
                                                  zip(got, single))}
        r0 = rs[0]
        want = [_census(b["tokens"], r0["method"], r0["bucketed"],
                        r0["replicas"], flags.get("local_agg", True),
                        cfg.vocab_size) for b in batches]
        check(all(r["census"] == want for r in rs),
              f"mesh_card {name}: census {[r['census'] for r in rs]} vs "
              f"{want}")
    full = [r["full_ps"] for r in ranks]
    for m, r in enumerate(sorted(full, key=lambda r: r["model_index"])):
        c = r["launches"]
        check(r["plan"]["embed"]["method"] == "ps"
              and r["table_shard"] == [VOCAB // 4, E],
              f"mesh_card full: plan {r['plan']}, shard {r['table_shard']}")
        check(c["embed_gather_bulk"] == steps
              and c["embed_scatter_add_fused"] == steps,
              f"mesh_card full, model shard {m}: launches {c}")
        check(all(math.isfinite(x) for x in r["losses"]),
              f"mesh_card full: losses {r['losses']}")
        for a, b in zip(r["losses"], main_losses):
            check(abs(a - b) <= 1e-2 * abs(b),
                  f"mesh_card full: losses {r['losses']} vs main "
                  f"{main_losses[:steps]}")
    res = {"phase": "mesh_card", "backend": "gloo", "world": 4,
           "note": "4 ranks on one card over gloo, not a multi-GPU "
                   "exchange time",
           "reduced": {"mesh": [2, 2], "one_device": single,
                       "flag_sets": reduced_rows},
           "full_ps": {"mesh": [1, 4], "main_losses": main_losses[:steps],
                       "ranks": [{k: r[k] for k in (
                           "model_index", "losses", "step_ms",
                           "median_step_ms", "max_memory_allocated")}
                           for r in full]},
           "launches": ranks[0]["launches"],
           "launches_by_rank": [r["launches"] for r in ranks]}
    emit(res)
    return res


def main() -> None:
    t0 = time.perf_counter()
    info = phase_banner()
    dev = torch.device("cuda", 0)
    phase_build()
    kern = phase_kernels(dev)
    torch.cuda.empty_cache()
    phase_parity()
    phase_serve_parity()
    phase_rwkv_parity()
    phase_rwkv_recurrence(dev)
    torch.cuda.empty_cache()
    main_res = phase_main(dev)
    paths = {"main": main_res["launches"]}
    torch.cuda.empty_cache()
    paths["main_no_la"] = phase_main_no_la(dev)["launches"]
    torch.cuda.empty_cache()
    paths["mesh_one_rank"] = phase_mesh_one_rank(
        main_res["losses"])["launches"]
    paths["mesh_card"] = phase_mesh_card(main_res["losses"])["launches"]
    torch.cuda.empty_cache()
    serve = phase_serve(dev)
    paths["serve"] = serve["launches"]
    torch.cuda.empty_cache()         # phi3's server is gone: free its blocks
    paths["rwkv_serve"] = phase_rwkv_serve(dev)["launches"]
    for path, names in PATH_KERNELS.items():
        for name in names:
            check(paths[path][name] > 0, f"{name} not launched on {path}")
    emit({"phase": "done", "seconds": time.perf_counter() - t0})
    print(info["nvidia_smi"], flush=True)
    rows = []
    for name, meta in KERNELS.items():
        k = kern[name]
        if name == "wkv":           # the scalar route: no path takes it
            by_path = {p: c["wkv"] - c["wkv_tc"] - c["wkv_step"]
                       for p, c in paths.items()}
        else:
            by_path = {p: c[name] for p, c in paths.items()
                       if name in PATH_KERNELS[p]}
        rows.append({"name": name, **meta,
                     "launches": sum(by_path.values()),
                     "launches_by_path": by_path,
                     "max_abs_err": kern["max_abs_err"][name],
                     "ms": k["kernel_ms"], "plain_ms": k["plain_ms"],
                     "bound_ms": k["bound_ms"],
                     "bound_by": k.get("bound_by", "bytes"),
                     "library_ms": k["library_ms"],
                     "timed_at": k["shape"]})
        if name == "embed_gather":
            rows[-1]["launches_bulk"] = {
                p: c["embed_gather_bulk"] for p, c in paths.items()
                if name in PATH_KERNELS[p]}
            rows[-1].update({key: k[key] for key in ("element_ms",
                                                     "floor_ms")})
            rows[-1]["serve_shapes"] = kern["embed_gather_serve"]
            rows[-1]["rwkv_shapes"] = kern["embed_gather_rwkv"]
        if name == "embed_scatter_add":
            rows[-1]["launches_fused"] = {
                p: c["embed_scatter_add_fused"] for p, c in paths.items()
                if name in PATH_KERNELS[p]}
            rows[-1].update({key: k[key] for key in (
                "dump_row_ms", "dump_row_kernel_ms", "fill_ms",
                "all_owned_ms", "none_owned_ms", "floor_ms")})
        if name in ("wkv", "wkv_tc", "wkv_step"):
            rows[-1].update({key: k[key] for key in (
                "host_ms_per_call", "scalar_kernel_ms", "ops_bound_ms",
                "bytes_bound_ms") if key in k})
        if name == "flash_attention":
            rows[-1]["launches_tc"] = serve["flash_attention_launches_tc"]
            rows[-1]["by_len"] = {
                n: {key: r[key] for key in ("kernel_ms", "library_ms",
                                            "bound_ms", "tflops",
                                            "share_of_bound")}
                for n, r in k["by_len"].items()}
            rows[-1]["f32_ms"] = k["f32_ms"]
            rows[-1]["host_ms_per_call"] = k["host_ms_per_call"]
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
