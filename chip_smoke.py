#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises, so the script exits non-zero
and never prints the final line:

  1. banner   torch/CUDA versions, the card and its power limit; TF32 off.
  2. build    nvcc builds both kernels from src/repro_torch/kernels/csrc
              (one process per source, in parallel) into build/repro_torch/.
  3. kernels  each kernel against its plain version on the card, bit for bit
              (torch.equal), at the main path's shapes and at edge cases;
              kernel, plain and library-call times (CUDA events, median of
              50 runs, L2 flushed before each) beside the byte bound.
  4. parity   reduced parallax-lm at f32, the same parameters and batches,
              3 steps on the CPU and on the card: losses within rtol 1e-4
              (GEMM and index_add_ summation order differ on the card), the
              embed_* census metrics equal.
  5. main     full-width parallax-lm, ShapeConfig("lm1b", 20, 128) and the
              default RunConfig (bf16): get_runner(..., device="cuda"), 10
              steps of SyntheticLM batches. Every loss finite, the last below
              the first, each kernel launched exactly once per step.

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
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import compat  # noqa: E402
from repro_torch.configs import (RunConfig, ShapeConfig, get_config,  # noqa: E402
                                 reduced)
from repro_torch.core.embedding import dedupe  # noqa: E402
from repro_torch.core.transform import get_runner  # noqa: E402
from repro_torch.data import SyntheticLM  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.utils.roofline import HW  # noqa: E402
from repro_torch.utils.tree import named_parameters  # noqa: E402

VOCAB, E, SEQ, BATCH = 800_000, 512, 20, 128      # parallax-lm, lm1b cell
TIMED_RUNS, WARMUP = 50, 5
KERNELS = {
    "embed_gather": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/embed_gather.cu",
        "replaces": "src/repro/kernels/embed_gather.py:29",
    },
    "embed_scatter_add": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/embed_scatter.cu",
        "replaces": "src/repro/kernels/embed_scatter.py:36",
    },
}


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


def bound_ms(nbytes: int) -> float:
    return nbytes / HW.hbm_bw * 1e3


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
        check(torch.equal(got, want), f"{kernel}/{case}: not bitwise equal "
              f"to the plain version (max abs err {err})")
        errs[kernel] = max(errs[kernel], err)
        cases.append(f"{kernel}/{case}")

    for case, table, ids, off in (
            ("main_bf16", t16, uids, 0), ("main_f32", t32, uids, 0),
            ("row_offset_bf16", t16, off_ids, 400_000),
            ("row_offset_f32", t32, off_ids, 400_000),
            ("narrow_e100_bf16", small16, small_ids, 0),
            ("narrow_e100_f32", small32, small_ids, 0)):
        hold("embed_gather", case, ops.embed_gather(table, ids, off),
             ref.embed_gather_ref(table, ids, off))

    rows32 = torch.randn((n, E), generator=gen, device=dev)
    edge_ids = _unique_sorted(rng, n, -VOCAB // 4, VOCAB + VOCAB // 4, dev)
    small_rows32 = torch.randn((300, 100), generator=gen, device=dev)
    small_sc_ids = _unique_sorted(rng, 300, -100, 1100, dev)
    for case, ids, rows, vs in (
            ("main_bf16", uids, rows32.to(torch.bfloat16), VOCAB),
            ("main_f32", uids, rows32, VOCAB),
            ("unowned_bf16", edge_ids, rows32.to(torch.bfloat16), VOCAB),
            ("unowned_f32", edge_ids, rows32, VOCAB),
            ("narrow_e100_bf16", small_sc_ids,
             small_rows32.to(torch.bfloat16), 1000),
            ("narrow_e100_f32", small_sc_ids, small_rows32, 1000)):
        hold("embed_scatter_add", case, ops.embed_scatter_add(ids, rows, vs),
             ref.embed_scatter_add_ref(ids, rows, vs))
    del t32, rows32

    # ---- timing at the main path's shapes: bf16 table, bf16 wire rows ----
    timer = Timer(dev)
    owned = int(((uids >= 0) & (uids < VOCAB)).sum())
    clamped = uids.long().clamp(0, VOCAB - 1)
    g_bytes = (owned + n) * E * 2 + 4 * n
    gather = {
        "kernel_ms": timer.ms(lambda: ops.embed_gather(t16, uids, 0)),
        "plain_ms": timer.ms(lambda: ref.embed_gather_ref(t16, uids, 0)),
        # index_select reads a (clamped) row for every id and zeroes none:
        # the nearest single PyTorch call, timed only
        "library_ms": timer.ms(lambda: torch.index_select(t16, 0, clamped)),
        "bytes": g_bytes, "bound_ms": bound_ms(g_bytes),
    }
    rows16 = torch.randn((n, E), generator=gen, device=dev).to(torch.bfloat16)
    out = torch.zeros((VOCAB + 1, E), dtype=torch.float32, device=dev)
    dst = torch.where((uids >= 0) & (uids < VOCAB), uids.long(),
                      torch.full_like(uids, VOCAB, dtype=torch.long))
    rows16_f32 = rows16.float()
    s_bytes = n * E * 2 + 4 * n + owned * E * 4
    scatter = {
        # the kernel alone, into a zeroed (Vs + 1, E) buffer (its bound
        # excludes the wrapper's 1.64 GB zero fill)
        "kernel_ms": timer.ms(
            lambda: ops.scatter_into(uids, rows16, out, VOCAB)),
        # the wrapper as the main path calls it: zero fill + kernel
        "wrapper_ms": timer.ms(
            lambda: ops.embed_scatter_add(uids, rows16, VOCAB)),
        "plain_ms": timer.ms(
            lambda: ref.embed_scatter_add_ref(uids, rows16, VOCAB)),
        # index_copy_ into the same zeroed buffer, rows pre-widened: timed
        # only
        "library_ms": timer.ms(lambda: out.index_copy_(0, dst, rows16_f32)),
        "bytes": s_bytes, "bound_ms": bound_ms(s_bytes),
        "fill_bytes": (VOCAB + 1) * E * 4,
        "fill_bound_ms": bound_ms((VOCAB + 1) * E * 4),
    }
    res = {"phase": "kernels", "cases": cases, "n_ids": n, "owned": owned,
           "max_abs_err": errs, "launches": ops.launch_counts(),
           "embed_gather": gather, "embed_scatter_add": scatter}
    emit(res)
    return res


def phase_parity() -> None:
    cfg = reduced(get_config("parallax-lm"))
    shape = ShapeConfig("parity", 16, 4, "train")
    rc = RunConfig(param_dtype="float32", compute_dtype="float32")
    cpu = get_runner(cfg, shape, rc, seed=0, device="cpu")
    params = {k: p.detach().clone()
              for k, p in named_parameters(cpu.model).items()}
    gpu = get_runner(cfg, shape, rc, device="cuda",
                     params={k: p.to("cuda") for k, p in params.items()})
    ds = SyntheticLM(cfg.vocab_size, shape.seq_len, shape.global_batch)
    rows = []
    for i in range(3):
        b = ds.batch(i)
        mc, mg = cpu.run(b), gpu.run(b)
        lc, lg = float(mc["loss"]), float(mg["loss"])
        check(math.isclose(lc, lg, rel_tol=1e-4),
              f"step {i}: cpu loss {lc} vs card {lg}")
        for k in ("embed_rows", "embed_unique", "embed_dropped"):
            check(float(mc[k]) == float(mg[k]),
                  f"step {i}: {k} cpu {float(mc[k])} vs card {float(mg[k])}")
        rows.append({"cpu": lc, "cuda": lg, "rel": abs(lc - lg) / abs(lc),
                     "embed_unique": float(mg["embed_unique"])})
    emit({"phase": "parity", "steps": rows})


def phase_main(dev, steps: int = 10) -> dict:
    cfg = get_config("parallax-lm")
    shape = ShapeConfig("lm1b", seq_len=SEQ, global_batch=BATCH, kind="train")
    t0 = time.perf_counter()
    runner = get_runner(cfg, shape, RunConfig(), device="cuda")
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
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    for k, c in counts.items():
        check(c == steps, f"{k} launched {c} times in {steps} steps")
    med = statistics.median(step_ms)
    res = {"phase": "main", "arch": cfg.name, "tokens_per_step": shape.tokens,
           "losses": losses, "step_ms": step_ms, "median_step_ms": med,
           "tokens_per_s": shape.tokens / (med / 1e3),
           "max_memory_allocated": peak, "launches": counts,
           "setup_s": build_s,
           "nvidia_smi": nvidia_smi(
               "clocks.sm,power.draw,power.limit,temperature.gpu")}
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
    main_res = phase_main(dev)
    emit({"phase": "done", "seconds": time.perf_counter() - t0})
    print(info["nvidia_smi"], flush=True)
    rows = []
    for name, meta in KERNELS.items():
        k = kern[name]
        rows.append({"name": name, **meta,
                     "launches": main_res["launches"][name],
                     "max_abs_err": kern["max_abs_err"][name],
                     "ms": k["kernel_ms"], "plain_ms": k["plain_ms"],
                     "bound_ms": k["bound_ms"], "bound_by": "bytes",
                     "library_ms": k["library_ms"]})
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
