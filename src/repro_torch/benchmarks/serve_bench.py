"""The serving engine against the teacher-forced toy loop (the port of
``benchmarks/serve_bench.py``).

Drives ``runtime/server.py::Server`` (one prefill per admission, the
slot-paged decode with device-side sampling) and ``ToyServer`` (the loop
that prefills a token at a time through the decode step, host argmax)
over the reference's mix — prompts of 5, 11, 23 and 37 tokens drawn in
1..200 from ``default_rng(seed)``, 16 new tokens, greedy — at loads of 2,
6 and 12 requests in a burst, after a warm-up of one request per length
(seed 123). Per load: decode throughput (generated tokens / wall time to
drain), TTFT p50/p99 (submit -> first token on the host) and the gap
between a request's tokens p50/p99; the engine's hygiene: one prefill
call a request, one trace a length bucket, no token crossing slots.

``main(device="cuda", full=True)`` serves phi3-medium-14b whole, bf16,
attention "pallas" (the flash kernel), ``ServerConfig(4, 2048)``;
``full=False`` the reference's reduced config (2 layers, vocab 512,
``ServerConfig(4, 128)``, naive attention). Times are the host clock on
``device`` (a CPU run's say how fast PyTorch's CPU kernels are). Writes
``results/torch_serve.json`` (never ``BENCH_serve.json``).

    PYTHONPATH=src python -m repro_torch.benchmarks.run serve [--device cpu]
"""
from __future__ import annotations

import json
import math
import os
import time

import numpy as np

from repro_torch.benchmarks.common import RESULTS, device_name, emit

OUT = os.path.join(RESULTS, "torch_serve.json")
LOADS = (2, 6, 12)          # offered load: requests per burst
MAX_NEW = 16
PROMPT_LENS = (5, 11, 23, 37)


def _workload(n: int, seed: int = 0) -> list:
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 200, size=PROMPT_LENS[i % len(PROMPT_LENS)])
            .astype(np.int32) for i in range(n)]


def _percentiles(xs) -> dict:
    if not xs:
        return {"p50": float("inf"), "p99": float("inf")}
    return {"p50": float(np.percentile(xs, 50)),
            "p99": float(np.percentile(xs, 99))}


def _drive(server, prompts) -> dict:
    from repro_torch.runtime.server import Request
    reqs = [Request(i, p, max_new_tokens=MAX_NEW)
            for i, p in enumerate(prompts)]
    t0 = time.perf_counter()
    for r in reqs:
        server.submit(r)
    server.run_until_drained()
    wall = time.perf_counter() - t0
    undone = [r.uid for r in reqs if not r.done]
    assert not undone, f"requests never completed: {undone}"
    toks = sum(len(r.out_tokens) for r in reqs)
    ttft = [r.ttft for r in reqs]
    gaps = [b - a for r in reqs
            for a, b in zip(r.token_times, r.token_times[1:])]
    return {"requests": len(reqs), "tokens": toks, "wall_s": wall,
            "tok_per_s": toks / wall, "ttft_s": _percentiles(ttft),
            "per_token_s": _percentiles(gaps),
            "out_tokens": [list(map(int, r.out_tokens)) for r in reqs]}


def setup(full: bool):
    """(model config, RunConfig, ServerConfig) of the full or the
    reduced bench."""
    from repro_torch.configs import RunConfig, get_config, reduced
    from repro_torch.runtime.server import ServerConfig
    if full:
        return (get_config("phi3-medium-14b"),
                RunConfig(attention_impl="pallas"),
                ServerConfig(max_batch=4, max_seq=2048))
    return (reduced(get_config("phi3-medium-14b"), layers=2, vocab=512),
            RunConfig(attention_impl="naive"),
            ServerConfig(max_batch=4, max_seq=128))


def run(device: str = "cuda", full: bool = True, *, cfg=None,
        run_cfg=None, params=None) -> dict:
    """The bench's numbers (no assert): the engine at each load, then the
    toy loop on the same parameters at the highest. ``cfg`` / ``run_cfg``
    / ``params`` override the setup's (a test's f32 run on given
    weights)."""
    from repro_torch.runtime.server import Server, ToyServer
    base_cfg, base_rc, scfg = setup(full)
    cfg, rc = cfg or base_cfg, run_cfg or base_rc
    engine = Server(cfg, rc, scfg, params=params, seed=0, device=device)
    try:
        _drive(engine, _workload(len(PROMPT_LENS), seed=123))   # warm-up
        by_load = {}
        for n in LOADS:
            calls0 = engine.stats["prefill_calls"]
            r = _drive(engine, _workload(n))
            r["prefill_calls"] = engine.stats["prefill_calls"] - calls0
            by_load[n] = r
    finally:
        engine.close()
    stats = {k: (sorted(v) if isinstance(v, set) else v)
             for k, v in engine.stats.items()}
    tables = engine.plan.tables()
    toy = ToyServer(cfg, rc, scfg, params=engine.params, seed=0,
                    device=device)
    del engine
    _drive(toy, _workload(2, seed=123))          # the same courtesy warm-up
    toy_res = _drive(toy, _workload(max(LOADS)))
    del toy
    top = by_load[max(LOADS)]
    return {"device": device_name(device), "full": bool(full),
            "arch": cfg.name, "loads": list(LOADS),
            "max_new_tokens": MAX_NEW, "prompt_lens": list(PROMPT_LENS),
            "engine": {str(n): r for n, r in by_load.items()},
            "toy": toy_res,
            "speedup_vs_toy": top["tok_per_s"] / toy_res["tok_per_s"],
            "stats": stats, "tables": tables}


def check(res: dict) -> None:
    """The reference's five asserts."""
    for n, r in res["engine"].items():
        assert r["prefill_calls"] == int(n), \
            f"load {n}: {r['prefill_calls']} prefill dispatches (want one " \
            "per admitted request)"
    top = res["engine"][str(max(LOADS))]
    assert math.isfinite(top["ttft_s"]["p99"]), \
        "p99 TTFT not finite at the highest offered load"
    assert top["tok_per_s"] > res["toy"]["tok_per_s"], \
        "the engine is slower than the teacher-forced toy loop"
    assert res["stats"]["cross_slot_mismatches"] == 0, \
        "slot-paged decode leaked tokens across slots"
    assert res["stats"]["prefill_traces"] == len(res["stats"]["buckets"]), \
        "prefill retraced inside a length bucket"


def main(device: str = "cuda", full: bool = True) -> dict:
    res = run(device, full)
    dev = res["device"]
    for n, r in res["engine"].items():
        emit(f"serve/engine/load{n}", 1e6 / r["tok_per_s"],
             f"tok_s={r['tok_per_s']:.1f};"
             f"ttft_p50_ms={r['ttft_s']['p50'] * 1e3:.1f};"
             f"ttft_p99_ms={r['ttft_s']['p99'] * 1e3:.1f};"
             f"gap_p50_ms={r['per_token_s']['p50'] * 1e3:.2f};"
             f"gap_p99_ms={r['per_token_s']['p99'] * 1e3:.2f};"
             f"prefill_calls={r['prefill_calls']};device={dev}")
    t = res["toy"]
    emit(f"serve/toy/load{max(LOADS)}", 1e6 / t["tok_per_s"],
         f"tok_s={t['tok_per_s']:.1f};"
         f"ttft_p50_ms={t['ttft_s']['p50'] * 1e3:.1f};"
         f"speedup_engine={res['speedup_vs_toy']:.2f};"
         f"prefill_traces={res['stats']['prefill_traces']};"
         f"buckets={res['stats']['buckets']};device={dev}")
    check(res)
    os.makedirs(RESULTS, exist_ok=True)
    with open(OUT, "w") as f:
        json.dump(res, f, indent=2)
    print(f"OK: wrote {os.path.normpath(OUT)}")
    return res


if __name__ == "__main__":
    main()
