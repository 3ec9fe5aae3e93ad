"""Where the time of serving goes, on the card.

    PYTHONPATH=src python -m repro_torch.launch.profile_serve [--arch ARCH]

Builds a serve path of chip_smoke.py at full width, bf16,
ServerConfig(max_batch=4, max_seq=2048), seed 0, and runs torch.profiler
over

  phi3-medium-14b (default; the paged engine, RunConfig(attention_impl=
            "pallas")), and the moe family on the same engine at its
            published width with the layers cut (``SERVE_LAYERS``:
            grok-1-314b 4 of 64, llama4-maverick-400b-a17b 1 of 48), after
            warming every prefill bucket:
    prefill   one engine prefill step per bucket (256 ... 2048 tokens);
    decode    10 engine decode steps over the full batch of 4;
  rwkv6-7b (ToyServer, the loop of the recurrent family), after one warm
            call of each:
    prefill   one 2,048-token make_prefill_step;
    decode    10 ToyServer decode steps over the full batch of 4;

and prints one JSON line each from ``profile_step.profiled``: per step,
device time by kernel class, the top kernels by name, the device's idle
share (1 - union of kernel intervals / profiled wall window) and the wall
time.
Chrome traces go to results/profile_serve/. Needs a card; without one it
exits non-zero.
"""
from __future__ import annotations

import argparse
import json
import sys
from dataclasses import replace
from pathlib import Path

import numpy as np
import torch

from repro_torch.configs import RunConfig, get_config
from repro_torch.core.transform import make_prefill_step
from repro_torch.launch.profile_step import profiled
from repro_torch.runtime.server import (Server, ServerConfig, ToyServer,
                                        prefill_buckets)

OUT = Path(__file__).resolve().parents[3] / "results" / "profile_serve"
DECODE_STEPS = 10
# the serve paths whose published depth does not fit the 80 GB card: the
# layers kept (bf16 weights: grok-1 at 4 layers 42.6 GB, 64 would be
# ~630 GB; llama4-maverick at 1 layer 36.7 GB, 2 would be 69 GB)
SERVE_LAYERS = {"grok-1-314b": 4, "llama4-maverick-400b-a17b": 1}


def serve_config(arch: str):
    """``arch``'s published config, cut to ``SERVE_LAYERS`` where listed."""
    cfg = get_config(arch)
    if arch in SERVE_LAYERS:
        cfg = replace(cfg, n_layers=SERVE_LAYERS[arch])
    return cfg


def _emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def _toy(cfg, scfg: ServerConfig) -> None:
    """The recurrent family's path: ToyServer's decode step and the
    whole-prompt prefill step."""
    sv = ToyServer(cfg, RunConfig(), scfg, seed=0)
    dev = sv.rt.device
    rng = np.random.default_rng(0)
    lb = scfg.max_seq
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, lb))
                            .astype(np.int32)).to(dev)
    step_toks = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (scfg.max_batch, 1)).astype(np.int32)).to(dev)
    prefill_step = make_prefill_step(sv.model, sv.rt, sv.plan)

    def prefill():
        prefill_step({"tokens": toks})

    def decode():
        for _ in range(DECODE_STEPS):
            sv.decode_step(sv.cache, step_toks, 0)

    prefill()                               # warm every GEMM shape
    decode()
    _emit({"phase": "prefill", "arch": cfg.name, "tokens": lb,
           "device": torch.cuda.get_device_name(0),
           **profiled(prefill, 1, OUT / f"{cfg.name}_prefill_{lb}.json")})
    _emit({"phase": "decode", "arch": cfg.name, "batch": scfg.max_batch,
           **profiled(decode, DECODE_STEPS, OUT / f"{cfg.name}_decode.json")})


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="phi3-medium-14b",
                    choices=("phi3-medium-14b", "rwkv6-7b",
                             *SERVE_LAYERS))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("profile_serve: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = serve_config(args.arch)
    scfg = ServerConfig(max_batch=4, max_seq=2048)
    if cfg.family == "ssm":
        return _toy(cfg, scfg)
    sv = Server(cfg, RunConfig(attention_impl="pallas"), scfg, seed=0)
    tag = f"{cfg.name}_" if args.arch in SERVE_LAYERS else ""
    dev = sv.rt.device
    rng = np.random.default_rng(0)
    buckets = [b for b in prefill_buckets(scfg.max_seq) if b >= 256]
    toks = {lb: torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, lb))
                                 .astype(np.int32)).to(dev)
            for lb in buckets}

    def prefill(lb):
        for slot in range(scfg.max_batch):
            sv._prefill(sv.cache, sv.lens, sv.tok, toks[lb], lb, slot,
                        sv._gen)

    active = torch.ones(scfg.max_batch, dtype=torch.bool, device=dev)

    def decode():
        for _ in range(DECODE_STEPS):
            sv._decode(sv.cache, sv.lens, sv.tok, active, sv._gen)

    for lb in buckets:                      # warm every GEMM shape
        prefill(lb)
    decode()
    for lb in buckets:
        _emit({"phase": "prefill", "arch": cfg.name, "tokens": lb,
               "device": torch.cuda.get_device_name(0),
               **profiled(lambda: prefill(lb), scfg.max_batch,
                          OUT / f"{tag}prefill_{lb}.json")})
    sv.lens.fill_(1024)
    _emit({"phase": "decode", "arch": cfg.name, "batch": scfg.max_batch,
           "cache_len": 1024,
           **profiled(decode, DECODE_STEPS, OUT / f"{tag}decode.json")})
    sv.close()


if __name__ == "__main__":
    main()
