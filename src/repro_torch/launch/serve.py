"""Serving launcher: batched requests against a model (the port of
``repro/launch/serve.py``, the same command line).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch phi3-medium-14b \
      --reduced --requests 16 --max-new 8
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-7b \
      --engine toy --full

It runs on the card. ``--engine paged`` (default) runs the engine: one
prefill step per admission, slot-paged decode, device-side sampling;
``--engine toy`` the teacher-forced baseline loop (also the loop for
recurrent families such as rwkv6-7b, which the engine refuses). As in the
reference, the launcher serves with ``RunConfig(attention_impl="naive")``. ``--devices`` and ``--mesh`` belong
to the distributed port (ROADMAP slice 2 item 9) and are refused.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import RunConfig, get_config, reduced
from repro_torch.runtime.server import (Request, Server, ServerConfig,
                                        ToyServer)


def _parse(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="phi3-medium-14b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--engine", choices=("paged", "toy"), default="paged")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--sample", action="store_true",
                    help="temperature sampling instead of greedy argmax")
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--devices", type=int, default=0)
    ap.add_argument("--mesh", default="")
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


def main(argv=None, *, device=None) -> list:
    """Run the launcher; ``device`` (default: the card) lets a caller run it
    on the CPU."""
    args = _parse(argv)
    if args.devices > 1 or args.mesh:
        raise NotImplementedError(
            "--devices / --mesh are not ported yet: ROADMAP slice 2 item 9 "
            "(the launchers' mesh and a serve mesh)")
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    rng = np.random.default_rng(args.seed)
    cls = Server if args.engine == "paged" else ToyServer
    server = cls(cfg, RunConfig(attention_impl="naive"),
                 ServerConfig(max_batch=args.max_batch,
                              max_seq=args.max_seq,
                              greedy=not args.sample,
                              temperature=args.temperature),
                 seed=args.seed, device=device)
    dev = server.rt.device
    print(f"torch {torch.__version__}  device={dev}"
          + (f" ({torch.cuda.get_device_name(dev)})"
             if dev.type == "cuda" else ""))
    for i in range(args.requests):
        plen = int(rng.integers(2, 9))
        server.submit(Request(
            uid=i, prompt=rng.integers(0, cfg.vocab_size, plen,
                                       dtype=np.int32),
            max_new_tokens=args.max_new))
    t0 = time.time()
    done = server.run_until_drained()
    dt = time.time() - t0
    toks = sum(len(r.out_tokens) for r in done)
    ttft = sorted(r.ttft for r in done)
    print(f"[{args.engine}] served {len(done)} requests, {toks} tokens in "
          f"{dt:.1f}s ({toks/dt:.1f} tok/s, TTFT p50 "
          f"{ttft[len(ttft)//2]*1e3:.1f} ms)")
    if args.engine == "paged":
        print(f"  {server.stats['prefill_calls']} prefill dispatches / "
              f"{server.stats['prefill_traces']} traces over buckets "
              f"{sorted(server.stats['buckets'])}, "
              f"{server.stats['decode_steps']} decode steps, "
              f"{server.stats['cross_slot_mismatches']} cross-slot "
              f"mismatches")
        server.close()
    for r in done[:4]:
        print(f"  req {r.uid}: prompt {r.prompt.tolist()} -> {r.out_tokens}")
    if len(done) != args.requests:
        raise RuntimeError(f"served {len(done)} of {args.requests} requests")
    return done


if __name__ == "__main__":
    main()
