"""Serving launcher: batched requests against a model (the port of
``repro/launch/serve.py``, the same command line).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch phi3-medium-14b \
      --reduced --requests 16 --max-new 8
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-7b \
      --engine toy --full

  PYTHONPATH=src python -m repro_torch.launch.serve --arch stablelm-12b \
      --full --max-seq 2048
  PYTHONPATH=src python -m repro_torch.launch.serve --arch grok-1-314b \
      --reduced
  PYTHONPATH=src python -m repro_torch.launch.serve --devices 4 --mesh 2x2

It runs on the card. ``--engine paged`` (default) runs the engine: one
prefill step per admission, slot-paged decode, device-side sampling; it
serves the dense family (phi3, stablelm-12b with its 160-wide heads,
command-r, mistral), moe (grok-1, llama4-maverick: the bucket-padded
prompt's pad tokens are routed too, as in the reference) and vlm
(chameleon-34b). ``--engine toy`` runs the
teacher-forced baseline loop, the one loop for the families the engine
refuses, as the reference's does: rwkv6-7b (ssm) and hymba-1.5b (hybrid),
whose recurrent state padding would corrupt, and seamless-m4t-medium
(audio), whose prefill needs encoder inputs (the loop decodes against the
cache's zero cross K/V, as the reference's). As in the reference, the
launcher serves with ``RunConfig(attention_impl="naive")``.

``--devices N --mesh DxM`` serves on a process mesh: N ranks
(``launch/mesh.py::spawn``), NCCL when there is a card per rank, gloo
otherwise (several ranks on one card, or the CPU), each running the
engine (the paged ``Server``, or ``ToyServer`` under ``--engine toy``) on
its shards: every block the plan shards tensor-parallel over ``model``,
the slots over the data axis, the decode cache's positions (or the
recurrent carry's units, channels or heads) over ``model``. Rank 0 prints
the report:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-7b \
      --engine toy --devices 2 --mesh 1x2
"""
from __future__ import annotations

import argparse
import math
import sys
import time

import numpy as np
import torch

from repro_torch.configs import RunConfig, get_config, reduced
from repro_torch.launch.mesh import make_mesh, spawn
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


def _mesh_dims(args) -> tuple:
    dims = tuple(int(x) for x in args.mesh.split("x"))
    axes = ("data", "model") if len(dims) == 2 else ("pod", "data", "model")
    if args.devices and math.prod(dims) != args.devices:
        raise ValueError(f"--mesh {args.mesh} holds {math.prod(dims)} "
                         f"ranks, --devices says {args.devices}")
    return dims, axes


def serve(args, device=None, mesh=None) -> list:
    """One process's run: build the engine, submit the seeded requests,
    drain. Prints on rank 0 only (every rank of a mesh prints nothing
    else); returns the completed requests."""
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
                 mesh=mesh, seed=args.seed, device=device)
    rank0 = mesh is None or mesh.rank == 0
    say = print if rank0 else (lambda *a, **k: None)
    dev = server.rt.device
    say(f"torch {torch.__version__}  device={dev}"
        + (f" ({torch.cuda.get_device_name(dev)})"
           if dev.type == "cuda" else "")
        + (f"  mesh={dict(mesh.shape)} backend={mesh.backend}"
           if mesh is not None else ""))
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
    say(f"[{args.engine}] served {len(done)} requests, {toks} tokens in "
        f"{dt:.1f}s ({toks/dt:.1f} tok/s, TTFT p50 "
        f"{ttft[len(ttft)//2]*1e3:.1f} ms)")
    if args.engine == "paged":
        say(f"  {server.stats['prefill_calls']} prefill dispatches / "
            f"{server.stats['prefill_traces']} traces over buckets "
            f"{sorted(server.stats['buckets'])}, "
            f"{server.stats['decode_steps']} decode steps, "
            f"{server.stats['cross_slot_mismatches']} cross-slot "
            f"mismatches")
        server.close()
    for r in done[:4]:
        say(f"  req {r.uid}: prompt {r.prompt.tolist()} -> {r.out_tokens}")
    if len(done) != args.requests:
        raise RuntimeError(f"served {len(done)} of {args.requests} requests")
    return done


def _rank_main(rank: int, world: int, argv: list, device: str,
               dims: tuple, axes: tuple) -> list:
    """One rank of ``--devices N --mesh DxM`` (launch/mesh.py::spawn):
    -> each completed request's (uid, prompt, tokens)."""
    dev = torch.device("cpu") if device == "cpu" else \
        torch.device("cuda", torch.cuda.current_device())
    mesh = make_mesh(dims, axes, device=dev)
    done = serve(_parse(argv), device=dev, mesh=mesh)
    return [(r.uid, r.prompt.tolist(), list(r.out_tokens)) for r in done]


def main(argv=None, *, device=None) -> list:
    """Run the launcher; ``device`` (default: the card) lets a caller run it
    on the CPU. One process: the completed requests; on a mesh: every
    rank's [(uid, prompt, tokens)]."""
    argv = sys.argv[1:] if argv is None else list(argv)
    args = _parse(argv)
    dev = torch.device("cuda" if device is None else device)
    if not args.mesh:
        if args.devices > 1:
            raise ValueError("--devices needs --mesh DxM")
        return serve(args, device=dev)
    dims, axes = _mesh_dims(args)
    world = math.prod(dims)
    backend = "nccl" if dev.type == "cuda" and \
        torch.cuda.device_count() >= world else "gloo"
    print(f"spawning {world} ranks on a {args.mesh} mesh over {backend}",
          flush=True)
    return spawn(_rank_main, world, backend, dev.type,
                 args=(argv, dev.type, dims, axes), timeout=3600)


if __name__ == "__main__":
    main()
