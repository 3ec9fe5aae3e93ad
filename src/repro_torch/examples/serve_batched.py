"""Batched serving through the port's engine (the port of
``examples/serve_batched.py``): one prefill per admission (one trace a
prompt-length bucket), the slot-paged decode with device-side sampling,
detokenization off the critical path. Twelve requests of 3-8 tokens on
the reduced phi3, 16 new tokens each.

    PYTHONPATH=src python -m repro_torch.examples.serve_batched

Runs on the card; ``main(device="cpu")`` runs it on the CPU.
"""
from __future__ import annotations

import time

import numpy as np

from repro_torch.configs import RunConfig, get_config, reduced
from repro_torch.runtime.server import Request, Server, ServerConfig


def main(*, device=None) -> list:
    """-> the completed requests."""
    cfg = reduced(get_config("phi3-medium-14b"))
    server = Server(cfg, RunConfig(attention_impl="naive"),
                    ServerConfig(max_batch=4, max_seq=128), device=device)
    rng = np.random.default_rng(0)
    for i in range(12):
        server.submit(Request(
            uid=i, prompt=rng.integers(0, cfg.vocab_size,
                                       int(rng.integers(3, 9)),
                                       dtype=np.int32),
            max_new_tokens=16))
    t0 = time.time()
    done = server.run_until_drained()
    dt = time.time() - t0
    toks = sum(len(r.out_tokens) for r in done)
    print(f"served {len(done)} requests / {toks} tokens in {dt:.1f}s "
          f"({toks / dt:.1f} tok/s, batch={server.scfg.max_batch})")
    print(f"  {server.stats['prefill_calls']} prefill dispatches over "
          f"buckets {sorted(server.stats['buckets'])} "
          f"({server.stats['prefill_traces']} traces), "
          f"{server.stats['decode_steps']} decode steps")
    for r in done[:3]:
        print(f"  req {r.uid}: {len(r.prompt)}-token prompt -> "
              f"{r.out_tokens[:8]}... (TTFT {r.ttft * 1e3:.0f} ms)")
    server.close()
    return done


if __name__ == "__main__":
    main()
