"""Run one cell of the port's benchmark once.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the cell's cards. The last
line of standard output is the result (one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``compared``: each number the check compared,
beside its limit); the compared numbers are also the last lines of standard
error. Without a card, with fewer cards than the cell asks for, or where
the port is not in the checkout, it exits non-zero and prints no result;
so it does if ``jax``, ``jaxlib``, ``flax`` or the JAX package ``repro`` is
loaded once the window has closed, in this process or in any rank of a
cell of several chips.

Kernel and compiler caches stay at fixed paths under ``build/`` in the
checkout, so only a checkout's first run builds.
"""
import time

T0 = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
for _k, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton"),
                 ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                 ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[_k] = str(ROOT / "build" / "bench" / _sub)
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
# this script's folder would shadow the standard library's ``trace``
sys.path[:] = [str(ROOT), str(ROOT / "src")] + [
    p for p in sys.path if Path(p or ".").resolve() != ROOT / "bench"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from bench import harness
    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("bench: no CUDA device", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"bench: {args.workload} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} here", file=sys.stderr)
        return 2
    out = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                           t0=T0)
    # this process's, and what each rank of a cell of several chips held
    found = sorted(set(harness.forbidden_modules()) | set(out.pop("loaded")))
    if found:
        print(f"bench: the run loaded {found}", file=sys.stderr)
        return 3
    for name, v in out["compared"].items():
        print(f"{name} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
