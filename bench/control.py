"""The readings a cell's limits are set from, on the chip at the cell's own
size, several seeds in one process (none of this runs in a benchmark run).

    python3 bench/control.py --workload <name> --what <what> --seeds 1 2 3

``--what``:

``program``      the program's compared steps (``harness.setup``) against
                 the reference: the sound runs, whose largest reading over
                 a dozen seeds is a number's lower reading (one chip);
``fp8``          the control: the reference computed with float8 weight
                 products, in the program's place;
``half_batch``   the reference on the first half of each batch's rows;
``no_exchange``  the reference on rank 0's rows, its gradient 1 / ranks of
                 theirs, as a step whose all-reduce is left out.

A state left unchanged reads 1 on ``grad_gap`` and ``change_gap`` by the
measure itself (``check.gaps``) and needs no run. One JSON line a seed on
standard output: the compared numbers and the losses.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:] = [str(ROOT), str(ROOT / "src")] + [
    p for p in sys.path if Path(p or ".").resolve() != ROOT / "bench"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--what", required=True,
                    choices=("program", "fp8", "half_batch", "no_exchange"))
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    import torch
    from bench import check, harness
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    dev = torch.device("cuda", 0)
    for seed in args.seeds:
        t = time.monotonic()
        if args.what == "program":
            if cell.chips != 1:
                raise SystemExit("control: the program's readings of a "
                                 "cell of several chips come from its runs")
            trainer, step, _, got = harness.setup(cell, seed, device=dev)
            del trainer, step
            harness.release()
        elif args.what == "fp8":
            got = harness.reference_readings(cell, seed, dev,
                                             precision="fp8")
        else:
            got = harness.reference_readings(cell, seed, dev,
                                             fault=args.what)
        want = harness.reference_readings(cell, seed, dev)
        print(json.dumps({"workload": cell.name, "what": args.what,
                          "seed": seed, **harness.compare(cell, got, want),
                          "worst": check.worst_leaves(got, want),
                          "losses": got["losses"],
                          "ref_losses": want["losses"],
                          "seconds": time.monotonic() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
