"""The port's benchmark harness, one name per paper table or study (the
reference's ``benchmarks/run.py``):

    PYTHONPATH=src python -m repro_torch.benchmarks.run            # all
    PYTHONPATH=src python -m repro_torch.benchmarks.run table3 buckets
    PYTHONPATH=src python -m repro_torch.benchmarks.run census --device cpu

``census`` (Table 1), ``table3`` (Table 3), ``buckets`` (the bucketed
exchange, ``results/torch_exchange.json``), ``adaptive_replan`` (the
replan replay). Each prints ``name,us_per_call,derived`` lines and runs
on the card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import importlib

BENCHES = {"census": "table1_census", "table3": "table3_transfer",
           "buckets": "bucket_exchange", "adaptive_replan": "adaptive_replan"}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="repro_torch.benchmarks.run")
    ap.add_argument("which", nargs="*", choices=[[]] + list(BENCHES),
                    help="benchmarks to run (default: all)")
    ap.add_argument("--device", default="cuda",
                    help="cpu or cuda (default: the card)")
    args = ap.parse_args(argv)
    for name in args.which or list(BENCHES):
        mod = importlib.import_module(
            f"repro_torch.benchmarks.{BENCHES[name]}")
        if name == "adaptive_replan":
            mod.main([], device=args.device)
        else:
            mod.main(args.device)


if __name__ == "__main__":
    main()
