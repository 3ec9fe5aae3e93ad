"""The port's benchmark harness, one name per paper table or study (the
reference's ``benchmarks/run.py``):

    PYTHONPATH=src python -m repro_torch.benchmarks.run            # all
    PYTHONPATH=src python -m repro_torch.benchmarks.run table3 buckets
    PYTHONPATH=src python -m repro_torch.benchmarks.run census --device cpu

``census`` (Table 1), ``table3`` (Table 3), ``buckets`` (the bucketed
exchange, ``results/torch_exchange.json``), ``adaptive_replan`` (the
replan replay), ``serve`` (the serving engine against the toy loop,
``results/torch_serve.json``: phi3-medium-14b whole on the card, the
reference's reduced config with ``--device cpu``), ``elastic`` (the
straggler eviction, the re-admission and the stale fallback on gloo
ranks, ``results/torch_elastic.json``) and ``kernels`` (each
kernel against its plain version, the fused apply, the autotune sweep,
``results/torch_kernels.json``) run on the card unless ``--device cpu``.
``table4`` (Table 4), ``fig13`` (Figure 13) and ``roofline`` (the
dry-run's cells as a table) are dry-runs (launch/dryrun.py): they run on
the host whatever ``--device`` says, and each line says so. Each prints
``name,us_per_call,derived`` lines.
"""
from __future__ import annotations

import argparse
import importlib

BENCHES = {"census": "table1_census", "table3": "table3_transfer",
           "buckets": "bucket_exchange", "adaptive_replan": "adaptive_replan",
           "table4": "table4_ablation", "fig13": "fig13_scaling",
           "roofline": "roofline_table", "serve": "serve_bench",
           "kernels": "kernel_bench", "elastic": "elastic_remesh"}


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
        if name in ("adaptive_replan", "elastic"):
            mod.main([], device=args.device)
        elif name == "serve":
            mod.main(args.device, full=args.device != "cpu")
        else:
            mod.main(args.device)


if __name__ == "__main__":
    main()
