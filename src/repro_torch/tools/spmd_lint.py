"""The port's lint as a gate: the rules of ``repro_torch/analysis/
lint.py`` over ``src/repro_torch`` (or the given paths); exits 1 on any
finding (the reference's ``tools/spmd_lint.py``).

    PYTHONPATH=src python -m repro_torch.tools.spmd_lint [--json] [PATH ...]
"""
from __future__ import annotations

import argparse
import json
import os
import sys

from repro_torch.analysis.lint import lint_paths, lint_repo


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.tools.spmd_lint")
    ap.add_argument("paths", nargs="*",
                    help="files or directories (default: src/repro_torch)")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="the findings as a JSON list")
    args = ap.parse_args(argv)
    findings = (lint_paths(args.paths, os.getcwd()) if args.paths
                else lint_repo())
    if args.as_json:
        print(json.dumps([f.to_dict() for f in findings], indent=2))
    else:
        for f in findings:
            print(str(f))
        print(f"spmd_lint: {len(findings)} finding(s)")
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
