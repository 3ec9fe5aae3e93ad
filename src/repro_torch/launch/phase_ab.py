"""Compare checkouts on one card: chosen phases of each one's chip_smoke.py.

    PYTHONPATH=src python -m repro_torch.launch.phase_ab --phase serve \\
        build/parent . . build/parent

Each checkout named (a directory holding chip_smoke.py; the parent commit
unpacked with ``git archive`` into a directory .gitignore lists) runs in its
own process, in the order given — parent, change, change, parent — so two
versions meet the same card, host and power limit in one run. Each process
runs the banner and then the named phases of that checkout's own
chip_smoke.py, and its JSON lines are printed prefixed with the checkout.
Phases: serve, rwkv_serve, main, main_no_la (the paths), kernels. Needs a
card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

_RUN = """
import importlib.util, sys, torch
spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[1])
smoke = importlib.util.module_from_spec(spec)
spec.loader.exec_module(smoke)
smoke.phase_banner()
dev = torch.device("cuda", 0)
for name in sys.argv[2:]:
    getattr(smoke, "phase_" + name)(dev)
"""
PHASES = ("serve", "rwkv_serve", "main", "main_no_la", "kernels")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phase", action="append", choices=PHASES,
                    required=True)
    ap.add_argument("roots", nargs="+", type=Path)
    args = ap.parse_args(argv)
    failed = 0
    for root in args.roots:
        smoke = (root / "chip_smoke.py").resolve()
        if not smoke.is_file():
            sys.exit(f"phase_ab: no chip_smoke.py in {root}")
        proc = subprocess.run([sys.executable, "-c", _RUN, str(smoke),
                               *args.phase], cwd=smoke.parent,
                              capture_output=True, text=True)
        for line in proc.stdout.splitlines():
            if line.startswith("{"):
                print(json.dumps({"root": str(root), **json.loads(line)}),
                      flush=True)
        if proc.returncode != 0:
            failed += 1
            print(f"phase_ab: {root} exited {proc.returncode}\n"
                  f"{proc.stderr[-4000:]}", file=sys.stderr, flush=True)
    sys.exit(1 if failed else 0)


if __name__ == "__main__":
    main()
