"""The paper's headline result through the port's dry-run: the bytes a
card puts on the wire, and the roofline-bound step, of PS, MPI and the
hybrid exchange for the paper's sparse LM (parallax-lm, 800k-row vocab,
one LSTM layer) at ``train_4k`` on the 16x16 production mesh, read from
the recorded collectives of one dry step each (the reference's
``examples/hybrid_comm_demo.py`` reads them from compiled HLO).

    PYTHONPATH=src python -m repro_torch.examples.hybrid_comm_demo
"""
from __future__ import annotations

from repro_torch.configs import RunConfig
from repro_torch.launch.dryrun import run_cells

MODES = ("ps", "mpi", "hybrid")


def compare(workers: int = 3) -> dict:
    """{mode: {"collective_GB", "bound_ms"}}."""
    cells = [dict(arch="parallax-lm", shape_name="train_4k",
                  run_cfg=RunConfig(comm_mode=m, capacity_mode="capped",
                                    remat="full"), verbose=False)
             for m in MODES]
    out = {}
    for mode, res in zip(MODES, run_cells(cells, workers)):
        if not res["ok"]:
            why = res.get("error") or res["contract"]
            raise RuntimeError(f"{mode}: {why}")
        r = res["roofline"]
        out[mode] = {"collective_GB": r["per_chip_collective_bytes"] / 1e9,
                     "bound_ms": r["bound_s"] * 1e3}
    return out


def main(workers: int = 3) -> dict:
    res = compare(workers)
    print("paper's LM (800k vocab, 1-layer LSTM) on the 16x16 mesh, "
          "train_4k (dry-run, H100 record):")
    for mode, d in res.items():
        print(f"  {mode:7s}: {d['collective_GB']:8.2f} GB/card on the "
              f"wire, roofline-bound step {d['bound_ms']:.0f} ms")
    hyb, mpi = res["hybrid"]["bound_ms"], res["mpi"]["bound_ms"]
    print(f"hybrid vs MPI bound speedup: {mpi / hyb:.2f}x "
          f"(paper Fig 12(c): PS-family beats MPI on sparse models)")
    return res


if __name__ == "__main__":
    main()
