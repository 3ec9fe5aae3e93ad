"""What decides ``correct``: the program's first training steps against the
plain reference's, on the same weights and the same batches.

Readings of a run (the program's, or the reference's, or the control's):

``losses``        the loss of each compared step;
``grad_norms``    {leaf: the norm of the first gradient as the optimizer
                  got it}: the program's is worked out from its AdamW state
                  after one step (m = (1 - b1) g);
``grad_norms_at`` {step: {leaf: the same of a later compared step}}, the
                  steps a configuration's ``harness.grad_steps`` names (the
                  first step after the trainer's first replan, on the plan
                  the window runs): the program's
                  from its first moments before and after the step (m =
                  b1 m_before + (1 - b1) g);
``change_norms``  {leaf: the norm of the parameter's change over the
                  compared steps}, read before the next step runs;
``dropped``       embedding rows the program's capped plan dropped in the
                  compared steps (its own counter; the reference drops none).
``plans``         the program's (method, capacity) of its table at each
                  compared step: not compared, shown in the result line.

Numbers compared, each against a limit of its cell (``bench/limits``):

``loss_gap``      the largest |loss - reference loss| / reference loss
                  over the compared steps, or over the first
                  ``harness.loss_steps`` of them where a configuration
                  names it (later losses may leap under Adam's first steps
                  and magnify round-off: ``PERF.md``);
``first_loss_gap`` the same of the first step alone (before any update);
``grad_gap``      the worst leaf's |norm - reference norm| / max(reference
                  norm, the median leaf's reference norm);
``later_grad_gap`` the same of each step of ``grad_norms_at``, the
                  largest;
``change_gap``    the same of the change, over the leaves whose reference
                  gradient is at least a thousandth of the median leaf's
                  (a gradient that is nought to rounding moves a leaf under
                  Adam by round-off alone);
``dropped_rows``  rows dropped: an exact comparison, limit 0.

A cell's limits file names the numbers it compares: one whose sound runs
and control cannot be told apart at the cell's size is left out of it
(``PERF.md`` gives the readings).
"""
from __future__ import annotations

import json
import math
import statistics
from pathlib import Path
from typing import Optional

LIMITS_DIR = Path(__file__).resolve().parent / "limits"
NUMBERS = ("loss_gap", "first_loss_gap", "grad_gap", "later_grad_gap",
           "change_gap", "dropped_rows")
# a leaf's reference gradient under this share of the median leaf's is
# nought to rounding: its change is not compared
MOVED_SHARE = 1e-3


def load_limits(workload: str, root: Path = LIMITS_DIR) -> dict:
    """{number: limit} of the numbers the cell compares."""
    raw = json.loads((root / f"{workload}.json").read_text())
    unknown = set(raw) - set(NUMBERS)
    if unknown or not raw:
        raise ValueError(f"limits of {workload}: {sorted(raw)}; the numbers "
                         f"are {NUMBERS}")
    return {k: float(raw[k]) for k in NUMBERS if k in raw}


def _leaf_gap(got: dict, want: dict, leaves) -> float:
    leaves = list(leaves)
    med = statistics.median(want[n] for n in leaves)
    return max(abs(got[n] - want[n]) / max(want[n], med, 1e-30)
               for n in leaves)


def gaps(got: dict, want: dict, loss_steps: Optional[int] = None) -> dict:
    """The compared numbers of readings ``got`` against the reference's
    ``want``; ``loss_gap`` over the first ``loss_steps`` steps (all
    without it)."""
    rel = [abs(a - b) / abs(b) for a, b in
           zip(got["losses"], want["losses"], strict=True)]
    if not all(math.isfinite(x) for x in got["losses"]):
        rel = [math.inf] * len(rel)
    loss = max(rel[:loss_steps] if loss_steps else rel)
    if set(got["grad_norms"]) != set(want["grad_norms"]):
        raise ValueError(f"leaves {sorted(got['grad_norms'])} against "
                         f"{sorted(want['grad_norms'])}")
    grad = _leaf_gap(got["grad_norms"], want["grad_norms"], want["grad_norms"])
    med = statistics.median(want["grad_norms"].values())
    moved = [n for n, g in want["grad_norms"].items()
             if g >= MOVED_SHARE * med]
    change = _leaf_gap(got["change_norms"], want["change_norms"], moved)
    out = {"loss_gap": loss, "first_loss_gap": rel[0],
           "grad_gap": grad, "change_gap": change,
           "dropped_rows": float(got.get("dropped", 0.0))}
    later_got, later = got.get("grad_norms_at", {}), \
        want.get("grad_norms_at", {})
    if set(later_got) != set(later):
        raise ValueError(f"gradients of steps {sorted(later_got)} against "
                         f"{sorted(later)}")
    if later:
        out["later_grad_gap"] = max(
            _leaf_gap(later_got[k], later[k], later[k]) for k in later)
    return out


def judge(numbers: dict, limits: dict) -> tuple:
    """-> (correct, {name: {"value", "limit"}}) over the numbers
    ``limits`` names; a number that is not finite, or missing, fails."""
    shown = {k: {"value": numbers.get(k, math.nan), "limit": v}
             for k, v in limits.items()}
    ok = all(math.isfinite(x["value"]) and x["value"] <= x["limit"]
             for x in shown.values())
    return ok, shown


def worst_leaves(got: dict, want: dict) -> dict:
    """The leaf behind ``grad_gap`` and the one behind ``change_gap``."""
    med = statistics.median(want["grad_norms"].values())
    moved = [n for n, g in want["grad_norms"].items()
             if g >= MOVED_SHARE * med]

    def worst(key, leaves):
        m = statistics.median(want[key][n] for n in leaves)
        return max(leaves, key=lambda n: abs(got[key][n] - want[key][n])
                   / max(want[key][n], m, 1e-30))
    return {"grad": worst("grad_norms", list(want["grad_norms"])),
            "change": worst("change_norms", moved)}
