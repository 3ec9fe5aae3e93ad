"""The plain reference against the port's training step at a tiny width on
the CPU (float32 throughout, so every gap is round-off), and the control:
the reference in float8 in the program's place reads far above it."""
import pytest

from bench import check, harness
from bench.tests.conftest import TINY_LIMITS

SEED = 2 ** 31 + 101


@pytest.mark.parametrize("workload", ["tiny-lm", "tiny-dense"])
def test_reference_agrees_with_the_ports_step(tiny_root, workload):
    cell = harness.load_cell(workload, tiny_root)
    trainer, step, log, got = harness.setup(cell, SEED, device="cpu")
    n_cmp = cell.config["harness"]["compared_steps"]
    assert len(got["losses"]) == n_cmp and got["dropped"] == 0
    del trainer, step
    harness.release()
    want = harness.reference_readings(cell, SEED, "cpu")
    gaps = check.gaps(got, want)
    assert gaps["loss_gap"] < 1e-5
    assert gaps["grad_gap"] < 1e-5
    assert gaps["change_gap"] < 1e-4
    if workload == "tiny-lm":
        # the replan after step 4 put in a capped table: steps 5 to 7 ran
        # on it, and step 5's gradient was compared
        assert got["plans"][4] != got["plans"][0]
        assert got["plans"][4][1] < got["plans"][0][1]
        assert set(got["grad_norms_at"]) == {"5"}
        assert gaps["later_grad_gap"] < 1e-5
    else:
        assert "later_grad_gap" not in gaps
    # the losses fall over the compared steps in both
    assert want["losses"][-1] < want["losses"][0]


@pytest.mark.parametrize("workload", ["tiny-lm", "tiny-dense"])
def test_the_fp8_control_fails_the_limits(tiny_root, workload):
    cell = harness.load_cell(workload, tiny_root)
    want = harness.reference_readings(cell, SEED, "cpu")
    ctl = harness.reference_readings(cell, SEED, "cpu", precision="fp8")
    gaps = check.gaps(ctl, want)
    ok, _ = check.judge(gaps, TINY_LIMITS)
    assert not ok
    assert max(gaps["loss_gap"] / TINY_LIMITS["loss_gap"],
               gaps["grad_gap"] / TINY_LIMITS["grad_gap"]) > 3


def test_leaves_with_no_gradient_are_not_compared():
    want = {"losses": [1.0], "grad_norms": {"a": 1.0, "b": 2.0, "z": 1e-9},
            "change_norms": {"a": 1.0, "b": 1.0, "z": 1e-6}}
    got = {"losses": [1.0], "grad_norms": dict(want["grad_norms"]),
           "change_norms": {"a": 1.0, "b": 1.0, "z": 5e-6}, "dropped": 0}
    assert check.gaps(got, want)["change_gap"] == 0.0
    got["change_norms"]["a"] = 0.0
    assert check.gaps(got, want)["change_gap"] == 1.0
