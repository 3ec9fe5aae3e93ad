"""A whole run of a cell, past the look for a chip, with the timed path
broken underneath: ``correct`` comes out false for each fault a training
cell can have, and true for the sound path."""
import time

import pytest

from bench import harness

SEED = 2 ** 31 + 7


def _run(root, workload, fault=None):
    cell = harness.load_cell(workload, root)
    return harness.run_cell(cell, SEED, 0.2, False, t0=time.monotonic(),
                            device="cpu", fault=fault)


@pytest.mark.parametrize("workload,fault", [
    ("tiny-lm", None), ("tiny-lm", "state_unchanged"),
    ("tiny-lm", "half_batch"), ("tiny-dense", None),
    ("tiny-dense", "state_unchanged"), ("tiny-dense", "half_batch"),
    ("tiny-lm-dp2", None), ("tiny-lm-dp2", "no_exchange")])
def test_a_broken_step_is_not_correct(tiny_root, workload, fault):
    out = _run(tiny_root, workload, fault)
    assert out["correct"] is (fault is None), out["compared"]
    assert list(out)[-1] == "compared"
    assert set(out) >= {"correct", "attempted", "failed", "metrics",
                        "device"}
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert {"tokens_per_s", "setup_s", "peak_mem_gib"} <= set(out["metrics"])
    if fault == "state_unchanged":
        assert out["compared"]["change_gap"]["value"] == 1.0


def test_the_traced_run_reports_the_per_layer_metrics(tiny_root):
    cell = harness.load_cell("tiny-lm", tiny_root)
    out = harness.run_cell(cell, SEED, 0.2, True, t0=time.monotonic(),
                           device="cpu")
    assert out["correct"]
    assert "train_mfu" in out["metrics"]
    assert "tokens_per_s" not in out["metrics"]
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert out["device"]["window_s"] > 0


def test_a_step_broken_only_after_the_replan_is_not_correct(tiny_root,
                                                           monkeypatch):
    """The replan after step 4 hands the trainer a step that leaves out half
    of each batch: only the compared steps 5 to 7 run it, and ``correct``
    comes out false."""
    from repro_torch.runtime import trainer as tr
    built = tr.apply_replan

    def broken(*args, **kwargs):
        step, state = built(*args, **kwargs)

        def half(state, batch):
            return step(state, {k: v[:len(v) // 2] for k, v in batch.items()})
        return half, state
    monkeypatch.setattr(tr, "apply_replan", broken)
    out = _run(tiny_root, "tiny-lm")
    assert out["correct"] is False, out["compared"]
    shown = out["compared"]
    assert shown["grad_gap"]["value"] <= shown["grad_gap"]["limit"]
    assert shown["later_grad_gap"]["value"] > shown["later_grad_gap"]["limit"]
    assert out["compared_plans"][4][1] < out["compared_plans"][0][1]
