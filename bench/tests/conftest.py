"""Fixtures of the benchmark's tests: a benchmark tree of tiny cells (the
real readers, tiny configurations, mixes and limits) that runs on the CPU,
and the ``card`` marker for the tests that need a CUDA card."""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY_OPT = {"name": "adamw", "lr": 0.001, "b1": 0.9, "b2": 0.95,
            "eps": 1e-08, "clip_norm": 1.0, "weight_decay": 0.0}
TINY_HARNESS = {"compared_steps": 3, "warmup_steps": 4, "trace_steps": 2,
                "record_steps": 2}
# the LM replans after step 4 (its ids are skewed enough that the capped
# capacity falls by the trainer's drift factor): steps 5 to 7 run on the new
# plan, and step 5's gradient is compared too
TINY_LM_HARNESS = dict(TINY_HARNESS, compared_steps=7, grad_steps=[1, 5],
                       warmup_steps=8)
TINY_CONFIGS = {
    "tiny-lstm": {"name": "tiny-lstm", "arch": "parallax-lm",
                  "family": "lstm", "n_layers": 1, "d_model": 32,
                  "d_ff": 64, "vocab_size": 256, "n_heads": 0,
                  "n_kv_heads": 0, "head_dim": 0, "dtype": "float32",
                  "optimizer": TINY_OPT,
                  "run": {"capacity_mode": "capped", "capacity_factor": 1.5,
                          "wire_dtype": "float32"},
                  "trainer": {"replan_every": 4, "replan_warmup": 2},
                  "harness": TINY_LM_HARNESS},
    "tiny-dense": {"name": "tiny-dense", "arch": "phi3-medium-14b",
                   "family": "dense", "n_layers": 2, "d_model": 32,
                   "d_ff": 64, "vocab_size": 256, "n_heads": 4,
                   "n_kv_heads": 2, "head_dim": 8, "rope_theta": 10000.0,
                   "norm_eps": 1e-05, "dtype": "float32",
                   "optimizer": TINY_OPT,
                   "run": {"remat": "block", "attention_impl": "chunked",
                           "wire_dtype": "float32"},
                   "trainer": {}, "harness": TINY_HARNESS},
}
TINY_MIXES = {
    "tiny-zipf": {"seq_len": 16, "batch_per_rank": 4, "ranks": 1,
                  "ids": {"dist": "zipf", "a": 1.3}},
    "tiny-zipf-dp2": {"seq_len": 16, "batch_per_rank": 4, "ranks": 2,
                      "ids": {"dist": "zipf", "a": 1.3}},
}
TINY_CELLS = [("tiny-lm", "tiny-lstm", "tiny-zipf", 1),
              ("tiny-dense", "tiny-dense", "tiny-zipf", 1),
              ("tiny-lm-dp2", "tiny-lstm", "tiny-zipf-dp2", 2)]
# limits of the tiny f32 cells: the port and the reference run the same
# arithmetic in another order, so every gap is float32 round-off
TINY_LIMITS = {"loss_gap": 1e-4, "grad_gap": 1e-3, "change_gap": 1e-2,
               "dropped_rows": 0}
TINY_LM_LIMITS = dict(TINY_LIMITS, later_grad_gap=1e-3)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skipped without one)")


@pytest.fixture
def card():
    """Skips the test where no CUDA card is present."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def make_tree(root: Path) -> Path:
    """A benchmark tree of the tiny cells under ``root``: BENCHMARK.json
    (the real metrics, the tiny cells), bench/{configs,traffic,limits} and
    the real readers."""
    real = json.loads((ROOT / "BENCHMARK.json").read_text())
    for m in real["end_to_end"] + real["per_layer"]:
        m.pop("workloads", None)
    real["configs"] = [{"name": n, "source": "tiny",
                        "file": f"bench/configs/{n}.json", "reduced": [],
                        "why": "tiny"} for n in TINY_CONFIGS]
    real["workloads"] = [{"name": w, "config": c, "traffic": t,
                          "chips": k, "why": "tiny"}
                         for w, c, t, k in TINY_CELLS]
    (root / "bench").mkdir(parents=True)
    (root / "BENCHMARK.json").write_text(json.dumps(real))
    for sub, items in (("configs", TINY_CONFIGS), ("traffic", TINY_MIXES),
                       ("limits", {w: TINY_LM_LIMITS if c == "tiny-lstm"
                                   else TINY_LIMITS
                                   for w, c, _, _ in TINY_CELLS})):
        (root / "bench" / sub).mkdir()
        for n, body in items.items():
            (root / "bench" / sub / f"{n}.json").write_text(json.dumps(body))
    shutil.copytree(ROOT / "bench" / "metrics", root / "bench" / "metrics")
    return root


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory) -> Path:
    return make_tree(tmp_path_factory.mktemp("bench_tree"))
