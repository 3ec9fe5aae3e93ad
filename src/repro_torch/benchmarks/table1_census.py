"""Paper Table 1 through the port: each architecture's dense and sparse
parameter census and the per-iteration touched subset (α·V rows) at 16
replicas, beside a reduced single-device training step's time (the
reference's ``benchmarks/table1_census.py``).

Every model is built on the ``meta`` device, so no full-width weight is
allocated; the census is analytic (``core/sparsity.py::run_census``). The
step runs on ``--device`` (the card by default).

    PYTHONPATH=src python -m repro_torch.benchmarks.run census [--device cpu]
"""
from __future__ import annotations

from repro_torch.benchmarks.common import device_name, emit, time_fn
from repro_torch.configs import (ALL_ARCHS, PAPER_ARCHS, SHAPES, RunConfig,
                                 ShapeConfig, get_config, reduced)
from repro_torch.core.runtime import Runtime
from repro_torch.core.sparsity import run_census
from repro_torch.core.transform import get_runner
from repro_torch.data import SyntheticLM
from repro_torch.models.model import build_model

REPLICAS = 16
STEP_SHAPE = ShapeConfig("bench", 64, 2, "train")


def census_row(arch: str) -> dict:
    """The census of ``arch`` at its published width, ``train_4k`` and
    ``REPLICAS`` replicas: dense_M, sparse_M, alpha, subset_M."""
    cfg, shape, rc = get_config(arch), SHAPES["train_4k"], RunConfig()
    model = build_model(cfg, Runtime(cfg, rc, shape, device="meta"))
    c = run_census(model.specs(), cfg, shape, rc, replicas=REPLICAS)
    return {"dense_M": c.dense_params / 1e6,
            "sparse_M": c.sparse_params / 1e6, "alpha": c.alpha,
            "subset_M": c.alpha * c.sparse_params / 1e6}


def step_seconds(arch: str, device) -> float:
    """Median seconds of a reduced training step at ``STEP_SHAPE``."""
    small = reduced(get_config(arch))
    runner = get_runner(small, STEP_SHAPE,
                        RunConfig(attention_impl="naive", remat="none"),
                        device=device)
    ds = SyntheticLM(small.vocab_size, STEP_SHAPE.seq_len,
                     STEP_SHAPE.global_batch, is_encdec=small.is_encdec,
                     frames_dim=small.d_model if small.family == "audio"
                     else 0, frames_len=16)
    batch = ds.batch(0)
    return time_fn(lambda: runner.run(batch)["loss"], device=device)


def main(device="cuda") -> dict:
    rows = {}
    for arch in ALL_ARCHS + PAPER_ARCHS:
        row = census_row(arch)
        sec = step_seconds(arch, device)
        row["reduced_tok_s"] = STEP_SHAPE.tokens / sec
        rows[arch] = row
        emit(f"table1/{arch}", sec * 1e6,
             f"dense_M={row['dense_M']:.0f};sparse_M={row['sparse_M']:.0f};"
             f"alpha={row['alpha']:.4f};subset_M={row['subset_M']:.2f};"
             f"reduced_tok_s={row['reduced_tok_s']:.0f};"
             f"device={device_name(device)}")
    return rows
