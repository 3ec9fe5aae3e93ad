"""The scatter-tile autotune (kernels/autotune.py), the tile's path to the
kernel, and the CPU part of the port's kernel benchmark
(repro_torch/benchmarks/kernel_bench.py).

The cache: its key ``kernel:VsxE:nN:dtype:cuda:smXY``, its atomic write
(a failed write leaves the old file and no temp file), the port's own
environment variables (``REPRO_TORCH_AUTOTUNE_CACHE``,
``REPRO_TORCH_AUTOTUNE_NO_MEASURE``). The sweep measures R = 0 and the
roofline's cheapest candidates and keeps the argmin, so tuned <= fixed.
Keyed on the device: on the CPU nothing is measured and a runner's tables
keep tiles (0, 0); a stamped tile R reaches ``ops.embed_scatter_add``
through ``Runtime.embed_ctx`` and gives the kernel a grid of ceil(Vs /
R) blocks. kernel_bench's CPU part: the fused apply bit for bit, and
``fused_apply`` on and off on gloo (4, 1) ranks at a 0.0 loss
divergence (``kernel_autotune`` on and off too)."""
import json
import os

import numpy as np
import pytest
import torch

import repro_torch.configs as tc
from repro_torch.benchmarks import kernel_bench
from repro_torch.core import embedding
from repro_torch.core.transform import get_runner
from repro_torch.data import SyntheticLM
from repro_torch.kernels import autotune, ops
from repro_torch.utils import roofline


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cache(tmp_path, monkeypatch):
    path = tmp_path / "tune" / "kernel_autotune.json"
    monkeypatch.setenv(autotune.CACHE_ENV, str(path))
    monkeypatch.delenv(autotune.NO_MEASURE_ENV, raising=False)
    return path


@pytest.fixture
def sm90(monkeypatch):
    monkeypatch.setattr(torch.cuda, "get_device_capability",
                        lambda device=None: (9, 0))


def test_cache_key_names_shape_dtype_and_card(sm90):
    key = autotune._key("scatter", 800000, 512, 2560, torch.bfloat16, "cuda")
    assert key == "scatter:800000x512:n2560:bfloat16:cuda:sm90"
    assert autotune.backend("cpu") == "cpu"
    assert autotune.DEFAULT_CACHE.endswith(
        os.path.join(".cache", "repro_torch", "kernel_autotune.json"))
    assert autotune.CACHE_ENV != "REPRO_AUTOTUNE_CACHE"


def test_cache_write_is_atomic(cache, monkeypatch):
    autotune._save({"a": {"best": 0, "us": {"0": 1.0}}})
    assert json.loads(cache.read_text())["a"]["best"] == 0
    assert autotune.cache_status()["entries"] == 1

    def fail(src, dst):
        raise OSError("disk full")
    monkeypatch.setattr(os, "replace", fail)
    autotune._save({"b": {}})
    assert set(json.loads(cache.read_text())) == {"a"}    # old file kept
    assert os.listdir(cache.parent) == [cache.name]       # no temp left


def test_no_measure_and_cpu_measure_nothing(cache, sm90, monkeypatch):
    # on the CPU: no tile, nothing measured, no file
    assert autotune.tune("scatter", 4096, 256, 128, torch.float32,
                         device="cpu") == (0, {})
    # the gather has no tile on any device
    assert autotune.tune("gather", 4096, 256, 128, torch.float32,
                         device="cuda") == (0, {})
    monkeypatch.setenv(autotune.NO_MEASURE_ENV, "1")
    assert not autotune.measurement_allowed()
    assert autotune.tune("scatter", 4096, 256, 128, torch.float32,
                         device="cuda") == (0, {})
    assert not cache.exists()
    # a cache hit still applies
    key = autotune._key("scatter", 4096, 256, 128, torch.float32, "cuda")
    autotune._save({key: {"best": 64, "us": {"0": 2.0, "64": 1.5}}})
    assert autotune.tune("scatter", 4096, 256, 128, torch.float32,
                         device="cuda") == (64, {0: 2.0, 64: 1.5})


def test_sweep_keeps_the_argmin_and_always_measures_zero(cache, sm90,
                                                         monkeypatch):
    """The sweep with its timer and inputs stood in for (no card here):
    R = 0 is among the measured, the partition's own R is not (it is 0's
    launch), the cheapest measured wins and is cached."""
    vs, e, n = 800_000, 512, 2560
    cands = autotune.sweep_candidates(vs, e, n, 2)
    own = ops.scatter_partition(vs, e, n)[0]
    assert cands[0] == 0 and own not in cands     # 32: the same launch
    assert set(cands) == set(roofline.kernel_tile_candidates(vs)) - {own}
    fake = [5.0, 4.0, 3.0, 2.5, 3.5] + [6.0] * (len(cands) - 5)
    monkeypatch.setattr(autotune, "_time_us",
                        lambda fns: dict(zip(fns, fake)))
    monkeypatch.setattr(autotune, "sweep_inputs",
                        lambda *a: (None, None))
    best, us = autotune.tune("scatter", vs, e, n, torch.bfloat16,
                             device="cuda")
    assert list(us) == cands and best == cands[3]
    assert us[best] <= us[0]
    hit = json.loads(cache.read_text())
    assert hit[autotune._key("scatter", vs, e, n, torch.bfloat16,
                             "cuda")]["best"] == best


def test_candidates_fit_the_block_map():
    cands = roofline.kernel_tile_candidates(800_000)
    assert cands[0] == 0
    assert all(4 * r <= roofline.HW.smem_bytes and r <= 8192
               for r in cands[1:])
    assert roofline.kernel_tile_candidates(100) == [0, 16, 32, 64]
    # R = 0 is scatter_partition's own choice
    r0, _ = ops.scatter_partition(800_000, 512, 2560)
    assert roofline.embed_tile_seconds(2560, 512, 0, 2, 800_000) == \
        roofline.embed_tile_seconds(2560, 512, r0, 2, 800_000)


def test_tile_reaches_the_kernel_call(monkeypatch):
    """A stamped (0, R) reaches the wrapper's ``block``; the launch takes
    R rows a block and ceil(Vs / R) blocks; every R gives the plain
    version's bits on the CPU."""
    cfg = tc.reduced(tc.get_config("parallax-lm"))
    shape = tc.ShapeConfig("t", 8, 2, "train")
    run = get_runner(cfg, shape, tc.RunConfig(kernel_autotune=True),
                     device="cpu")
    assert run.plan.table_tiles.get("embed", (0, 0)) == (0, 0)
    run.plan.table_tiles["embed"] = (0, 64)
    seen = []
    real = ops.embed_scatter_add

    def spy(ids, rows, vs, block=0):
        seen.append(block)
        return real(ids, rows, vs, block=block)
    monkeypatch.setattr(embedding.ops, "embed_scatter_add", spy)
    run.run(SyntheticLM(cfg.vocab_size, 8, 2).batch(0))
    assert seen == [64]
    assert ops.scatter_grid(800_000, 512, 2560, 64) == (64, 12500)
    assert ops.scatter_grid(800_000, 512, 2560) == \
        ops.scatter_partition(800_000, 512, 2560)
    ids = torch.randperm(300)[:40].to(torch.int32)
    rows = torch.randn((40, 8))
    want = ops.embed_scatter_add(ids, rows, 300)
    for r in (16, 64, 8192):
        assert torch.equal(ops.embed_scatter_add(ids, rows, 300, block=r),
                           want)
    with pytest.raises(ValueError, match="scatter block"):
        ops.embed_scatter_add(ids, rows, 300, block=8193)


def test_ensure_for_plan_stamps_nothing_off_the_card():
    cfg = tc.reduced(tc.get_config("parallax-nmt"), vocab=256)
    run = get_runner(cfg, tc.ShapeConfig("t", 8, 2, "train"),
                     tc.RunConfig(), device="cpu")
    assert autotune.ensure_for_plan(run.plan, run.rt, run.model) == {}
    assert run.plan.table_tiles == {}


@pytest.mark.distributed
def test_kernel_bench_cpu_part():
    fa = kernel_bench.fused_apply_bench("cpu")
    assert fa["bit_equal"] and fa["n_buckets"] == 4
    sw = kernel_bench.switches("cpu")
    assert sw["fused"]["fused_flag"]
    assert sw["fused"]["loss_divergence"] == 0.0
    assert sw["autotune"]["loss_divergence"] == 0.0
    assert sw["autotune"]["tiles"] == [0, 0]
    assert all(np.isfinite(sw["fused"]["on_losses"]))
    sweep = kernel_bench.autotune_sweep("cpu")
    assert all(r["best_block"] == 0 and not r["sweep_us"]
               for r in sweep.values())
