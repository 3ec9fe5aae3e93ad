"""The command itself: no card or too few cards, or a checkout without the
port, is a non-zero exit and no result line."""
import shutil
import subprocess
import sys

import pytest

from bench.harness import ROOT


def _run(cwd, *args):
    return subprocess.run(
        [sys.executable, "bench/run.py", "--workload", "lm1b-zipf",
         "--seed", "3", "--seconds", "1", "--trace", "0", *args],
        cwd=cwd, capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = _run(ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "no CUDA device" in out.stderr


def test_a_checkout_of_the_benchmark_alone_gives_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


@pytest.mark.card
def test_tiny_cell_on_the_card_matches_the_reference(card, tiny_root):
    """The port's step on the card against the f32 reference on the card,
    at the tiny f32 width."""
    import time

    from bench import harness
    cell = harness.load_cell("tiny-lm", tiny_root)
    out = harness.run_cell(cell, 5, 0.5, False, t0=time.monotonic(),
                           device="cuda")
    assert out["correct"], out["compared"]
    assert out["device"]["platform"] == "gpu"


def test_a_rank_that_loaded_jax_gives_no_result(monkeypatch, capsys):
    """A forbidden module that any rank held after its window (each rank's
    record names them under ``loaded``) is a non-zero exit and no result,
    though the starting process holds none."""
    import importlib.util

    import torch

    from bench import harness
    # the script sets these and the module path as it is loaded
    for key in ("TORCH_EXTENSIONS_DIR", "TRITON_CACHE_DIR",
                "TORCHINDUCTOR_CACHE_DIR", "CUDA_CACHE_PATH", "USE_FLAX",
                "USE_JAX"):
        monkeypatch.setenv(key, "")
    monkeypatch.setattr(sys, "path", list(sys.path))
    spec = importlib.util.spec_from_file_location("bench_run_script",
                                                  ROOT / "bench" / "run.py")
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(harness, "forbidden_modules", lambda: [])
    monkeypatch.setattr(harness, "run_cell", lambda *a, **k: {
        "correct": True, "loaded": ["jax"], "compared": {}})
    rc = script.main(["--workload", "lm1b-zipf", "--seed", "3",
                      "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out.strip() == ""
    assert "['jax']" in out.err


def test_every_rank_reports_what_it_loaded(tiny_root):
    """Each rank's record carries the forbidden modules it held after its
    window; the run gathers them under ``loaded``."""
    import time

    from bench import harness
    cell = harness.load_cell("tiny-lm-dp2", tiny_root)
    out = harness.run_cell(cell, 11, 0.2, False, t0=time.monotonic(),
                           device="cpu")
    assert isinstance(out["loaded"], list)
    assert out["loaded"] == []
