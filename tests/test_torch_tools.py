"""The port's tools (``repro_torch/tools``, the repo-level ``tools/`` of
the JAX package) on the CPU:

* ``check_env --json`` runs, parses and imports no JAX;
* ``spmd_lint`` is clean on the port;
* ``profile_collectives fit`` on two gloo ranks writes a profile that
  ``cost_model.resolve_hw`` applies, and ``dump`` lists a cell's record;
* ``profile_dots``'s total equals ``run_cell``'s counted FLOPs on the
  main path's cell (full-width parallax-lm, one device), its rows and the
  kernels' count adding up to it;
* ``make_experiments`` writes the page where it is told and nowhere else.
"""
import json
import os
import subprocess
import sys

import pytest

import repro_torch.configs as tc
from repro_torch.benchmarks.common import RESULTS
from repro_torch.core.cost_model import resolve_hw
from repro_torch.launch import dryrun
from repro_torch.tools import (make_experiments, profile_collectives,
                               profile_dots, spmd_lint)

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
MAIN = tc.ShapeConfig("lm1b", 20, 128, "train")     # main's shape


def test_check_env_json_runs_without_jax():
    code = ("import json, sys\n"
            "from repro_torch.tools import check_env\n"
            "rc = check_env.main(['--json'])\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]\n"
            "print(json.dumps({'rc': rc, 'bad': bad}))\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    report, tail = (json.loads(line) for line in
                    proc.stdout.strip().splitlines()[-2:])
    assert tail == {"rc": 0, "bad": []}
    assert report["ok"] and report["analysis"]["clean"]
    assert report["torch"].split("+")[0] == \
        __import__("torch").__version__.split("+")[0]
    assert report["build"]["path"].endswith(os.path.join("build",
                                                         "repro_torch"))
    assert set(report["kernel_autotune"]) >= {"path", "state", "entries"}
    assert report["remesh"]["can_shrink_gloo"] is True
    assert report["attribution"]["stale_fallback"] is True


def test_spmd_lint_is_clean_on_the_port(capsys):
    assert spmd_lint.main([]) == 0
    assert "0 finding(s)" in capsys.readouterr().out


@pytest.mark.distributed
def test_profile_collectives_fit_writes_a_profile_resolve_hw_applies(
        tmp_path):
    out = tmp_path / "hw_profile.json"
    assert profile_collectives.main(
        ["fit", "--ranks", "2", "--device", "cpu", "--iters", "2",
         "--sizes", "4096", "65536", "1048576", "-o", str(out)]) == 0
    prof = json.loads(out.read_text())
    assert prof["backend"] == "gloo" and "host" in prof["note"]
    assert prof["link_latency"] >= 0 and prof["link_bw"] > 0
    hw = resolve_hw(tc.RunConfig(hw_profile=str(out)))
    assert (hw.link_latency, hw.link_bw) == (prof["link_latency"],
                                             prof["link_bw"])
    assert not hw.hierarchical


def test_profile_collectives_dump_lists_the_record():
    out = profile_collectives.dump("parallax-lm", "train_4k")
    assert out["rows"] and out["rows"][0][0] >= out["rows"][-1][0]
    assert sum(out["by_kind"].values()) == pytest.approx(
        sum(r[0] for r in out["rows"]))


def test_profile_dots_total_equals_run_cell():
    rc = tc.RunConfig()
    got = profile_dots.dot_census("parallax-lm", MAIN, rc, mesh=None)
    cell = dryrun.run_cell("parallax-lm", MAIN, run_cfg=rc, mesh=None,
                           verbose=False)
    assert cell["ok"]
    assert got["total"] == cell["flop_count"]["flops"] > 0
    assert sum(r[1] for r in got["rows"]) == got["aten"]
    assert got["aten"] + got["kernels"] == got["total"]
    assert got["rows"][0][1] >= got["rows"][-1][1]
    assert got["kernel_calls"]            # the embed kernels' counts


def test_make_experiments_writes_only_its_path(tmp_path):
    before = sorted(os.listdir(RESULTS)) if os.path.isdir(RESULTS) else None
    dry = tmp_path / "dry"
    dry.mkdir()
    (dry / "cell.json").write_text(json.dumps({
        "arch": "parallax-lm", "shape": "train_4k", "mesh": "16x16",
        "ok": True, "memory_analysis": {"peak_bytes": 2e9},
        "roofline": {"compute_s": 0.1, "memory_s": 0.2,
                     "collective_s": 0.05, "dominant": "memory",
                     "useful_flops_fraction": 0.9,
                     "roofline_fraction": 0.3}}))
    res = tmp_path / "res"
    res.mkdir()
    (res / "torch_elastic.json").write_text(json.dumps({"chaos": {}}))
    out = tmp_path / "page" / "EXPERIMENTS.md"
    make_experiments.main(["-o", str(out), "--dryrun-dir", str(dry),
                           "--results", str(res)])
    text = out.read_text()
    assert "h100-sxm" in text and "TPU" not in text
    assert "| parallax-lm | train_4k | 16x16 |" in text
    assert "torch_elastic.json" in text
    assert sorted(p.name for p in tmp_path.iterdir()) == \
        ["dry", "page", "res"]
    assert os.listdir(out.parent) == ["EXPERIMENTS.md"]
    after = sorted(os.listdir(RESULTS)) if os.path.isdir(RESULTS) else None
    assert before == after
