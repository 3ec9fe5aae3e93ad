"""Cells, configurations, mixes, limits and metric readers are found by
name from data; a new cell, mix or metric is new files and entries."""
import json
import re
import shutil

import pytest

from bench import check, harness
from bench.harness import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_every_shipped_cell_loads_with_its_files():
    b = _bench()
    for w in b["workloads"]:
        cell = harness.load_cell(w["name"])
        assert cell.chips == cell.mix.ranks
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.per_layer
        for m in cell.end_to_end + cell.per_layer:
            assert callable(harness.reader(m["name"]))
        assert cell.limits and set(cell.limits) <= set(check.NUMBERS)
        assert cell.limits.get("dropped_rows", 0) == 0


@pytest.mark.parametrize("key", ["workloads", "configs", "end_to_end",
                                 "per_layer"])
def test_names_and_units_keep_the_contract(key):
    b = _bench()
    names = [e["name"] for e in b[key]]
    assert len(names) == len(set(names))
    for e in b[key]:
        assert NAME.match(e["name"]), e["name"]
        for text in ("why", "layer", "source"):
            if text in e:
                assert 1 <= len(e[text]) <= 200 and "\n" not in e[text] \
                    and "\t" not in e[text], (e["name"], text)
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")


def test_the_benchmark_file_keeps_the_contract():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["bench"] and b["command"][1] == "bench/run.py"
    assert 1 <= b["run_seconds"] <= 51
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    four = [w for w in b["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(b["workloads"]) // 4)
    layers = {}
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        layers.setdefault(m["layer"], set()).add(m["name"])
        for w in m.get("workloads", []):
            cell = harness.load_cell(w)
            assert m["moves"] in {x["name"] for x in cell.end_to_end}
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for c in b["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert c["file"].startswith("bench/")
        assert len(c["reduced"]) <= 16
    assert len(json.dumps(b)) < 64 * 1024


def test_a_new_cell_mix_and_metric_are_files_and_entries(tmp_path):
    """A later cell: a mix file, a limits file, a reader file and entries;
    every existing file is left as it is."""
    root = tmp_path
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    shutil.copytree(ROOT / "bench", root / "bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p: p.read_bytes() for p in (root / "bench").rglob("*")
              if p.is_file()}
    (root / "bench" / "traffic" / "lm1b-uniform.json").write_text(json.dumps(
        {"seq_len": 20, "batch_per_rank": 128, "ranks": 1,
         "ids": {"dist": "uniform"}}))
    (root / "bench" / "limits" / "lm1b-uniform.json").write_text(
        (root / "bench" / "limits" / "lm1b-zipf.json").read_text())
    (root / "bench" / "metrics" / "steps_traced.py").write_text(
        "def read(run):\n    return None if run.trace is None else "
        "run.trace.steps\n")
    b = json.loads((root / "BENCHMARK.json").read_text())
    b["workloads"].append({"name": "lm1b-uniform", "config": "parallax-lm",
                           "traffic": "lm1b-uniform", "chips": 1,
                           "why": "uniform ids"})
    b["per_layer"].append({"name": "steps_traced", "unit": "steps",
                           "better": "higher", "source": "device_trace",
                           "layer": "step", "moves": "tokens_per_s",
                           "workloads": ["lm1b-uniform"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    cell = harness.load_cell("lm1b-uniform", root)
    assert cell.mix.dist == "uniform" and cell.config["arch"] == \
        "parallax-lm"
    assert [m["name"] for m in cell.per_layer] == ["steps_traced"]
    assert harness.reader("steps_traced", root)(
        harness.RankRun(cell=cell, rank=0, world=1, trace=None, steps=[],
                        table_rows=1, width=1, table_itemsize=2,
                        wire_itemsize=2, window={})) is None
    # the old cells still see only their own metrics
    assert "steps_traced" not in {
        m["name"] for m in harness.load_cell("lm1b-zipf", root).per_layer}
    for p, data in before.items():
        assert p.read_bytes() == data, p


def test_a_metric_without_workloads_follows_what_it_moves(tmp_path):
    b = _bench()
    b["per_layer"].append({"name": "x", "unit": "ms", "better": "lower",
                           "source": "device_trace", "layer": "step",
                           "moves": "step_ms_p95"})
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    with_p95 = {w for w in ("lm1b-zipf", "phi3-dense")
                if "x" in {m["name"] for m in
                           harness.load_cell(w, tmp_path).per_layer}}
    assert with_p95 == {"lm1b-zipf"}


def test_a_split_metric_is_read_by_its_base_reader():
    """``device_ms.gemm.mesh`` has no file of its own: ``device_ms.gemm.py``
    reads it; a file of the full name would be read first."""
    base = harness.reader("device_ms.gemm")
    split = harness.reader("device_ms.gemm.mesh")
    assert split.__code__.co_code == base.__code__.co_code
    assert harness.reader("tokens_per_s.mesh").__module__ != \
        harness.reader("device_idle").__module__
