"""The port's replay of ``benchmarks/adaptive_replan.py``
(``repro_torch.benchmarks.adaptive_replan``) against the reference
benchmark's own two phases, both on a (4 data x 2 model) mesh: the port's
on 8 gloo ranks, the reference's on 8 fake XLA devices
(``conftest.distributed_run`` with the benchmark's code strings).

Phase 1 (reduced phi3 at vocab 256, static against adaptive): the plans
before and after, the replan's step, flips, capacities and α, and the
observed α must be equal; the port starts from the reference's init, so
its losses are held to the reference's within the correctness test's bar,
5e-4 + 1e-4·i. Phase 2 (reduced parallax-nmt, two tables, a burst): the
methods, capacities and grown flags at every replan and the final tables
must be equal. The ``dropped`` EMAs are not compared: under the shard_map
exchanges the reference reports replica 0's overflow count where the port
averages the replicas' (ROADMAP Queue 3). ``BENCH_replan.json`` is never
written: ``main`` writes only to the path it is given.
"""
import hashlib
import json
import os

import numpy as np
import pytest

from benchmarks import adaptive_replan as ref_bench
from conftest import distributed_run
from repro.configs import RunConfig, ShapeConfig, get_config, reduced
from repro.core.transform import get_runner as jget_runner
from repro.utils.tree import named_leaves
from repro_torch.benchmarks import adaptive_replan as port_bench

pytestmark = pytest.mark.distributed

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
BENCH = os.path.join(ROOT, "BENCH_replan.json")
TABLE_KEYS = ("method", "capacity", "wire_dtype", "grown", "alpha")


def _digest(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


@pytest.fixture(scope="module")
def reference():
    return {"single_table": distributed_run(ref_bench._CODE, devices=8,
                                            timeout=600),
            "two_table": distributed_run(ref_bench._TWO_TABLE_CODE,
                                         devices=8, timeout=600)}


@pytest.fixture(scope="module")
def port():
    """The port's replay on the CPU, phase 1 from the reference's init."""
    before = _digest(BENCH)
    cfg = reduced(get_config("phi3-medium-14b"), vocab=256)
    jr = jget_runner(cfg, ShapeConfig("bench", 32, 8, "train"),
                     RunConfig(**port_bench.SINGLE_KW), seed=0)
    named = {n: np.asarray(a) for n, a in named_leaves(jr.state.params)}
    res = port_bench.run("cpu", params=named, timeout=400)
    assert _digest(BENCH) == before
    return res


def test_single_table_phase_equals_reference(reference, port):
    want, got = reference["single_table"], port["single_table"]
    for k in ("local_tokens", "vocab", "alpha_uniform",
              "alpha_zipf_analytic"):
        assert got[k] == want[k], k
    for run in ("static", "adaptive"):
        for k in ("before", "after", "replan", "observed_alpha"):
            assert got[run][k] == want[run][k], (run, k)
        for i, (a, b) in enumerate(zip(got[run]["losses"],
                                       want[run]["losses"])):
            assert abs(a - b) < 5e-4 + 1e-4 * i, (run, i)
    assert got["adaptive"]["replan"]["flips"] == [["embed", "ps",
                                                   "ps_gather"]]
    assert got["max_loss_divergence"] < 5e-3


def _trajectory(res: dict) -> list:
    return [(p["step"], p["replanned"], p.get("capacity_grown"),
             {t: {k: e[k] for k in TABLE_KEYS}
              for t, e in p["tables"].items()})
            for p in res["trajectory"]]


def test_two_table_phase_equals_reference(reference, port):
    want, got = reference["two_table"], port["two_table"]
    assert _trajectory(got) == _trajectory(want)
    assert {t: {k: e[k] for k in TABLE_KEYS}
            for t, e in got["final_tables"].items()} == \
        {t: {k: e[k] for k in TABLE_KEYS}
         for t, e in want["final_tables"].items()}
    assert all(np.isfinite(got["losses"]))


def test_main_checks_and_writes_only_its_out(port, tmp_path, monkeypatch,
                                             capsys):
    """``main`` runs the reference benchmark's checks on the replay and
    writes the record to ``--out``; BENCH_replan.json stays as it is."""
    before = _digest(BENCH)
    monkeypatch.setattr(port_bench, "run", lambda device: port)
    out = tmp_path / "replan.json"
    port_bench.main(["--device", "cpu", "--out", str(out)])
    assert json.loads(out.read_text())["two_table"]["final_tables"] == \
        port["two_table"]["final_tables"]
    assert "OK: replan changed the plan" in capsys.readouterr().out
    assert _digest(BENCH) == before
    # the checks bite: a replay whose adaptive run never replanned fails
    broken = json.loads(json.dumps(port))
    broken["single_table"]["adaptive"]["replan"] = None
    with pytest.raises(AssertionError, match="never replanned"):
        port_bench.check(broken)
