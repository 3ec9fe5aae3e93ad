"""``repro_torch/benchmarks/elastic_remesh.py`` on gloo ranks on the CPU:
its four phases, its checks (the reference bench's), and its record:

* flap: heartbeat attribution from each rank's own beat (its step less
  its time blocked in collectives) names the slow slice though every
  rank's wall time is the slowest's; the slice is evicted, re-admitted
  inside the run at its index on probation, and a control run with the
  same schedule by hand equals the run bit for bit over every step;
* jitter: the stale flip and the drain back, ages within the bound, 0
  violations, a control run with the same flips by hand bit for bit;
* chaos and reprice: the reference bench's asserts (``check``).
"""
import json

import numpy as np
import pytest
import torch

from repro_torch.benchmarks import elastic_remesh as EB

pytestmark = pytest.mark.distributed


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    out = tmp_path_factory.mktemp("elastic") / "torch_elastic.json"
    res = EB.main(["--device", "cpu", "--out", str(out)])   # checks inside
    torch.set_num_threads(n)
    return res, out


def test_benchmark_writes_its_record(bench):
    res, out = bench
    with open(out) as f:
        disk = json.load(f)
    assert disk["device"] == res["device"] == "cpu"
    assert set(disk) >= {"chaos", "reprice", "flap", "jitter"}
    c = res["chaos"]
    assert c["prefix_divergence"] == 0.0 and c["remeshes"] == 1
    assert c["evicted"] == [6, 7]                # data slice 3 of (4, 2)
    assert c["tables_after"]["embed"]["capacity"] != \
        c["tables_before"]["embed"]["capacity"]
    assert (res["reprice"]["method_n4"], res["reprice"]["method_n3"]) == \
        ("allreduce", "mpi_gatherv")


def test_heartbeat_attribution_evicts_the_slow_slot_and_readmits(bench):
    f = bench[0]["flap"]
    e = f["evict_at"]
    assert f["attributed"] == [f["slow_slice"]] == [EB.FLAP["slot"]]
    beats = {int(k): v for k, v in f["heartbeats_at_evict"].items()}
    slow = beats[f["slow_slice"]]
    assert all(slow > 2 * v for s, v in beats.items()
               if s != f["slow_slice"])
    assert f["grid_shrunk"] == [[0, 1], [4, 5], [6, 7]]
    assert f["readmit_at"] == e + EB.FLAP["return_after"]
    assert f["grid_final"] == [[0, 1], [2, 3], [4, 5], [6, 7]]
    assert f["probation"] == f["slow_slice"]
    assert f["remeshes"] == 1 and f["regrows"] == 1
    assert f["equal"] and len(f["losses"]) == EB.FLAP["steps"]
    assert f["tokens_per_s"]["shrunk"] > 2 * f["tokens_per_s"]["straggled"]


def test_jitter_flips_stale_and_drains_back(bench):
    j = bench[0]["jitter"]
    assert j["methods"]["embed"] == "mpi_gatherv"
    assert j["stale_flips"] == 2 and j["evictions"] == 0
    assert j["final_stale_tables"] == []
    assert j["stale_on_at"] < j["stale_off_at"]
    assert 1 <= j["max_staleness_applied"] <= 2 and j["violations"] == 0
    assert all(np.isfinite(j["losses"]))
    assert j["equal"]
