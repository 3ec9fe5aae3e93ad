"""The port's benchmarks (repro_torch/benchmarks) on the CPU.

``table1_census``: each architecture's census at its published width
equals the JAX package's ``run_census`` (both analytic; rtol 1e-9).
``table3_transfer`` at V 4,096, E 64, B 16, S 64 on (2, 2) gloo ranks:
each method's recorded bytes a replica within 1 % of the cost model's
formula plus its named terms. ``bucket_exchange`` at its reduced sizes on
4 gloo ranks: the all-reduce bytes equal bucketed or not, the overlap
loss difference 0.0 at f32, and the reference's other structural checks
(the benchmark raises on any of them).
"""
import pytest
import torch

from repro.configs import (ALL_ARCHS, PAPER_ARCHS, SHAPES, RunConfig,
                           get_config)
from repro.core.runtime import Runtime
from repro.core.sparsity import run_census
from repro.models.model import build_model
from repro_torch.benchmarks import bucket_exchange, table1_census
from repro_torch.benchmarks import table3_transfer


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch", ALL_ARCHS + PAPER_ARCHS)
def test_table1_census_matches_reference(arch):
    cfg, shape, rc = get_config(arch), SHAPES["train_4k"], RunConfig()
    c = run_census(build_model(cfg, Runtime(cfg, rc, shape)).specs(), cfg,
                   shape, rc, replicas=table1_census.REPLICAS)
    want = {"dense_M": c.dense_params / 1e6,
            "sparse_M": c.sparse_params / 1e6, "alpha": c.alpha,
            "subset_M": c.alpha * c.sparse_params / 1e6}
    got = table1_census.census_row(arch)
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k] == pytest.approx(v, rel=1e-9), k


@pytest.mark.distributed
def test_table3_recorded_bytes_match_analytic():
    sizes = (4096, 64, 16, 64)
    res = table3_transfer.run(sizes=sizes, mesh=(2, 2), device="cpu")
    assert set(res["cases"]) == set(table3_transfer.CASES)
    for case, r in res["cases"].items():
        held = r["analytic_bytes"] + sum(r["terms"].values())
        assert r["recorded_bytes"] == pytest.approx(held, rel=1e-2), case
        kinds = {(c["kind"], c["dtype"]) for c in r["collectives"]}
        if case in ("ps_gather", "mpi_gatherv"):
            assert ("all-gather", "int32") in kinds, case
            assert ("all-gather", "bfloat16") in kinds, case
        else:
            assert kinds == {("all-reduce", "bfloat16")}, case
        # the push is issued inside the backward, the ps pull before it
        assert any(c["in_backward"] for c in r["collectives"]), case
    assert not res["cases"]["ps"]["terms"]


@pytest.mark.distributed
def test_bucket_exchange_on_four_ranks(tmp_path):
    res = bucket_exchange.main("cpu", out=str(tmp_path / "exchange.json"))
    assert all(res["checks"].values()), res["checks"]
    assert res["bucketed"]["all_reduce_wire_bytes"] == \
        res["per_tensor"]["all_reduce_wire_bytes"]
    assert res["overlap"]["loss_divergence"] == 0.0
    assert (tmp_path / "exchange.json").exists()
