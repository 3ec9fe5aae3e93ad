"""The exchange-contract check on gloo process meshes: the port's
counterparts of the reference's distributed contract tests
(tests/test_analysis.py), held to those tests' own assertions.

The reference's sweeps lower each step on 8 fake devices and parse the
compiled HLO; on JAX 0.9.0 the CPU backend merges the all-reduces they
count, so those four tests fail here. The port checks the record of the
collectives a step issued instead (``core/collectives.py::record``). Its
ranks are processes on the CPU, so the meshes are reduced: (4, 1) in
place of (8, 1), ``ps_gather`` on (2, 2) in place of (2, 4), and the
two-level pod on (2, 2, 1) in place of (2, 4, 1). Rank functions:
tests/_torch_contract_ranks.py.
"""
import pytest

from repro_torch.launch.mesh import spawn

import _torch_contract_ranks as ranks

pytestmark = pytest.mark.distributed


def _sweep(group: str) -> dict:
    res = spawn(ranks.sweep_rank, 4, "gloo", args=(group,), timeout=300)
    assert all(r == res[0] for r in res[1:]), res
    for name, r in res[0].items():
        assert r["findings"] == [], (name, r)
    return res[0]


def test_contract_clean_on_encdec_variants():
    res = _sweep("encdec")
    assert res["no_fused"]["buckets"] >= 2
    assert res["gatherv"]["methods"].get("embed") == "mpi_gatherv"


def test_contract_clean_on_config_zoo():
    res = _sweep("zoo")
    assert res["unbucketed"]["buckets"] == 0
    assert sum(r["buckets"] for r in res.values()) >= 5


def test_contract_clean_on_ps_gather_and_two_level():
    res = _sweep("sparse_pod")
    assert res["ps_gather"]["methods"].get("embed") == "ps_gather"
    # the ps pull's sum over the row shards rides model: outside
    assert res["ps_gather"]["outside"].get("all-reduce", 0) > 0
    assert res["two_level"]["schedules"] == ["two_level"]


def test_contract_flags_seeded_mutations():
    res = spawn(ranks.mutation_rank, 4, "gloo", timeout=300)
    for r in res:
        assert r["buckets"] >= 2, r
        assert r["clean_ov"] == [] and r["clean_base"] == [], r
        assert r["clean_strict"] == [], r
        assert r["overlap_mut"] == ["schedule"], r
        assert "unexpected-collective" in r["extra_ar_mut"], r
        assert "collective-count" in r["extra_ar_mut"], r
        assert r["wire_mut"] == ["wire-dtype"], r


def test_verify_contract_gate_on_build_and_replan():
    """The gate on the build's first step and on a forced replan's, clean;
    a plan whose overlap was flipped after the build fails the gate with
    exactly a schedule finding before the optimizer applies."""
    res = spawn(ranks.gate_rank, 4, "gloo", timeout=300)
    for r in res:
        assert r["rebuilt"] is True, r
        assert r["findings"] == [], r
        assert r["losses_finite"], r
        assert r["flipped"] == ["schedule"], r
        assert r["untouched"] and r["steps"] == [1], r
