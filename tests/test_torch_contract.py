"""The port's exchange-contract check and lint (repro_torch/analysis)
against the JAX package's.

The hand-built scenarios of the reference's tests/test_analysis.py: the
same plan in both packages; the reference checks its canned scheduled HLO
and the port the same scenario as a record of collectives (ops before the
reference's last dot-bearing loop are the ones issued inside the
backward), and the finding kinds agree. ``Plan.exchange_contract()``
agrees key for key on the plans of the reference's sweep scenarios,
planned on ``MeshShape``s against the reference's hardware record (the
buckets without the reference's overlap=False pin elements: the port has
no pin, ROADMAP Queue 3). ``wire_bytes`` applies the reference's ring
factors. A recorded step equals an unrecorded one bit for bit (gloo
ranks). Each lint rule flags its seeded fixture once, and the port's
tree is clean.
"""
import json
import math

import numpy as np
import pytest
import torch

from conftest import distributed_run
from repro.analysis.contract import check_contract as jax_check
from repro.core.buckets import Bucket as JBucket, BucketPlan as JBucketPlan
from repro.core.plan import ParamPlan as JParamPlan, Plan as JPlan
from repro.utils import hlo as jhlo
from repro.utils import roofline as jroof
import repro_torch.configs as tc
from repro_torch.analysis import lint_file, lint_repo
from repro_torch.analysis.contract import check_contract
from repro_torch.core import collectives as coll
from repro_torch.core import cost_model as tcm
from repro_torch.core.buckets import Bucket, BucketPlan
from repro_torch.core.plan import ParamPlan, Plan
from repro_torch.core.runtime import Runtime
from repro_torch.core.transform import analyze
from repro_torch.launch.mesh import MeshShape, spawn
from repro_torch.models.model import build_model
from repro_torch.utils import roofline as troof

import _torch_contract_ranks as ranks


# ---------------------------------------------------------------------------
# hand-built scenarios: the reference's canned HLO against the port's record
# ---------------------------------------------------------------------------

_PRE = """HloModule m, is_scheduled=true

%body (c: f32[8,8]) -> f32[8,8] {
  %c = f32[8,8]{1,0} parameter(0)
  ROOT %d = f32[8,8]{1,0} dot(%c, %c), lhs_contracting_dims={1}, rhs_contracting_dims={0}
}

%cond (c: f32[8,8]) -> pred[] {
  %c = f32[8,8]{1,0} parameter(0)
  ROOT %q = pred[] constant(false)
}

ENTRY %main (p0: f32[8,8]) -> f32[8,8] {
  %p0 = f32[8,8]{1,0} parameter(0)
"""
_LOOP = "  %w = f32[8,8]{1,0} while(%p0), condition=%cond, body=%body\n"
_POST = "  ROOT %out = f32[8,8]{1,0} copy(%w)\n}\n"
# the fused metrics all-reduce both plans expect, after the backward
_SCALAR = ("all-reduce", 5, "float32", False)
_HLO_DTYPE = {"float32": "f32", "bfloat16": "bf16"}


def _op(i: int, kind: str, elems: int, dtype: str) -> str:
    t = f"{_HLO_DTYPE[dtype]}[{elems}]{{0}}"
    tail = {"all-reduce": "to_apply=%add", "reduce-scatter": "to_apply=%add",
            "all-gather": "dimensions={0}"}[kind]
    return (f"  %c{i} = {t} {kind}(%p0), replica_groups={{{{0,1}}}}, "
            f"{tail}\n")


def _hlo(ops: list) -> str:
    """Canned scheduled HLO: the ops issued inside the backward before the
    last dot-bearing loop, the others after it."""
    early = "".join(_op(i, k, n, d) for i, (k, n, d, b) in enumerate(ops)
                    if b)
    late = "".join(_op(i, k, n, d) for i, (k, n, d, b) in enumerate(ops)
                   if not b)
    return _PRE + early + _LOOP + late + _POST


def _record(ops: list, group: int) -> list:
    itemsize = {"float32": 4, "bfloat16": 2}
    return [coll.Event(seq=i, kind=k, axes=("data",), group=group,
                       elems=n, dtype=d, bytes=n * itemsize[d], op="sum",
                       in_backward=b)
            for i, (k, n, d, b) in enumerate(ops)]


def _plans(buckets, *, overlap=True, replicas=2, hosts=1, n_leaves=2):
    """The same hand-built plan in both packages: ``buckets`` as (elems,
    wire dtype, schedule)."""
    jb = [JBucket(key=("allreduce", d, ()), idx=(0,), sizes=(n,),
                  nbytes=n * 4, schedule=s) for n, d, s in buckets]
    tb = [Bucket(key=("allreduce", d, ()), idx=(0,), sizes=(n,),
                 nbytes=n * 4, schedule=s) for n, d, s in buckets]
    common = dict(batch_axes=("data",), replicas=replicas,
                  n_params=len(buckets), wire_bytes=sum(n * 4 for n, _, _
                                                        in buckets),
                  bucket_bytes=1 << 20, hosts=hosts, overlap=overlap)
    jplan = JPlan(model_cfg=None, run_cfg=None, shape_cfg=None, mesh=None,
                  rules=None,
                  params=[JParamPlan(f"p{i}", "allreduce", None, None,
                                     "float32", False, 4)
                          for i in range(n_leaves)],
                  bucket_plan=JBucketPlan(buckets=jb, **common))
    tplan = Plan(model_cfg=None, run_cfg=None, shape_cfg=None,
                 params={f"p{i}": ParamPlan(f"p{i}", "allreduce", (), (),
                                            torch.float32, False, 4)
                         for i in range(n_leaves)},
                 bucket_plan=BucketPlan(buckets=tb, **common))
    return jplan, tplan


_AR = lambda n, early=True, d="float32": ("all-reduce", n, d, early)
# name -> (buckets, plan knobs, ops, strict_dtype)
SCENARIOS = {
    "clean_ring": ([(8192, "float32", "ring")], {}, [_AR(8192)], False),
    "missing_bucket": ([(8192, "float32", "ring")], {}, [], False),
    "extra_per_param": ([(8192, "float32", "ring")], {},
                        [_AR(8192), _AR(9000)], False),
    "overlap_mismatch": ([(8192, "float32", "ring")], {"overlap": False},
                         [_AR(8192)], False),
    "late_buckets": ([(4096, "float32", "ring"), (6144, "float32", "ring")],
                     {}, [_AR(4096, False), _AR(6144, False)], False),
    "early_first_bucket": ([(4096, "float32", "ring"),
                            (6144, "float32", "ring")], {},
                           [_AR(4096), _AR(6144, False)], False),
    "two_level_triple": ([(8192, "float32", "two_level")],
                         {"replicas": 4, "hosts": 2},
                         [("reduce-scatter", 4096, "float32", True),
                          _AR(4096), ("all-gather", 8192, "float32", True)],
                         False),
    "two_level_no_inter_hop": ([(8192, "float32", "two_level")],
                               {"replicas": 4, "hosts": 2}, [_AR(4096)],
                               False),
    "wire_dtype_loose": ([(8192, "bfloat16", "ring")], {}, [_AR(8192)],
                         False),
    "wire_dtype_strict": ([(8192, "bfloat16", "ring")], {}, [_AR(8192)],
                          True),
    "unfused_scalars": ([(8192, "float32", "ring")], {},
                        [_AR(8192), ("all-reduce", 3, "float32", False)],
                        False),
}
# the reference's own assertions on these scenarios (tests/test_analysis.py)
WANT = {"clean_ring": set(), "missing_bucket": {"missing-collective"},
        "overlap_mismatch": {"schedule"}, "late_buckets": {"schedule"},
        "early_first_bucket": set(), "two_level_triple": set(),
        "wire_dtype_loose": set(), "wire_dtype_strict": {"wire-dtype"},
        "unfused_scalars": {"unfused-scalars", "collective-count"}}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_contract_kinds_match_the_reference(name):
    buckets, knobs, ops, strict = SCENARIOS[name]
    ops = ops + [_SCALAR]
    jplan, tplan = _plans(buckets, **knobs)
    want = {f.kind for f in jax_check(jplan, _hlo(ops),
                                      strict_dtype=strict)}
    got = check_contract(tplan, _record(ops, knobs.get("replicas", 2)),
                         strict_dtype=strict)
    assert {f.kind for f in got} == want, [str(f) for f in got]
    if name in WANT:
        assert want == WANT[name], want
    if name == "extra_per_param":
        assert {"unexpected-collective", "collective-count"} <= want
    if name == "two_level_no_inter_hop":
        assert "missing-collective" in want


def test_contract_leaves_model_axis_traffic_outside():
    """Collectives over ``model`` alone (tensor-parallel traffic) are not
    in the pool: a clean bucket step with 3 of them beside it is clean,
    and the check counts them by kind."""
    _, tplan = _plans([(8192, "float32", "ring")])
    rec = _record([_AR(8192), _SCALAR], 2)
    rec += [coll.Event(seq=10 + i, kind=k, axes=("model",), group=2,
                       elems=9000, dtype="float32", bytes=36000)
            for i, k in enumerate(("all-reduce", "all-reduce",
                                   "all-gather"))]
    got = check_contract(tplan, rec)
    assert got == [] and got.outside == {"all-reduce": 2, "all-gather": 1}


# ---------------------------------------------------------------------------
# the wire bytes: the reference's ring factors
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["all-reduce", "all-gather",
                                  "reduce-scatter", "all-to-all"])
def test_wire_bytes_match_ring_factor(kind):
    for n in range(1, 9):
        ev = coll.Event(seq=0, kind=kind, axes=("data",), group=n,
                        elems=1000, dtype="bfloat16", bytes=2000)
        assert coll.wire_bytes(ev) == pytest.approx(
            2000 * jhlo._ring_factor(kind, n), rel=1e-15)


# ---------------------------------------------------------------------------
# exchange_contract() on the sweep scenarios' plans
# ---------------------------------------------------------------------------

# (mesh shape, axes, arch, knobs): the reference sweeps' plans, on its
# meshes (no process group: planning reads only the specs)
CONTRACT_CASES = {
    **{f"zoo-{a}": ((8, 1), ("data", "model"), a, {}) for a in ranks.ZOO},
    "zoo-unbucketed": ((8, 1), ("data", "model"), "phi3-medium-14b",
                       {"bucket_bytes": 0}),
    "encdec-default": ((8, 1), ("data", "model"), ranks.ENCDEC, {}),
    "encdec-no_overlap": ((8, 1), ("data", "model"), ranks.ENCDEC,
                          {"overlap": False}),
    "encdec-no_fused": ((8, 1), ("data", "model"), ranks.ENCDEC,
                        {"fused_apply": False, "bucket_bytes": 256 * 1024}),
    "encdec-gatherv": ((8, 1), ("data", "model"), ranks.ENCDEC,
                       {"comm_mode": "mpi", "bucket_bytes": 256 * 1024}),
    "ps_gather": ((2, 4), ("data", "model"), "phi3-medium-14b",
                  {"comm_mode": "ps", "hw_profile": "fast",
                   "table_alpha": (("embed", 0.01),)}),
    "two_level": ((2, 4, 1), ("pod", "data", "model"), ranks.ENCDEC,
                  {"hw_profile": "pod", "bucket_bytes": 1024 * 1024}),
}
BUDGET = 0.9 * jroof.HW.hbm_bytes

_REF = """
from repro.configs import get_config, reduced, RunConfig, ShapeConfig
from repro.core.runtime import Runtime
from repro.core.transform import analyze
from repro.models.model import build_model

out = {{}}
for key, (shp, axes, arch, kw) in {cases}.items():
    cfg = reduced(get_config(arch))
    mesh = make_mesh(tuple(shp), tuple(axes))
    rt = Runtime(cfg, RunConfig(**kw), ShapeConfig("tiny", 32, 8, "train"),
                 mesh=mesh)
    plan = analyze(build_model(cfg, rt), rt, memory_budget={budget})
    c = plan.exchange_contract()
    bp = plan.bucket_plan
    # the collectives without the overlap=False pin elements
    c["buckets_unpinned"] = bp.expected_collectives(0) if bp else []
    out[key] = c
print("RESULT:" + json.dumps(out))
"""


def _profiles(tmp_path) -> dict:
    paths = {}
    for name, prof in (("fast", ranks.HW_FAST), ("pod", ranks.HW_POD)):
        paths[name] = str(tmp_path / f"{name}.json")
        with open(paths[name], "w") as f:
            json.dump(prof, f)
    return paths


def _knobs(kw: dict, paths: dict) -> dict:
    kw = dict(ranks.BASE, **kw)
    if "hw_profile" in kw:
        kw["hw_profile"] = paths[kw["hw_profile"]]
    return kw


@pytest.fixture(scope="module")
def reference_contracts(tmp_path_factory):
    paths = _profiles(tmp_path_factory.mktemp("hw"))
    cases = {k: (shp, axes, arch, _knobs(kw, paths))
             for k, (shp, axes, arch, kw) in CONTRACT_CASES.items()}
    return paths, distributed_run(
        _REF.format(cases=repr(cases), budget=BUDGET), devices=8,
        timeout=600)


def _tpu_hw_for_port():
    h = jroof.HW
    return troof.Hardware(name=h.name, peak_flops=h.peak_flops,
                          hbm_bw=h.hbm_bw, link_bw=h.link_bw,
                          hbm_bytes=h.hbm_bytes, smem_bytes=h.vmem_bytes,
                          link_latency=h.link_latency,
                          inter_bw=h.inter_bw,
                          inter_latency=h.inter_latency)


@pytest.mark.distributed
@pytest.mark.parametrize("case", list(CONTRACT_CASES))
def test_exchange_contract_matches_reference(reference_contracts,
                                             monkeypatch, case):
    paths, ref = reference_contracts
    want = dict(ref[case])
    unpinned = want.pop("buckets_unpinned")
    monkeypatch.setattr(tcm, "HW", _tpu_hw_for_port())
    shp, axes, arch, kw = CONTRACT_CASES[case]
    cfg = tc.reduced(tc.get_config(arch))
    rt = Runtime(cfg, tc.RunConfig(**_knobs(kw, paths)),
                 tc.ShapeConfig("tiny", 32, 8, "train"),
                 mesh=MeshShape(shp, axes), device="cpu")
    got = json.loads(json.dumps(
        analyze(build_model(cfg, rt), rt,
                memory_budget=BUDGET).exchange_contract()))
    # the port has no pin: its buckets are the reference's without it,
    # which are the reference's own wherever overlap is on
    assert got["buckets"] == unpinned
    if want["overlap"] or not want["bucketed"]:
        assert want["buckets"] == unpinned
    got.pop("buckets"), want.pop("buckets")
    assert got == want
    if case == "two_level":
        assert [b["schedule"] for b in unpinned] == ["two_level"]


# ---------------------------------------------------------------------------
# a recorded step is the unrecorded step, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.distributed
def test_recorded_step_is_bit_equal():
    res = spawn(ranks.bitwise_rank, 4, "gloo", timeout=300)
    for r in res:
        for shp in ("(2, 2)", "(4, 1)"):
            off, on = r[f"{shp}-False"], r[f"{shp}-True"]
            assert len(off["losses"]) == 2 and on["leaves"].keys() == \
                off["leaves"].keys()
            for k in ("losses", "norms"):
                assert all(np.array_equal(a, b)
                           for a, b in zip(on[k], off[k])), (shp, k)
            for n, a in off["leaves"].items():
                assert np.array_equal(on["leaves"][n], a), (shp, n)


# ---------------------------------------------------------------------------
# lint
# ---------------------------------------------------------------------------

_CLEAN_CONFIG = "from dataclasses import dataclass\n\n\n@dataclass\n" \
    "class RunConfig:\n    table_alpha: tuple = ()\n"
LINT_FIXTURES = {
    "raw-collective": ("bad_dist.py", "import torch\nimport torch." +
                       "distributed as dist\n\n\ndef f(x):\n"
                       "    dist.all_reduce(x)\n"),
    "unhashable-config-field": ("bad_runconfig.py", _CLEAN_CONFIG
                                + "    tables: list = None\n"),
}


@pytest.mark.parametrize("kind", list(LINT_FIXTURES))
def test_lint_fixture_single_finding(tmp_path, kind):
    name, text = LINT_FIXTURES[kind]
    path = tmp_path / name
    path.write_text(text)
    findings = lint_file(str(path), str(tmp_path))
    assert len(findings) == 1, [str(f) for f in findings]
    assert findings[0].kind == kind and name in findings[0].where
    clean = tmp_path / "clean.py"
    clean.write_text(_CLEAN_CONFIG)
    assert lint_file(str(clean), str(tmp_path)) == []


def test_lint_repo_clean():
    findings = lint_repo()
    assert findings == [], "\n".join(str(f) for f in findings)


def test_verify_contract_on_one_device():
    """``verify_contract`` is ported: one device builds and steps under the
    gate (no collective, nothing to contract), and ``check_contract``
    leaves the state as it was."""
    from repro_torch.core.transform import get_runner
    from repro_torch.data import SyntheticLM
    cfg = tc.reduced(tc.get_config("parallax-lm"))
    r = get_runner(cfg, tc.ShapeConfig("t", 8, 2, "train"),
                   tc.RunConfig(verify_contract=True), device="cpu")
    ds = SyntheticLM(cfg.vocab_size, 8, 2)
    assert math.isfinite(float(r.run(ds.batch(0))["loss"]))
    before = {n: t.detach().clone() for n, t in r.state.params.items()}
    assert r.check_contract(ds.batch(1), strict_dtype=True) == []
    assert r.live_state.step == 1
    assert all(torch.equal(before[n], t) for n, t in r.state.params.items())
