"""The port's dry-run (launch/dryrun.py on a record-only mesh) and the
modules under it, against the JAX package where it has a counterpart.

``utils/traffic.py::estimate_traffic`` equals the reference's exactly (the
same arithmetic) for every arch, its shapes, (cards, model shards) in
{(256, 16), (512, 16), (16, 4)}, every remat and ZeRO stage;
``RooflineTerms`` fed the same inputs keeps the reference's per-card
fields and useful-FLOPs fraction; ``make_production_mesh`` gives the
reference's shapes and axes (the reference's on 512 fake devices).

The record-only mesh: rank 0's record of one step on a (2, 2) gloo mesh
equals the dry step's on meta event for event, in issue order (kind,
axes, group, elements, dtype, reduction, inside the backward or not) for
reduced parallax-lm (hybrid), parallax-nmt (two tables) and phi3
(tensor-parallel over ``model``). The dry FLOPs are within 5 % of the
reference's ``analyze_hlo(...).dot_flops`` on (2, 2) (4 fake devices) for
reduced parallax-lm and phi3, after one term that differs by design is
taken out: the port computes phi3's K/V projections whole on every model
rank (``kv_replicated``, ROADMAP Queue 3), the reference shards them by
KV head. At (16, 16) ``train_4k`` the dry-run's plan fields equal the
reference's ``analyze`` under the reference's hardware record for
parallax-lm, parallax-nmt and phi3; the contract is clean on the three
and each Table-4 stage's recorded bytes over the batch axes equal the
cost model plus its named terms within 1e-3 — those steps at a 256-token
sequence in place of 4,096 (the dry step's host time is linear in the
sequence; the contract and the byte accounting read the plan, which is
the same).

The counting mode and the tracker: ``DryCount``'s FLOPs equal
``FlopCounterMode``'s on a reduced step; the peak tracker holds on a
hand-built sequence of allocations and frees, saved tensors included;
the kernels on meta count their operations (wkv's chunk products).
"""
import json

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from conftest import distributed_run
from repro.configs import ALL_ARCHS as J_ARCHS
from repro.configs import PAPER_ARCHS as J_PAPER
from repro.configs import SHAPES as J_SHAPES
from repro.configs import get_config as jget_config
from repro.configs import shapes_for as jshapes_for
from repro.utils import roofline as jroof
from repro.utils.traffic import estimate_traffic as jestimate
import repro_torch.configs as tc
from repro_torch.benchmarks import roofline_table, table4_ablation
from repro_torch.core import collectives as coll
from repro_torch.core import cost_model as tcm
from repro_torch.core.transform import get_runner
from repro_torch.kernels import ops
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import DryMesh, MeshShape, make_production_mesh
from repro_torch.utils import roofline as troof
from repro_torch.utils.traffic import estimate_traffic
from repro_torch.utils.tree import leaf_bytes, named_leaves, tree_bytes

import _torch_dryrun_ranks as R
from test_torch_mesh_plan import _tpu_hw_for_port

PRODUCTION = (16, 16)
AXES = ("data", "model")
SMALL = tc.ShapeConfig("tiny", 32, 8, "train")
# the (16, 16) steps' sequence (train_4k's batch of 256)
CUT = tc.ShapeConfig("train_4k_cut", 256, 256, "train")
TWO_TABLE = dict(capacity_mode="capped", capacity_factor=1.5,
                 link_latency=0.0, table_zipf=(("embed", 1.3),),
                 table_alpha=(("enc_embed", 0.99),))
RECORD_CASES = {
    "parallax-lm": (lambda: tc.reduced(tc.get_config("parallax-lm")), {},
                    False),
    "parallax-nmt": (lambda: tc.reduced(tc.get_config("parallax-nmt"),
                                        vocab=256), TWO_TABLE, True),
    "phi3-medium-14b": (lambda: tc.reduced(
        tc.get_config("phi3-medium-14b")), {}, False),
}
PLAN_ARCHS = ("parallax-lm", "parallax-nmt", "phi3-medium-14b")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# traffic, roofline, production mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", J_ARCHS + J_PAPER)
def test_estimate_traffic_equals_reference(arch):
    jcfg, tcfg = jget_config(arch), tc.get_config(arch)
    n = 0
    for shape in jshapes_for(arch):
        for chips, shards in ((256, 16), (512, 16), (16, 4)):
            for remat in ("none", "block", "full"):
                for zero in (0, 1, 3):
                    want = jestimate(jcfg, J_SHAPES[shape], chips=chips,
                                     model_shards=shards, remat=remat,
                                     zero_stage=zero).to_dict()
                    got = estimate_traffic(
                        tcfg, tc.SHAPES[shape], chips=chips,
                        model_shards=shards, remat=remat,
                        zero_stage=zero).to_dict()
                    assert got == want, (shape, chips, shards, remat, zero)
                    n += 1
    assert n >= 81


@pytest.mark.parametrize("model_flops,peak", [(5.2e15, 2.7e10), (0.0, 0.0),
                                              (1.3e18, 7.9e10)])
def test_roofline_terms_keep_reference_fields(model_flops, peak):
    kw = dict(arch="a", shape="s", mesh="16x16", chips=256,
              cost={"flops": 1.03e13, "bytes accessed": 2.9e10},
              collective_bytes=8.2e8, model_flops_global=model_flops,
              peak_memory=peak, collective_breakdown={"x": 1})
    want, got = (jroof.roofline_from_analysis(**kw),
                 troof.roofline_from_analysis(**kw))
    for f in ("per_chip_flops", "per_chip_hbm_bytes",
              "per_chip_collective_bytes", "model_flops_global",
              "per_chip_peak_memory", "chips", "collective_breakdown"):
        assert getattr(got, f) == getattr(want, f), f
    assert got.useful_flops_fraction == want.useful_flops_fraction
    # the times are the H100 record's
    hw = troof.HW
    assert got.compute_s == 1.03e13 / hw.peak_flops
    assert got.memory_s == 2.9e10 / hw.hbm_bw
    assert got.collective_s == 8.2e8 / hw.link_bw
    assert got.bound_s == max(got.compute_s, got.memory_s, got.collective_s)
    d = got.to_dict()
    assert set(want.to_dict()) <= set(d) and d["bound_s"] == got.bound_s


@pytest.mark.distributed
def test_production_mesh_matches_reference():
    want = distributed_run("""
from repro.launch.mesh import make_production_mesh
out = {}
for mp in (False, True):
    m = make_production_mesh(multi_pod=mp)
    out[str(mp)] = [list(m.axis_names), [m.shape[a] for a in m.axis_names]]
print("RESULT:" + json.dumps(out))
""", devices=512)
    for mp in (False, True):
        got = make_production_mesh(multi_pod=mp)
        assert type(got) is MeshShape
        assert [list(got.axis_names),
                [got.shape[a] for a in got.axis_names]] == want[str(mp)]


def test_tree_byte_helpers():
    t = {"b": torch.empty((3, 4), dtype=torch.bfloat16, device="meta"),
         "a": [torch.zeros(2), 5]}
    assert [n for n, _ in named_leaves(t)] == ["a.0", "a.1", "b"]
    assert tree_bytes(t) == 3 * 4 * 2 + 2 * 4 + 4
    assert leaf_bytes(np.zeros(3, np.float64)) == 24


# ---------------------------------------------------------------------------
# the record-only mesh
# ---------------------------------------------------------------------------

def test_dry_mesh_acts_as_rank_zero_and_is_refused_by_get_runner():
    mesh = DryMesh((2, 4), AXES)
    assert mesh.coords == {"data": 0, "model": 0} and mesh.rank == 0
    assert mesh.group("data").size == 2 and mesh.group(AXES).size == 8
    assert mesh.index(AXES) == 0
    x = torch.empty((4, 3), device="meta", dtype=torch.bfloat16)
    with coll.record() as rec:
        s = coll.all_reduce(x, "model", mesh)
        g = coll.all_gather(x, "data", mesh, dim=1)
        r = coll.reduce_scatter(x, "model", mesh)
        w = coll.all_reduce_async(x.clone(), AXES, mesh)
        w.wait()
    assert tuple(s.shape) == (4, 3) and tuple(g.shape) == (4, 6)
    assert tuple(r.shape) == (1, 3) and g.dtype == torch.bfloat16
    assert [(e.kind, e.axes, e.group, e.elems) for e in rec.events] == [
        ("all-reduce", ("model",), 4, 12), ("all-gather", ("data",), 2, 24),
        ("reduce-scatter", ("model",), 4, 3),
        ("all-reduce", AXES, 8, 12)]
    with pytest.raises(ValueError, match="record-only"):
        get_runner(tc.reduced(tc.get_config("parallax-lm")), SMALL,
                   tc.RunConfig(), mesh=mesh, device="cpu")


@pytest.mark.distributed
@pytest.mark.parametrize("arch", list(RECORD_CASES))
def test_dry_record_equals_gloo_record(arch):
    """In issue order: the overlapped buckets' all-reduces come from
    autograd's hooks, whose order is fixed for one graph, and both steps
    run the same graph."""
    from repro_torch.launch.mesh import spawn
    make, kw, encdec = RECORD_CASES[arch]
    real = spawn(R.record_rank, 4, "gloo",
                 args=(make(), SMALL, kw, encdec))[0]
    model, rt, plan, opt = dryrun.build_cell(
        make(), SMALL, tc.RunConfig(**kw), DryMesh((2, 2), AXES))
    dry = dryrun.dry_step(model, rt, plan, opt)
    got = [R.event_key(ev) for ev in dry.record.events]
    assert len(got) > 10
    assert got == real


@pytest.fixture(scope="module")
def reference_dot_flops():
    return distributed_run("""
from repro.configs import RunConfig, ShapeConfig, get_config, reduced
from repro.core.runtime import Runtime
from repro.core.transform import (analyze, batch_shardings,
                                  make_train_step, state_shardings)
from repro.models.model import build_model
from repro.optim.optimizer import make_optimizer
from repro.utils.hlo import analyze_hlo
out = {}
for arch in ("parallax-lm", "phi3-medium-14b"):
    cfg = reduced(get_config(arch))
    shape = ShapeConfig("tiny", 32, 8, "train")
    mesh = make_mesh((2, 2), ("data", "model"))
    rt = Runtime(cfg, RunConfig(), shape, mesh=mesh)
    model = build_model(cfg, rt)
    plan = analyze(model, rt)
    rt.plan = plan
    opt = make_optimizer(rt)
    step = make_train_step(model, opt, rt, plan)
    state = jax.eval_shape(opt.init, model.abstract_params())
    sh = state_shardings(plan, state)
    bs = batch_shardings(plan, model.input_specs(shape))
    with use_mesh(mesh):
        compiled = jax.jit(step, in_shardings=(sh, bs),
                           out_shardings=(sh, None), donate_argnums=0
                           ).lower(state, model.input_specs(shape)).compile()
    out[arch] = analyze_hlo(compiled.as_text()).dot_flops
print("RESULT:" + json.dumps(out))
""", devices=4)


def _kv_replicated(cfg, rt) -> float:
    """The K/V projections' operations the port runs on every model rank
    and the reference shards by KV head: (M - 1) / M of 6 · tokens ·
    d · 2 · kv_dim a layer (forward, and the backward's two products)."""
    if not cfg.n_heads:
        return 0.0
    m = rt.model_size
    tokens = rt.shape_cfg.tokens // rt.replicas
    return (m - 1) / m * 6 * tokens * cfg.d_model * 2 * cfg.kv_dim \
        * cfg.n_layers


@pytest.mark.distributed
@pytest.mark.parametrize("arch", ["parallax-lm", "phi3-medium-14b"])
def test_dry_flops_match_reference_hlo(reference_dot_flops, arch):
    cfg = tc.reduced(tc.get_config(arch))
    model, rt, plan, opt = dryrun.build_cell(cfg, SMALL, tc.RunConfig(),
                                             DryMesh((2, 2), AXES))
    dry = dryrun.dry_step(model, rt, plan, opt)
    want = reference_dot_flops[arch]
    got = dry.flops - _kv_replicated(cfg, rt)
    assert got == pytest.approx(want, rel=0.05)


@pytest.fixture(scope="module")
def reference_production_plans():
    return distributed_run("""
from repro.configs import RunConfig, SHAPES, get_config
from repro.core.runtime import Runtime
from repro.core.transform import analyze
from repro.launch.mesh import make_production_mesh
from repro.models.model import build_model
out = {}
mesh = make_production_mesh()
for arch in %r:
    cfg = get_config(arch)
    rt = Runtime(cfg, RunConfig(), SHAPES["train_4k"], mesh=mesh)
    model = build_model(cfg, rt)
    plan = analyze(model, rt)
    out[arch] = {"alpha": plan.alpha, "capacity": plan.capacity,
                 "embed_method": plan.embed_method,
                 "zero_stage": plan.zero_stage, "methods": plan.methods(),
                 "tables": plan.tables(), "census": plan.census()}
print("RESULT:" + json.dumps(out))
""" % (PLAN_ARCHS,), devices=256)


@pytest.mark.distributed
@pytest.mark.parametrize("arch", PLAN_ARCHS)
def test_production_plan_equals_reference(reference_production_plans,
                                          monkeypatch, arch):
    monkeypatch.setattr(tcm, "HW", _tpu_hw_for_port())
    _, _, plan, _ = dryrun.build_cell(
        tc.get_config(arch), tc.SHAPES["train_4k"], tc.RunConfig(),
        DryMesh(PRODUCTION, AXES))
    got = json.loads(json.dumps(dryrun.plan_summary(plan)))
    assert got == reference_production_plans[arch]


@pytest.mark.parametrize("arch", PLAN_ARCHS)
def test_contract_clean_on_production_mesh(arch):
    res = dryrun.run_cell(arch, CUT, run_cfg=tc.RunConfig(), verbose=False)
    assert res["ok"], res.get("error") or res["contract"]
    assert res["contract"]["findings"] == [] and res["chips"] == 256
    assert res["record"]["collective_count"] > 0
    assert res["record"]["dot_flops"] == res["flop_count"]["flops"] > 0


def test_table4_stage_bytes_match_cost_model():
    out = table4_ablation.ablation(workers=1, shape=CUT)
    for arch, rows in out.items():
        assert list(rows) == [s for s, _ in table4_ablation.STAGES]
        for stage, r in rows.items():
            acc = r["batch_axis_bytes"]
            held = acc["formula"] + sum(acc["terms"].values())
            assert acc["recorded"] == pytest.approx(held, rel=1e-3), \
                (arch, stage)
        # OPSW halves the f32 push of the sparse table: fewer bytes
        assert rows["+OPSW"]["collective_GB"] < rows["BASE"]["collective_GB"]
    assert "tied_head" in out["command-r-35b"]["BASE"]["batch_axis_bytes"][
        "terms"]


def test_dryrun_cli_and_roofline_table(tmp_path, capsys):
    with pytest.raises(SystemExit) as ex:
        dryrun.main(["--arch", "parallax-lm", "--shape", "train_4k",
                     "--out", str(tmp_path)])
    assert ex.value.code == 0
    res = json.loads((tmp_path / "parallax-lm__train_4k__16x16.json")
                     .read_text())
    assert res["ok"] and res["contract"]["findings"] == []
    for key in ("arch", "shape", "mesh", "chips", "compile_s",
                "memory_analysis", "traffic", "plan", "roofline",
                "run_cfg", "record", "flop_count"):
        assert key in res, key
    assert res["memory_analysis"]["peak_bytes"] > \
        res["memory_analysis"]["argument_bytes"] > 0
    assert res["roofline"]["dominant"] in ("compute", "memory",
                                           "collective")
    capsys.readouterr()
    roofline_table.main("cpu", out_dir=str(tmp_path))
    line = capsys.readouterr().out
    assert line.startswith("roofline/parallax-lm/train_4k/16x16,")
    assert "device=host" in line
    assert "| parallax-lm | train_4k | 16x16 |" in \
        roofline_table.markdown(out_dir=str(tmp_path))


# ---------------------------------------------------------------------------
# the counting mode, the tracker and the kernels on meta
# ---------------------------------------------------------------------------

def _reduced_cell():
    return dryrun.build_cell(tc.reduced(tc.get_config("phi3-medium-14b")),
                             SMALL, tc.RunConfig(), DryMesh((2, 2), AXES))


def test_dry_count_equals_flop_counter_mode():
    counts = []
    for mode in ("flop_counter", "dry"):
        model, rt, plan, opt = _reduced_cell()
        fn, inputs = dryrun._step_and_inputs(model, rt, plan, opt)
        if mode == "dry":
            with dryrun.DryCount() as c:
                fn(*inputs)
            counts.append(c.flops)
        else:
            with FlopCounterMode(display=False) as c:
                fn(*inputs)
            counts.append(c.get_total_flops())
    assert counts[0] == counts[1] > 0


def test_peak_tracker_holds_on_a_hand_built_sequence():
    """Allocations and frees, a view keeping its storage alive, and a
    tensor autograd saves outliving every Python reference to it."""
    mb = 1 << 20
    tr = dryrun.PeakTracker()
    with dryrun.DryCount(tr):
        a = torch.empty(mb // 4, device="meta")              # 1 MiB
        b = a + 1                                            # 2 MiB live
        del a
        assert tr.live == mb
        c = torch.empty(2 * mb // 4, device="meta")         # 3 MiB live
        v = c[:10]
        del c
        assert tr.live == 3 * mb                             # v holds c
        del v
        assert tr.live == mb
        x = torch.empty(mb // 4, device="meta", requires_grad=True)
        y = x.exp()                                          # saved by exp
        z = y.sum()
        del y
        assert tr.live == 3 * mb + 4                         # b, x, y, z
        del z                                                # frees y
        assert tr.live == 2 * mb
    assert tr.peak == 3 * mb + 4
    del b, x


def test_kernels_count_their_operations_on_meta():
    b, s, h, e = 2, 40, 4, 16
    t = lambda *sh: torch.empty(sh, device="meta")
    with ops.meta_flops() as count:
        out, st = ops.wkv(t(b, s, h, e), t(b, s, h, e), t(b, s, h, e),
                          t(b, s, h, e), t(h, e), t(b, h, e, e), chunk=16)
    assert tuple(out.shape) == (b, s, h, e) and tuple(st.shape) == \
        (b, h, e, e)
    macs = lambda n: n * (n - 1) * e + 2 * n * e * e + 2 * n * e
    assert count["flops"] == 2 * b * h * (2 * macs(16) + macs(8))
    assert count["calls"] == {"wkv": 1}
