"""The elastic half's pieces with no ranks, against the JAX package:

* ``shrink_mesh`` / ``grow_mesh`` / ``slice_for_process`` on a
  ``MeshShape`` (the reference's cases of tests/test_elastic.py: the
  single-device eligibility, the kept grid, the round trip, the floors and
  the errors);
* ``_make_staleness_rule`` against the reference's on the same seeded
  gradients and buffers, a stale step, a second stale step and the drain,
  bit for bit;
* ``ensure_stale_buffers`` carrying, re-zeroing and dropping buffers, and
  the buffers a runner starts with against the reference's;
* ``cost_model.stale_push_seconds`` equal to the reference's;
* ``analyze(stale_tables=)`` plan fields equal to the reference's on one
  device, (4, 1) and (3, 1) (the reference plans on fake devices).
"""
import dataclasses
import itertools
import json
import shutil
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import distributed_run
from repro.configs import RunConfig, ShapeConfig, get_config, reduced
from repro.core import cost_model as jcm
from repro.core.plan import ParamPlan as JParamPlan
from repro.core.transform import _make_staleness_rule as j_rule
from repro.core.transform import analyze as janalyze
from repro.core.transform import get_runner as jget_runner
from repro.core.runtime import Runtime as JRuntime
from repro.models.model import build_model as jbuild_model
from repro.utils import roofline as jroof
import repro_torch.configs as tc
from repro_torch.core import cost_model as tcm
from repro_torch.core.runtime import Runtime
from repro_torch.core.transform import (_make_staleness_rule, analyze,
                                        ensure_stale_buffers, get_runner,
                                        stale_buffer_tables)
from repro_torch.launch.mesh import (MeshShape, grow_mesh, shrink_mesh,
                                     slice_for_process)
from repro_torch.models.model import build_model
from repro_torch.utils import roofline as troof
from repro_torch.weights import to_numpy, to_torch


# ---------------------------------------------------------------------------
# shrink / grow / attribution on a MeshShape
# ---------------------------------------------------------------------------

def test_shrink_mesh_eligibility_single_device():
    assert shrink_mesh(None, 0) is None
    mesh = MeshShape((1, 1), ("data", "model"))
    assert shrink_mesh(mesh, 0) is None               # data axis at 1
    assert shrink_mesh(mesh, 0, axis="pod") is None   # axis absent
    with pytest.raises(ValueError):
        shrink_mesh(mesh, 5)                          # no such slice
    with pytest.raises(ValueError):
        shrink_mesh(mesh)                             # no slice named
    with pytest.raises(ValueError):
        shrink_mesh(mesh, 0, drop_process_index=0)    # named twice


def test_grow_mesh_eligibility_single_device():
    assert grow_mesh(None, []) is None
    mesh = MeshShape((1, 1), ("data", "model"))
    assert grow_mesh(mesh, [0], axis="pod") is None   # axis absent
    with pytest.raises(ValueError):
        grow_mesh(mesh, [0])                    # still on the live mesh
    with pytest.raises(ValueError):
        grow_mesh(mesh, [1, 2])                 # wrong slice shape
    with pytest.raises(ValueError):
        grow_mesh(mesh, [1], insert_axis_index=5)   # out of range


def test_shrink_mesh_drops_one_slice_and_keeps_grid():
    mesh = MeshShape((4, 2), ("data", "model"))
    m2 = shrink_mesh(mesh, drop_axis_index=3)
    assert m2.shape == {"data": 3, "model": 2}
    assert m2.axis_names == ("data", "model")
    assert (m2.ranks == mesh.ranks[:3]).all()         # same positions
    assert not set(m2.ranks.ravel()) & set(mesh.ranks[3])
    assert shrink_mesh(m2, 0, min_axis_size=3) is None    # 3 - 1 < 3
    m1 = shrink_mesh(mesh, drop_axis_index=1)
    assert m1.ranks.tolist() == [[0, 1], [4, 5], [6, 7]]
    assert m1.lead == 0 and shrink_mesh(mesh, 0).lead == 2


def test_shrink_grow_round_trip_restores_the_grid():
    mesh = MeshShape((4, 2), ("data", "model"))
    m3 = shrink_mesh(mesh, drop_axis_index=1)
    evicted = mesh.ranks[1]
    m4 = grow_mesh(m3, evicted, insert_axis_index=1)
    assert m3.shape == {"data": 3, "model": 2}
    assert m4.shape == {"data": 4, "model": 2}
    assert m4.axis_names == ("data", "model")
    assert (m4.ranks == mesh.ranks).all()
    appended = grow_mesh(m3, evicted)        # default: after the last
    assert appended.ranks[3].tolist() == evicted.tolist()
    flat = grow_mesh(m3, list(evicted), insert_axis_index=1)   # reshaped
    assert (flat.ranks == mesh.ranks).all()
    with pytest.raises(ValueError):
        grow_mesh(m4, evicted, insert_axis_index=1)   # already live
    assert shrink_mesh(m4, 0, min_axis_size=4) is None


def test_slice_for_process_attributes_whole_host_slices():
    # four hosts of two ranks: each host owns one data slice
    mesh = MeshShape((4, 2), ("data", "model"), hosts=4)
    assert [slice_for_process(mesh, h) for h in range(4)] == [0, 1, 2, 3]
    assert mesh.hosts == 4
    m = shrink_mesh(mesh, drop_process_index=2)
    assert m.ranks.tolist() == [[0, 1], [2, 3], [6, 7]] and m.hosts == 3
    # two hosts, each owning a whole model column: no slice is one host's
    cols = MeshShape((2, 2), ("data", "model"),
                     host_of={0: 0, 1: 1, 2: 0, 3: 1})
    assert slice_for_process(cols, 0) is None
    assert shrink_mesh(cols, drop_process_index=0) is None
    assert slice_for_process(None, 0) is None
    assert slice_for_process(mesh, 0, axis="pod") is None


# ---------------------------------------------------------------------------
# the staleness rule, bit for bit
# ---------------------------------------------------------------------------

TABLES = {"embed": ((16, 8), "bfloat16"), "enc_embed": ((12, 8), "float32")}
DENSE = {"w": ((8, 8), "float32")}


def _j_plan(stale: tuple):
    leaf = lambda n, sparse: JParamPlan(
        name=n, method="mpi_gatherv" if sparse else "allreduce", pspec=None,
        opt_pspec=None, wire_dtype=jnp.float32, sparse=sparse, bytes=0)
    params = {n: leaf(n, True) for n in TABLES}
    params.update({n: leaf(n, False) for n in DENSE})
    return SimpleNamespace(stale_tables=stale, params=params)


def _t_plan(stale: tuple):
    return SimpleNamespace(stale_tables=stale)


def _grads(rng) -> dict:
    out = {}
    for n, (shape, dt) in {**TABLES, **DENSE}.items():
        a = rng.standard_normal(shape).astype(np.float32)
        if dt == "bfloat16":
            a = np.asarray(jnp.asarray(a, jnp.bfloat16))
        out[n] = a
    return out


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return to_numpy(x)
    return np.asarray(jnp.asarray(x, jnp.float32) if
                      jnp.asarray(x).dtype == jnp.bfloat16 else x)


@pytest.mark.parametrize("smax", [1, 2])
def test_staleness_rule_matches_reference_bit_for_bit(smax):
    """Two stale steps for ``embed`` (bf16) with ``enc_embed`` (f32)
    synchronous, then the drain (no table stale): applied gradients, the
    new buffers and ages, and the two metrics."""
    rng = np.random.default_rng(0)
    rc_j = SimpleNamespace(run_cfg=SimpleNamespace(max_staleness=smax))
    j_stale = {n: {"g": jnp.asarray(rng.standard_normal(s), jnp.float32),
                   "age": jnp.zeros((), jnp.int32)}
               for n, (s, _) in TABLES.items()}
    t_stale = {n: {"g": to_torch(np.asarray(b["g"]), "cpu"),
                   "age": torch.zeros((), dtype=torch.int32)}
               for n, b in j_stale.items()}
    for stale in [("embed",), ("embed",), ()]:
        grads = _grads(rng)
        jg = {n: jnp.asarray(a) for n, a in grads.items()}
        tg = {n: to_torch(a, "cpu") for n, a in grads.items()}
        j_stale, jout, jm = j_rule(_j_plan(stale), rc_j)(j_stale, jg, {})
        t_stale, tout, tm = _make_staleness_rule(_t_plan(stale), rc_j)(
            t_stale, tg, {})
        for n in grads:
            assert tout[n].dtype == to_torch(grads[n], "cpu").dtype
            np.testing.assert_array_equal(_np(tout[n]), _np(jout[n]))
        for n in TABLES:
            np.testing.assert_array_equal(_np(t_stale[n]["g"]),
                                          _np(j_stale[n]["g"]))
            assert int(t_stale[n]["age"]) == int(j_stale[n]["age"])
        assert set(tm) == set(jm)
        for k in jm:
            assert float(tm[k]) == float(jm[k]), k
    # the drain step applied fresh + the last buffered gradient
    assert set(tm) == set()


def test_staleness_rule_without_buffers_is_the_identity():
    rule = _make_staleness_rule(_t_plan(("embed",)),
                                SimpleNamespace(run_cfg=SimpleNamespace(
                                    max_staleness=2)))
    g = {"embed": torch.ones(2)}
    assert rule(None, g, {}) == (None, g, {})


# ---------------------------------------------------------------------------
# the buffers in the state
# ---------------------------------------------------------------------------

F32 = dict(param_dtype="float32", compute_dtype="float32")


def test_ensure_stale_buffers_carries_rezeroes_and_drops():
    cfg = tc.reduced(tc.get_config("parallax-lm"))
    shape = tc.ShapeConfig("t", 16, 4, "train")
    r = get_runner(cfg, shape, tc.RunConfig(max_staleness=2, **F32),
                   device="cpu")
    names = stale_buffer_tables(r.plan, r.rt)
    assert names and list(r.state.stale) == list(names)
    st = r.state
    buf = st.stale[names[0]]
    assert buf["g"].dtype == torch.float32 and buf["age"].dtype == \
        torch.int32 and buf["g"].shape == st.params[names[0]].shape
    assert int(torch.count_nonzero(buf["g"])) == 0
    buf["g"].fill_(3.0)
    kept = ensure_stale_buffers(st, r.plan, r.rt)
    assert kept.stale[names[0]] is buf              # carried
    st.stale[names[0]] = {"g": torch.ones(3), "age": buf["age"]}
    fresh = ensure_stale_buffers(st, r.plan, r.rt)
    assert fresh.stale[names[0]]["g"].shape == st.params[names[0]].shape
    assert int(torch.count_nonzero(fresh.stale[names[0]]["g"])) == 0
    off = Runtime(cfg, tc.RunConfig(**F32), shape, device="cpu")
    assert ensure_stale_buffers(st, r.plan, off).stale is None
    assert stale_buffer_tables(r.plan, off) == ()


def test_runner_state_buffers_match_reference():
    kw = dict(max_staleness=2, **F32)
    jr = jget_runner(reduced(get_config("parallax-lm")),
                     ShapeConfig("t", 16, 4, "train"), RunConfig(**kw))
    r = get_runner(tc.reduced(tc.get_config("parallax-lm")),
                   tc.ShapeConfig("t", 16, 4, "train"), tc.RunConfig(**kw),
                   device="cpu")
    js = jr.state.stale
    assert sorted(js) == sorted(r.state.stale)
    for n, b in js.items():
        assert tuple(b["g"].shape) == tuple(r.state.stale[n]["g"].shape)
        assert str(b["g"].dtype) == "float32" and str(b["age"].dtype) == \
            "int32"


# ---------------------------------------------------------------------------
# pricing and plans
# ---------------------------------------------------------------------------

def _tpu_hw_for_port():
    h = jroof.HW
    return troof.Hardware(name=h.name, peak_flops=h.peak_flops,
                          hbm_bw=h.hbm_bw, link_bw=h.link_bw,
                          hbm_bytes=h.hbm_bytes, smem_bytes=h.vmem_bytes,
                          link_latency=h.link_latency, inter_bw=h.inter_bw,
                          inter_latency=h.inter_latency)


def test_stale_push_seconds_matches_reference():
    th = _tpu_hw_for_port()
    for (model, data, pod, hosts), b, alpha, method in itertools.product(
            [(1, 4, 1, 1), (2, 3, 1, 1), (4, 2, 2, 2), (1, 1, 1, 1)],
            (4e3, 2e6, 8e8), (1e-3, 0.3, 1.0),
            ("ps", "ps_gather", "mpi_gatherv", "allreduce")):
        want = jcm.stale_push_seconds(
            b=b, alpha=alpha, method=method,
            dims=jcm.MeshDims(model, data, pod, hosts), hw=jroof.HW)
        got = tcm.stale_push_seconds(
            b=b, alpha=alpha, method=method,
            dims=tcm.MeshDims(model, data, pod, hosts), hw=th)
        assert got == want
        assert got["critical_s"] == 0.0 and got["stale_s"] == got["sync_s"]


PHI3 = dict(attention_impl="naive", remat="none", param_dtype="float32",
            compute_dtype="float32", wire_dtype="float32", link_latency=0.0)
PLAN_CASES = [(alpha, smax) for alpha in (0.1, 0.3) for smax in (0, 2)]


def _fields(plan) -> dict:
    leaves = plan.params.values() if isinstance(plan.params, dict) else []
    return {"tables": plan.tables(), "stale_tables": list(plan.stale_tables),
            "stale": {p.name: p.stale for p in leaves if p.sparse}}


@pytest.mark.parametrize("alpha,smax", PLAN_CASES)
def test_analyze_stale_tables_one_device_matches_reference(alpha, smax):
    kw = dict(PHI3, table_alpha=(("embed", alpha),), max_staleness=smax)
    jcfg = reduced(get_config("phi3-medium-14b"), vocab=256)
    jrt = JRuntime(jcfg, RunConfig(**kw), ShapeConfig("t", 32, 8, "train"))
    jp = janalyze(jbuild_model(jcfg, jrt), jrt, stale_tables=("embed",))
    cfg = tc.reduced(tc.get_config("phi3-medium-14b"), vocab=256)
    rt = Runtime(cfg, tc.RunConfig(**kw), tc.ShapeConfig("t", 32, 8,
                                                         "train"),
                 device="cpu")
    tp = analyze(build_model(cfg, rt), rt, stale_tables=("embed",))
    assert tp.tables() == jp.tables()
    assert list(tp.stale_tables) == list(jp.stale_tables)


STALE_PLAN_CODE = """
from repro.configs import RunConfig, ShapeConfig, get_config, reduced
from repro.core.plan import plan_leaves
from repro.core.runtime import Runtime
from repro.core.transform import analyze, stale_buffer_tables
from repro.launch.mesh import shrink_mesh
from repro.models.model import build_model

cfg = reduced(get_config("phi3-medium-14b"), vocab=256)
shape = ShapeConfig("t", seq_len=32, global_batch=8, kind="train")
mesh4 = make_mesh((4, 1), ("data", "model"))
mesh3 = shrink_mesh(mesh4, drop_axis_index=3)
out = {}
for alpha, smax in CASES:
    rc = RunConfig(**KW, table_alpha=(("embed", alpha),), max_staleness=smax)
    for name, mesh in (("4", mesh4), ("3", mesh3)):
        rt = Runtime(cfg, rc, shape, mesh=mesh)
        p = analyze(build_model(cfg, rt), rt, stale_tables=("embed",))
        out[f"{alpha}/{smax}/{name}"] = {
            "tables": p.tables(), "stale_tables": list(p.stale_tables),
            "stale": {q.name: q.stale for q in plan_leaves(p.params)
                      if q.sparse},
            "buffers": list(stale_buffer_tables(p, rt))}
print("RESULT:" + json.dumps(out))
"""


def test_analyze_stale_tables_on_meshes_matches_reference():
    """α 0.3 prices ``embed`` on the dense all-reduce at N = 4 (no stale
    push: it rides the buckets) and on ``mpi_gatherv`` at N = 3 (stamped
    stale); α 0.1 on ``mpi_gatherv`` at both. ``max_staleness`` 0 stamps
    nothing."""
    code = STALE_PLAN_CODE.replace("CASES", repr(PLAN_CASES)).replace(
        "KW", repr(PHI3))
    ref = distributed_run(code, devices=8, timeout=300)
    cfg = tc.reduced(tc.get_config("phi3-medium-14b"), vocab=256)
    shape = tc.ShapeConfig("t", 32, 8, "train")
    mesh4 = MeshShape((4, 1), ("data", "model"))
    meshes = {"4": mesh4, "3": shrink_mesh(mesh4, drop_axis_index=3)}
    for alpha, smax in PLAN_CASES:
        rc = tc.RunConfig(**PHI3, table_alpha=(("embed", alpha),),
                          max_staleness=smax)
        for name, mesh in meshes.items():
            rt = Runtime(cfg, rc, shape, mesh=mesh, device="cpu")
            p = analyze(build_model(cfg, rt), rt, stale_tables=("embed",))
            got = {**_fields(p), "buffers": list(stale_buffer_tables(p, rt))}
            assert got == ref[f"{alpha}/{smax}/{name}"], (alpha, smax, name)
    assert ref["0.3/2/4"]["stale_tables"] == []
    assert ref["0.3/2/3"]["stale_tables"] == ["embed"]
    assert ref["0.1/0/3"]["stale_tables"] == []


# ---------------------------------------------------------------------------
# stale buffers in checkpoints, across the two packages
# ---------------------------------------------------------------------------

def test_stale_checkpoint_restores_across_packages(tmp_path):
    """The JAX trainer flips ``embed`` stale and checkpoints inside the
    stale window; the port's trainer restores it: the stale flags (the
    plan record), the buffers bit for bit, and the next steps' losses
    within rtol 1e-5 of the JAX trainer's own continuation. The port's
    checkpoint lists the same leaves in the same order."""
    from repro.checkpoint.ckpt import latest_step as jlatest
    from repro.data import SyntheticLM as JSyntheticLM
    from repro.runtime.trainer import Trainer as JTrainer
    from repro.runtime.trainer import TrainerConfig as JTrainerConfig
    from repro_torch.data import SyntheticLM
    from repro_torch.runtime.trainer import Trainer, TrainerConfig
    kw = dict(param_dtype="float32", compute_dtype="float32",
              max_staleness=2)
    shape = (32, 8)
    jcfg = reduced(get_config("parallax-lm"))
    jt = JTrainer(jcfg, ShapeConfig("t", *shape, "train"), RunConfig(**kw),
                  JTrainerConfig(total_steps=2, ckpt_dir=str(tmp_path / "j"),
                                 ckpt_every=100),
                  JSyntheticLM(jcfg.vocab_size, *shape))
    jt.run()
    jt._flip_stale(True)
    assert jt.plan.stale_tables == ("embed",)
    jt.tcfg = dataclasses.replace(jt.tcfg, total_steps=4)
    jt.run()                           # saves step 4, stale
    assert jlatest(str(tmp_path / "j")) == 4
    shutil.copytree(tmp_path / "j" / "step_00000004",
                    tmp_path / "p" / "step_00000004")
    want = []
    jt.tcfg = dataclasses.replace(jt.tcfg, total_steps=6)
    jt.run(on_metrics=lambda s, m: want.append(float(m["loss"])))
    cfg = tc.reduced(tc.get_config("parallax-lm"))
    t = Trainer(cfg, tc.ShapeConfig("t", *shape, "train"),
                tc.RunConfig(**kw),
                TrainerConfig(total_steps=6, ckpt_dir=str(tmp_path / "p"),
                              ckpt_every=100),
                SyntheticLM(cfg.vocab_size, *shape), device="cpu")
    t.maybe_restore()
    assert t.step == 4 and t.plan.stale_tables == ("embed",)
    assert t.monitor._stale_on
    from repro.checkpoint.ckpt import restore_checkpoint as jrestore
    jstate, _, _ = jrestore(str(tmp_path / "j"), jt._canonical_state(),
                            step=4)
    np.testing.assert_array_equal(to_numpy(t.state.stale["embed"]["g"]),
                                  np.asarray(jstate.stale["embed"]["g"]))
    got = []
    t.run(on_metrics=lambda s, m: got.append(m["loss"]))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    # the port's own checkpoint: the reference's leaf list
    with open(tmp_path / "j" / "step_00000004" / "manifest.json") as f:
        jpaths = [e["path"] for e in json.load(f)["leaves"]]
    with open(tmp_path / "p" / "step_00000006" / "manifest.json") as f:
        tpaths = [e["path"] for e in json.load(f)["leaves"]]
    assert tpaths == jpaths
    assert jpaths[-2:] == ["stale.embed.age", "stale.embed.g"]
