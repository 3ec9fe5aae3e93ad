"""The profile -> replan loop of the port against the JAX package, on one
device: ``SparsityProfile``, ``observed_census`` (growth, sticky growth,
exact mode, an empty profile), ``wire_dtype_hints`` and ``plan_diff`` fed
the same inputs as the reference's functions give equal results (census
fields and diffs compared with ``==``); ``Runner.replan`` keeps parameters
and moments bit-identical across a no-op and a forced rebuild and shrinks
the capacity on a drift; and the trajectory across a replan equals the
reference ``Runner.replan``'s within rtol 1e-5 (f32: GEMM summation order
differs).

Reduced parallax-lm (vocab 512), ``ShapeConfig("t", 32, 8)``.
"""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro.configs import RunConfig, ShapeConfig, get_config, reduced
from repro.core import sparsity as jsp
from repro.core.plan import plan_diff as jplan_diff
from repro.core.transform import analyze as janalyze
from repro.core.transform import estimate_census as jestimate
from repro.core.transform import get_runner as jget_runner
from repro.data import SyntheticLM
from repro.utils.tree import named_leaves
import repro_torch.configs as tc
from repro_torch.core import sparsity as tsp
from repro_torch.core.plan import plan_diff
from repro_torch.core.transform import analyze, estimate_census, get_runner
from repro_torch.weights import load_reference_params

SEQ, BATCH = 32, 8
F32 = dict(param_dtype="float32", compute_dtype="float32")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tests run many small eager ops; beside the other test workers,
    torch's default of a thread per core oversubscribes the host many
    times over. One intra-op thread for this module, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs():
    return (reduced(get_config("parallax-lm")),
            tc.reduced(tc.get_config("parallax-lm")))


def _census(mod, tables: dict, **kw):
    """The same Census in either package: tables {name: (rows, tokens,
    unique, capacity)}."""
    ts = {n: mod.TableCensus(name=n, rows=r, tokens=t, unique=u,
                             alpha=u / r, capacity=c)
          for n, (r, t, u, c) in tables.items()}
    base = dict(dense_params=10, sparse_params=100, alpha=0.2,
                local_tokens=64, capacity=24)
    base.update(kw)
    return mod.Census(tables=ts, **base)


TABLES = {"embed": (256, 64, 24.0, 24), "enc_embed": (256, 64, 20.0, 20)}
PROFILES = {
    # (metric updates, run-config knobs, live plan record)
    "overflow_growth": (
        [{"embed_unique": 40.0, "embed_dropped": 16.0,
          "enc_embed_unique": 20.0, "enc_embed_dropped": 0.0}] * 3,
        dict(capacity_mode="capped", capacity_factor=1.0,
             capacity_growth=2.0, overflow_tolerance=0.5), None),
    "sticky_growth": (
        [{"embed_unique": 40.0, "embed_dropped": 0.0}],
        dict(capacity_mode="capped", capacity_factor=1.0,
             capacity_growth=2.0, overflow_tolerance=0.5),
        {"embed": (80, True)}),
    "sticky_falling_demand": (
        [{"embed_unique": 20.0, "embed_dropped": 0.0}],
        dict(capacity_mode="capped", capacity_factor=1.0,
             capacity_growth=2.0, overflow_tolerance=0.5),
        {"embed": (80, True)}),
    "refit_shrink": (
        [{"embed_unique": 12.0, "loss": 3.0}, {"embed_unique": 9.0},
         {"embed_unique": 15.0, "embed_dropped": 0.0}],
        dict(capacity_mode="capped", capacity_factor=2.0), None),
    "exact_mode": (
        [{"embed_unique": 40.0, "embed_dropped": 3.0}], {}, None),
    "empty_profile": ([{"loss": 1.0}], dict(capacity_mode="capped"), None),
    "magnitude_keys": (
        [{"embed_unique": 30.0, "gbucket0_gmax": 2.0, "gbucket0_grms": 0.1,
          "embed_gmax": 1.0, "embed_grms": 0.5, "moe_dropped": 4.0}] * 2,
        dict(capacity_mode="capped", capacity_factor=1.5), None),
}


@pytest.mark.parametrize("case", list(PROFILES))
def test_profile_and_observed_census_equal_reference(case):
    updates, kw, live = PROFILES[case]
    jp, tp = jsp.SparsityProfile(decay=0.5), tsp.SparsityProfile(decay=0.5)
    for u in updates:
        jp.update(u)
        tp.update(u)
    assert (tp.ema, tp.last, tp.steps) == (jp.ema, jp.last, jp.steps)
    for mn in (1, 2, 5):
        assert tp.ready(mn) == jp.ready(mn)
    assert tp.observed_unique == jp.observed_unique
    assert tp.dropped() == jp.dropped()
    assert tp.dropped(("embed",)) == jp.dropped(("embed",))
    assert tp.unique_for("embed") == jp.unique_for("embed")
    assert tp.dropped_for("enc_embed") == jp.dropped_for("enc_embed")
    assert tp.alpha(256) == jp.alpha(256)
    got = tsp.observed_census(tp, _census(tsp, TABLES), 256,
                              tc.RunConfig(**kw), live=live)
    want = jsp.observed_census(jp, _census(jsp, TABLES), 256,
                               RunConfig(**kw), live=live)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    if case == "empty_profile":
        empty = _census(tsp, TABLES)
        assert tsp.observed_census(tsp.SparsityProfile(), empty, 256,
                                   tc.RunConfig(**kw)) is empty
    if case == "overflow_growth":
        assert got.tables["embed"].grown and got.tables["embed"].capacity == 80
    tp.reset_grad_census()
    jp.reset_grad_census()
    assert tp.ema == jp.ema and tp.last == jp.last


@pytest.mark.parametrize("ratio", [0.0, 10.0, 1e6])
def test_wire_dtype_hints_equal_reference(ratio):
    metrics = {"gbucket0_gmax": 3.0, "gbucket0_grms": 0.01,
               "gbucket1_gmax": 0.2, "gbucket1_grms": 0.1,
               "embed_gmax": 5.0, "embed_grms": 0.02,
               "enc_embed_gmax": 0.3, "enc_embed_grms": 0.2}
    jp, tp = jsp.SparsityProfile(), tsp.SparsityProfile()
    jp.update(metrics)
    tp.update(metrics)
    bp = SimpleNamespace(buckets=[SimpleNamespace(idx=(3, 1)),
                                  SimpleNamespace(idx=(2,)),
                                  SimpleNamespace(idx=(0,))])
    names = ["a", "b", "c", "d"]
    kw = dict(outlier_ratio=ratio, default="bfloat16",
              sparse_tables=["embed", "enc_embed", "nope"])
    got = tsp.wire_dtype_hints(tp, bp, names, **kw)
    assert got == jsp.wire_dtype_hints(jp, bp, names, **kw)
    assert tsp.wire_dtype_hints(tp, None, names, **kw) == \
        jsp.wire_dtype_hints(jp, None, names, **kw)


def _plans(rc_kw: dict, prof_metrics: dict, wire=None):
    """(reference (old, new), port (old, new)): the build-time plan and the
    plan from the same observed census, in both packages."""
    jcfg, tcfg = _cfgs()
    jr = jget_runner(jcfg, ShapeConfig("t", SEQ, BATCH, "train"),
                     RunConfig(**rc_kw))
    tr = get_runner(tcfg, tc.ShapeConfig("t", SEQ, BATCH, "train"),
                    tc.RunConfig(**rc_kw), device="cpu")
    out = []
    for mod, r, est, an in ((jsp, jr, jestimate, janalyze),
                            (tsp, tr, estimate_census, analyze)):
        prof = mod.SparsityProfile()
        prof.update(prof_metrics)
        c = mod.observed_census(prof, est(r.model, r.rt), 512,
                                r.rt.run_cfg)
        if wire:
            c.wire_dtypes = dict(wire)
        out.append((r.plan, an(r.model, r.rt, census=c)))
    return out


DIFFS = {
    "drift_shrink": (dict(capacity_mode="capped"), {"embed_unique": 20.0},
                     None),
    "no_change": (dict(capacity_mode="capped"), {"embed_unique": 118.0},
                  None),
    "overflow_grown": (dict(capacity_mode="capped", capacity_factor=1.0),
                       {"embed_unique": 100.0, "embed_dropped": 9.0}, None),
    "wire_pin": (dict(capacity_mode="capped"), {"embed_unique": 110.0},
                 {"layers.w_x": "float32", "embed": "float32"}),
}


@pytest.mark.parametrize("case", list(DIFFS))
@pytest.mark.parametrize("drift", [1.3, 1.5, 50.0])
def test_plan_diff_equals_reference(case, drift):
    kw, metrics, wire = DIFFS[case]
    (jold, jnew), (told, tnew) = _plans(kw, metrics, wire)
    assert tnew.tables() == jnew.tables()
    got = plan_diff(told, tnew, drift)
    want = jplan_diff(jold, jnew, drift)
    assert got == want, (got, want)
    if case == "wire_pin":
        assert got["wire_flips"] and got["changed"]


def _runner(rc, named=None):
    _, tcfg = _cfgs()
    return get_runner(tcfg, tc.ShapeConfig("t", SEQ, BATCH, "train"), rc,
                      device="cpu",
                      params=None if named is None else
                      load_reference_params(named, "cpu"))


def test_noop_and_forced_replan_keep_state_bits():
    r = _runner(tc.RunConfig(**F32))
    ds = SyntheticLM(512, SEQ, BATCH)
    r.run(ds.batch(0))
    before = {f"{part}.{n}": t.clone() for part in ("params", "m", "v")
              for n, t in getattr(r.state, part).items()}
    census = estimate_census(r.model, r.rt)
    d = r.replan(census)
    assert not d["changed"] and not d["rebuilt"]
    d = r.replan(census, force=True)
    assert d["rebuilt"]
    after = {f"{part}.{n}": t for part in ("params", "m", "v")
             for n, t in getattr(r.state, part).items()}
    assert all(torch.equal(before[k], after[k]) for k in before)
    assert r.state.step == 1
    assert np.isfinite(float(r.run(ds.batch(1))["loss"]))


def test_capacity_drift_replan_shrinks():
    rc = tc.RunConfig(**F32, capacity_mode="capped", capacity_factor=1.0)
    r = _runner(rc)
    cap0 = r.plan.capacity
    prof = tsp.SparsityProfile()
    prof.update({"embed_unique": cap0 / 4})
    d = r.replan(tsp.observed_census(prof, estimate_census(r.model, r.rt),
                                     512, rc))
    assert d["capacity_drifted"] and d["rebuilt"]
    assert r.plan.capacity < cap0 and r.rt.plan is r.plan
    assert r.rt.embed_capacity_for("embed") == r.plan.capacity


def test_replan_trajectory_matches_reference():
    """3 steps, a replan from each package's own observed census (the
    census metrics are equal), 3 more: losses within rtol 1e-5, the
    replanned plans equal."""
    kw = dict(F32, capacity_mode="capped", capacity_factor=1.5)
    jcfg, _ = _cfgs()
    jr = jget_runner(jcfg, ShapeConfig("t", SEQ, BATCH, "train"),
                     RunConfig(**kw), seed=0)
    named = {n: np.asarray(a) for n, a in named_leaves(jr.state.params)}
    tr = _runner(tc.RunConfig(**kw), named)
    ds = SyntheticLM(512, SEQ, BATCH, seed=0)
    jp, tp = jsp.SparsityProfile(), tsp.SparsityProfile()
    caps = []
    for i in range(6):
        b = ds.batch(i)
        jm, tm = jr.run(b), tr.run(b)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5, err_msg=f"step {i}")
        jp.update({k: float(v) for k, v in jm.items()})
        tp.update({k: float(v) for k, v in tm.items()})
        if i == 2:
            jd = jr.replan(jsp.observed_census(
                jp, jestimate(jr.model, jr.rt), 512, jr.rt.run_cfg))
            td = tr.replan(tsp.observed_census(
                tp, estimate_census(tr.model, tr.rt), 512, tr.rt.run_cfg))
            assert td["rebuilt"] and jd["rebuilt"]
            assert td["table_capacity"] == jd["table_capacity"]
            assert tr.plan.tables() == jr.plan.tables()
            caps = td["table_capacity"]
    assert caps[1]["embed"] < caps[0]["embed"]


# ---------------------------------------------------------------------------
# the phi3 cases of the reference's tests/test_replan.py: reduced
# phi3-medium-14b at vocab 256, ShapeConfig("tiny", 32, 4), the default
# RunConfig's dtypes (bf16) unless the reference's case sets them
# ---------------------------------------------------------------------------

PHI3_VOCAB = 256
TINY = ("tiny", 32, 4, "train")
SYS = dict(attention_impl="naive", remat="none")


def _phi3_runner(rc, seed=0):
    return get_runner(tc.reduced(tc.get_config("phi3-medium-14b"),
                                 vocab=PHI3_VOCAB),
                      tc.ShapeConfig(*TINY), rc, device="cpu", seed=seed)


def _phi3_jrunner(rc):
    return jget_runner(reduced(get_config("phi3-medium-14b"),
                               vocab=PHI3_VOCAB), ShapeConfig(*TINY), rc)


def _phi3_data(**kw):
    return SyntheticLM(PHI3_VOCAB, 32, 4, **kw)


def test_phi3_declared_zipf_skew_informs_the_planner():
    """RunConfig.zipf_a switches the census to the skew-aware estimate;
    both plans equal the reference's."""
    base = dict(capacity_mode="capped")
    tokens = 32 * 4
    plans = {}
    for name, kw in (("uniform", base), ("zipf", dict(base, zipf_a=1.3))):
        plans[name] = _phi3_runner(tc.RunConfig(**kw)).plan
        assert plans[name].tables() == \
            _phi3_jrunner(RunConfig(**kw)).plan.tables()
    assert plans["uniform"].alpha == pytest.approx(
        tsp.expected_unique(tokens, PHI3_VOCAB) / PHI3_VOCAB)
    assert plans["zipf"].alpha == pytest.approx(
        tsp.expected_unique_zipf(tokens, PHI3_VOCAB, 1.3) / PHI3_VOCAB)
    assert plans["zipf"].alpha < plans["uniform"].alpha
    assert plans["zipf"].capacity < plans["uniform"].capacity


def test_phi3_plan_diff_flags_overflow_growth_and_wire_flips():
    """A grown table marks the diff changed inside the drift deadband; a
    per-parameter wire-dtype move is a rebuild signal without a
    placement change."""
    r = _phi3_runner(tc.RunConfig(capacity_mode="capped",
                                  capacity_factor=1.0))
    census = estimate_census(r.model, r.rt)
    grown_tables = {n: dataclasses.replace(t, capacity=int(t.capacity * 1.3),
                                           grown=True)
                    for n, t in census.tables.items()}
    grown = dataclasses.replace(census, tables=grown_tables)
    d = r.replan(grown, capacity_drift=1.5)
    assert d["capacity_grown"] and d["changed"] and d["rebuilt"]
    assert not d["capacity_drifted"]
    assert r.plan.table_capacity["embed"] == grown_tables["embed"].capacity
    dense = [p.name for p in r.plan.params.values() if not p.sparse]
    d2 = r.replan(dataclasses.replace(
        grown, wire_dtypes={n: "float32" for n in dense}))
    assert d2["wire_flips"] and d2["changed"] and d2["rebuilt"]
    assert not d2["pspecs_changed"]
    assert all(r.plan.params[n].wire_dtype == torch.float32 for n in dense)


def test_phi3_step_metrics_carry_observed_unique():
    r = _phi3_runner(tc.RunConfig(**SYS))
    b = _phi3_data().batch(0)
    assert float(r.run(b)["embed_unique"]) == \
        pytest.approx(float(np.unique(b["tokens"]).size))


def test_phi3_plan_from_census_equals_from_scratch():
    """analyze(census=c) equals the build-time plan whose estimate is c."""
    r = _phi3_runner(tc.RunConfig(capacity_mode="capped"))
    census = estimate_census(r.model, r.rt)
    other = analyze(r.model, r.rt, census=census)
    assert other.methods() == r.plan.methods()
    assert (other.capacity, other.alpha) == (r.plan.capacity, r.plan.alpha)
    d = plan_diff(r.plan, other)
    assert not d["changed"] and not d["flips"]


def test_phi3_noop_replan_keeps_params_bit_identical():
    r = _phi3_runner(tc.RunConfig(**SYS))
    ds = _phi3_data()
    r.run(ds.batch(0))
    before = {f"{part}.{n}": t.clone() for part in ("params", "m", "v")
              for n, t in getattr(r.state, part).items()}
    census = estimate_census(r.model, r.rt)
    d = r.replan(census)
    assert not d["changed"] and not d["rebuilt"]
    assert r.replan(census, force=True)["rebuilt"]
    after = {f"{part}.{n}": t for part in ("params", "m", "v")
             for n, t in getattr(r.state, part).items()}
    assert all(torch.equal(before[k], after[k]) for k in before)
    assert np.isfinite(float(r.run(ds.batch(1))["loss"]))


def test_phi3_capacity_drift_triggers_replan():
    rc = tc.RunConfig(**SYS, capacity_mode="capped", capacity_factor=1.0)
    r = _phi3_runner(rc)
    cap0 = r.plan.capacity
    prof = tsp.SparsityProfile()
    prof.update({"embed_unique": cap0 / 4})
    d = r.replan(tsp.observed_census(prof, estimate_census(r.model, r.rt),
                                     PHI3_VOCAB, rc))
    assert d["capacity_drifted"] and d["rebuilt"]
    assert r.plan.capacity < cap0


def _phi3_trainer(rc, tcfg, ds):
    from repro_torch.runtime.trainer import Trainer
    return Trainer(tc.reduced(tc.get_config("phi3-medium-14b"),
                              vocab=PHI3_VOCAB), tc.ShapeConfig(*TINY), rc,
                   tcfg, ds, device="cpu")


def test_phi3_trainer_replan_hook_and_monitor():
    from repro_torch.runtime.trainer import TrainerConfig
    rc = tc.RunConfig(**SYS, capacity_mode="capped", capacity_factor=1.5)
    t = _phi3_trainer(rc, TrainerConfig(total_steps=8, replan_every=4,
                                        replan_warmup=2, replan_drift=1.3),
                      _phi3_data())
    cap0 = t.plan.capacity
    stats = []
    t.run(on_metrics=lambda s, m: stats.append(m))
    # Zipf data against the uniform estimate: the capacity shrinks
    assert t.monitor.replans >= 1
    assert t.plan.capacity < cap0
    assert t.plan.alpha < cap0 / PHI3_VOCAB
    assert "observed_alpha" in stats[-1]
    assert stats[-1]["replans"] == t.monitor.replans
    assert all(np.isfinite(m["loss"]) for m in stats)


def test_phi3_trainer_overflow_growth_and_monitor_surfacing():
    from repro_torch.runtime.trainer import TrainerConfig
    rc = tc.RunConfig(**SYS, capacity_mode="capped", capacity_factor=2.0,
                      zipf_a=2.0, capacity_growth=1.5,
                      overflow_tolerance=0.5)
    t = _phi3_trainer(rc, TrainerConfig(total_steps=8, replan_every=6,
                                        replan_warmup=2, replan_drift=50.0),
                      _phi3_data(zipf_a=2.0, burst_steps=4,
                                 burst_zipf_a=1.3))
    cap0 = t.plan.table_capacity["embed"]
    stats = []
    t.run(on_metrics=lambda s, m: stats.append(m))
    assert any(m.get("overflow", {}).get("embed", 0) > 0 for m in stats)
    assert "overflow_rows" in stats[-1]
    assert t.monitor.replans >= 1
    assert t.plan.table_capacity["embed"] > cap0
    assert "embed" in t.plan.grown_tables
    assert all(np.isfinite(m["loss"]) for m in stats)


@pytest.mark.distributed
def test_phi3_method_flipping_replan_preserves_trajectory():
    """(4, 2), Zipf ids: the uniform estimate plans ps, the observed α
    sits below the ps / ps_gather crossover; the replan flips the method,
    keeps the placements, and reproduces the static losses within
    5e-4 + 1e-4·i."""
    import _torch_dense_ranks as DR
    from repro_torch.launch.mesh import spawn
    res = spawn(DR.flip_rank, 8, "gloo", timeout=300)[0]
    st, ad = res["static"], res["adaptive"]
    assert st["first"] == st["last"] == "ps"
    assert ad["first"] == "ps" and ad["last"] == "ps_gather", ad
    assert ad["diff"]["flips"] and not ad["diff"]["pspecs_changed"]
    assert ad["alpha"] < st["alpha"]
    for i, (a, b) in enumerate(zip(st["losses"], ad["losses"])):
        assert abs(a - b) < 5e-4 + 1e-4 * i, (i, st["losses"], ad["losses"])


@pytest.mark.distributed
def test_phi3_wire_dtype_auto_replan_from_magnitude_census():
    import _torch_dense_ranks as DR
    from repro_torch.launch.mesh import spawn
    res = spawn(DR.wire_auto_rank, 8, "gloo", timeout=300)[0]
    assert res["n_gm"] == 2 * res["n_buckets"], res
    assert res["wire_flips"] and res["rebuilt"], res
    assert not res["pspecs_changed"]
    assert res["wires"] == ["float32"], res
    assert res["keys0"] == ["bfloat16"] and res["keys1"] == ["float32"]
    assert np.isfinite(res["loss"])


@pytest.mark.distributed
def test_phi3_overflow_growth_replan_exact_trajectory():
    """A burst overflows the capped buffer; the growth rule (not the drift
    deadband) rebuilds the step, and the swap leaves the f32 trajectory
    exactly as the static run's."""
    import _torch_dense_ranks as DR
    from repro_torch.launch.mesh import spawn
    res = spawn(DR.growth_rank, 4, "gloo", timeout=300)[0]
    st, ad = res["static"], res["adaptive"]
    d = ad["diff"]
    assert max(ad["dropped"][:4]) > 0, ad["dropped"]
    assert d["rebuilt"] and d["capacity_grown"], d
    assert not d["capacity_drifted"] and not d["flips"] \
        and not d["pspecs_changed"], d
    assert ad["cap"] > ad["cap0"] and ad["grown"] == ["embed"]
    assert st["cap"] == st["cap0"]
    assert st["losses"] == ad["losses"]
