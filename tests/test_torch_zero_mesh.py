"""ZeRO-1 on gloo process meshes: optimizer state sharded apart from its
parameter (``ParamPlan.opt_held`` shards one more dimension over the FSDP
axes than ``held``), asked for with ``RunConfig.zero_stage=1`` or stamped
by the memory escalation.

Reduced phi3 (the reference test's RunConfig: f32, naive attention, no
remat; ``ShapeConfig("tiny", 32, 8)``) and reduced parallax-lm (f32,
``("tiny", 32, 4)``) on (2, 2) and (4, 1), 3 steps from the JAX package's
seeded init: every step's loss bit-equal to ``zero_stage 0`` on the same
mesh (every operation of the sharded update is elementwise), and within
the reference's bar of the JAX package's one-device losses (2e-5 for phi3,
5e-4 + 1e-4·i for parallax-lm). Each rank holds 1/D of every dense moment
(the sparse tables' moments whole) and ``per_device_bytes`` counts the
bytes it holds.

Also: a plan the escalation took to stage 1 under ``RunConfig()`` with
the fused apply on (its bucketed moments stay whole, as the reference's
``state_shardings`` keeps the bucket buffers replicated; the unbucketed
leaves follow ``opt_placement``) and with it off (every dense moment
sharded), both equal to the unescalated run; a replan whose
``opt_placement`` moves, carrying the moments; a checkpoint saved on a
ZeRO-1 (2, 1) mesh restored on one device, on (2, 2) at zero_stage 0 and
on (2, 1) at zero_stage 0, each continued against the uninterrupted run;
the launcher's ``--devices 4 --mesh 2x2`` with a default plan that
escalates.
"""
import shutil

import numpy as np
import pytest
import torch

import _torch_zero_ranks as R
from repro.configs import RunConfig, ShapeConfig, get_config, reduced
from repro.core.transform import get_runner as jget_runner
from repro.utils.tree import named_leaves
from repro_torch.launch.mesh import spawn

pytestmark = pytest.mark.distributed

PHI3, LM = "phi3-medium-14b", "parallax-lm"
MESHES = [(2, 2), (4, 1)]
CASES = [(mesh, arch) for mesh in MESHES for arch in (PHI3, LM)]


def _bar(arch: str, i: int) -> float:
    return 2e-5 if arch == PHI3 else 5e-4 + 1e-4 * i


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def reference():
    """The JAX package's one-device losses and parameters per arch."""
    out = {}
    for arch in (PHI3, LM):
        seq, batch = R.SHAPES.get(arch, R.SHAPE)
        jr = jget_runner(reduced(get_config(arch)),
                         ShapeConfig("tiny", seq, batch, "train"),
                         RunConfig(**R.kw(arch)), seed=0)
        named = {n: np.asarray(a) for n, a in named_leaves(jr.state.params)}
        out[arch] = (named, [float(jr.run(b)["loss"])
                             for b in R.batches(arch)])
    return out


@pytest.fixture(scope="module")
def meshes(reference):
    """Per mesh: each arch at zero_stage 0 and 1; on (4, 1) parallax-lm's
    escalated plans too (fused apply on and off)."""
    out = {}
    for mesh in MESHES:
        cases = []
        for arch in (PHI3, LM):
            named = reference[arch][0]
            cases += [(f"{arch}/0", arch, {}, named, False),
                      (f"{arch}/1", arch, {"zero_stage": 1}, named, False)]
        if mesh == (4, 1):
            named = reference[LM][0]
            cases += [("esc/fused", LM, {}, named, True),
                      ("esc/unfused", LM, {"fused_apply": False}, named,
                       True)]
        out[mesh] = spawn(R.zero_rank, mesh[0] * mesh[1], "gloo",
                          args=(mesh, cases), timeout=400)
    return out


def _same(a: dict, b: dict) -> None:
    assert list(a) == list(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("mesh,arch", CASES,
                         ids=[f"{m[0]}x{m[1]}-{a}" for m, a in CASES])
def test_zero1_equals_zero0_and_one_device(reference, meshes, mesh, arch):
    want = reference[arch][1]
    for rank in meshes[mesh]:
        z0, z1 = rank[f"{arch}/0"], rank[f"{arch}/1"]
        assert z1["loss"] == z0["loss"] == meshes[mesh][0][f"{arch}/0"][
            "loss"]
        _same(z1["whole"], z0["whole"])
        assert z1["zero_stage"] == 1 and not z1["fused_apply"]
        for i, (a, b) in enumerate(zip(z1["loss"], want)):
            assert abs(a - b) < _bar(arch, i), (i, z1["loss"], want)


@pytest.mark.parametrize("mesh,arch", CASES,
                         ids=[f"{m[0]}x{m[1]}-{a}" for m, a in CASES])
def test_each_rank_holds_1_over_d_of_the_dense_moments(meshes, mesh, arch):
    """zero_stage 1: every dense leaf with a free dimension that divides
    the data axis holds 1/D of its moments, the sparse tables whole; the
    rank's bytes of parameters and moments are ``per_device_bytes`` by
    the placements executed."""
    d = mesh[0]
    for rank in meshes[mesh]:
        z0, z1 = rank[f"{arch}/0"], rank[f"{arch}/1"]
        dense = [n for n, x in z1["leaves"].items() if not x["sparse"]]
        assert dense
        for n, x in z1["leaves"].items():
            assert x["share"] == x["plan_share"], (n, x)
            if x["sparse"]:
                assert x["share"] == 1 and not x["zero"], (n, x)
            else:
                assert x["share"] == (1 / d if x["zero"] else 1), (n, x)
            assert x["m"] == x["v"]
        # every dense leaf but one whose free dimensions none divide D
        # (parallax-lm's (2, 512) LSTM bias on (4, 1))
        assert sum(z1["leaves"][n]["zero"] for n in dense) >= len(dense) - 1
        if arch == PHI3:
            assert all(z1["leaves"][n]["zero"] for n in dense)
        for z in (z0, z1):
            assert z["bytes"] == z["plan_bytes"], (z["bytes"],
                                                   z["plan_bytes"])
            assert z["opt_bytes"] == z["plan_opt_bytes"]
        # held == placement on every leaf of every family (the LSTM holds
        # its gate-strided H/M block on the model axis)
        assert z1["plan_bytes"] == z1["plan_bytes_planned"]
        assert z1["opt_bytes"] < z0["opt_bytes"]


def test_escalated_plan_keeps_the_fused_buckets_whole(meshes):
    """The escalation stamps ZeRO-1 under ``RunConfig()``: with the fused
    apply on (eligible: the RunConfig's zero_stage is 0) the bucketed
    leaves' moments stay whole and the unbucketed ones (the sparse table)
    follow ``opt_placement``; with it off every dense moment is sharded
    over data. Both equal the unescalated run bit for bit."""
    for rank in meshes[(4, 1)]:
        base = rank[f"{LM}/0"]
        fused, unfused = rank["esc/fused"], rank["esc/unfused"]
        assert fused["zero_stage"] == unfused["zero_stage"] == 1
        assert fused["fused_apply"] and fused["live_fused"]
        assert not unfused["fused_apply"] and not unfused["live_fused"]
        assert base["fused_apply"] and base["zero_stage"] == 0
        assert fused["bucketed"]
        for n, x in fused["leaves"].items():
            assert x["share"] == x["plan_share"]
            if n in fused["bucketed"]:
                assert x["share"] == 1, (n, x)
            else:
                assert x["sparse"] and not x["zero"] and x["share"] == 1
        assert any(x["zero"] for x in fused["leaves"].values())
        for n, x in unfused["leaves"].items():
            assert x["share"] == (1 / 4 if x["zero"] else 1), (n, x)
            assert x["zero"] == fused["leaves"][n]["zero"]
        for run in (fused, unfused):
            assert run["loss"] == base["loss"]
            _same(run["whole"], base["whole"])
            assert run["bytes"] == run["plan_bytes"]
        assert unfused["opt_bytes"] < fused["opt_bytes"] == base["opt_bytes"]


@pytest.fixture(scope="module")
def replan(reference):
    named = reference[PHI3][0]
    moved = spawn(R.replan_rank, 4, "gloo", args=((2, 2), PHI3, named, 1),
                  timeout=300)
    held = spawn(R.state_rank, 4, "gloo", args=((2, 2), PHI3, named, 1),
                 timeout=300)
    return moved, held


def test_replan_moving_opt_placement_carries_the_moments(meshes, replan):
    """One step at zero_stage 0 on (2, 2), a replan onto the escalated
    plan (every dense ``opt_placement`` moves: ``pspecs_changed``), two
    more: the moments travel whole through the replan, land on 1/2 of
    each dense leaf, and the losses and final state equal the
    uninterrupted run's."""
    moved, held = replan
    base = meshes[(2, 2)][0][f"{PHI3}/0"]
    for r in moved:
        assert r["pspecs_changed"] and r["rebuilt"]
        assert r["before"]["zero_stage"] == 0
        assert r["after"]["zero_stage"] == 1
        for n, x in r["after"]["leaves"].items():
            assert r["before"]["leaves"][n]["share"] == 1
            assert x["share"] == (1 if x["sparse"] else 1 / 2), (n, x)
        _same(r["carried"], held[0])
        assert r["loss"] == base["loss"]
        _same(r["whole"], base["whole"])


def test_zero1_checkpoint_restores_across_meshes(tmp_path):
    """Saved at step 3 on a ZeRO-1 (2, 1) mesh (gathered whole, rank 0
    writes): restored on one device, on (2, 2) at zero_stage 0 and on
    (2, 1) at zero_stage 0, every rank's state is the saved one, and 3
    more steps continue the uninterrupted ZeRO-1 run: bit for bit on
    (2, 1), within the reference's bar (2e-5) on the other layouts,
    whose reductions differ."""
    d = str(tmp_path / "ckpt")
    saved = spawn(R.ckpt_rank, 2, "gloo", args=((2, 1), [
        ("whole6", 1, 6, None, False), ("save3", 1, 3, d, False)]),
        timeout=300)

    def copy(name):
        # each restoring run writes its own checkpoints: a copy each
        return shutil.copytree(d, str(tmp_path / name))

    back = spawn(R.ckpt_rank, 2, "gloo", args=((2, 1), [
        ("z0", 0, 6, copy("back"), True)]), timeout=300)
    grid = spawn(R.ckpt_rank, 4, "gloo", args=((2, 2), [
        ("z0", 0, 6, copy("grid"), True)]), timeout=300)
    one = R.ckpt_run(None, 0, 6, copy("one"), restore=True)
    ref = saved[0]["whole6"]
    state3 = saved[0]["save3"]["final"]
    assert saved[0]["save3"]["shares"]["layers.mlp.w_up"] == 1 / 2
    assert saved[0]["save3"]["loss"] == ref["loss"][:3]
    for r in back + grid + [one]:
        run = r["z0"] if "z0" in r else r
        assert run["start"] == 3 and run["zero_stage"] == 0
        assert all(s == 1 for s in run["shares"].values())
        _same(run["start_whole"], state3)
    for r in back:
        assert r["z0"]["loss"] == ref["loss"][3:]
        _same(r["z0"]["final"], ref["final"])
    for run in [r["z0"] for r in grid] + [one]:
        for a, b in zip(run["loss"], ref["loss"][3:]):
            assert abs(a - b) < 2e-5, (run["loss"], ref["loss"])


def test_launcher_trains_a_plan_the_escalation_took_to_zero1():
    """``launch/train.py --devices 4 --mesh 2x2`` (reduced phi3, its
    default RunConfig) with the card's memory set so that the default
    plan escalates to ZeRO-1: it trains, bit for bit the run whose plan
    does not escalate."""
    argv = ["--reduced", "--seq", "32", "--batch", "4", "--steps", "3",
            "--log-every", "100", "--devices", "4", "--mesh", "2x2"]
    runs = {esc: spawn(R.launcher_rank, 4, "gloo",
                       args=(argv, (2, 2), esc), timeout=300)
            for esc in (False, True)}
    for a, b in zip(runs[False], runs[True]):
        assert a["zero_stage"] == 0 and b["zero_stage"] == 1
        assert b["zero_leaves"] > 0 and a["zero_leaves"] == 0
        assert len(b["losses"]) == 3 and np.isfinite(b["losses"]).all()
        assert a["losses"] == b["losses"]
