"""The recurrent blocks and the routed experts tensor-parallel over
``model`` on gloo process meshes: the LSTM (parallax-lm under comm_mode
hybrid, ps and mpi; parallax-nmt's encoder and decoder), hymba's selective
SSM beside its tensor-parallel attention, rwkv6's time and channel mixes,
and grok-1's routed experts with their d_ff sharded under
``moe_exec="tp"``.

Reduced configs at f32, the reference correctness test's ``RunConfig``
(tests/test_transform_correctness.py; grok-1 with its SGD at 0.3 and
capacity factor 8), ``ShapeConfig("tiny", 32, 4)``, 3 steps from the JAX
package's seeded init on (1, 2), (2, 2) and (1, 4):

  * every step's loss within the reference test's bar (5e-4 + 1e-4·i) of
    the JAX package's one-device run (grok-1 on (2, 2): of the JAX
    package's (2, 1) run, whose data-parallel aux it shares);
  * every leaf's step-0 gradient, gathered whole, within rtol 1e-5 of the
    port's one device: the replicated leaves inside a tensor-parallel
    block (the SSM's ``w_b`` / ``w_c`` / ``dt_bias`` / ``a_log``, the
    RWKV's ``mu`` / ``w0`` / ``bonus`` / ``ln_w`` / LoRA) would be 1/M
    short without their sum over ``model``;
  * each rank holds 1/M of every model-sharded leaf (the LSTM's gate
    leaves gate-strided), ``held == placement``, and its parameter bytes
    are ``per_device_bytes``'s planned term; the gathered init is the JAX
    package's bit for bit.

Also: ZeRO-1 over the gate-strided LSTM blocks on (2, 2), bit for bit
zero_stage 0; a checkpoint written on (2, 2), restored on one device and
on (1, 4) (the same whole state) and continued within the bar of the
uninterrupted run; and with no ranks, every arch of the zoo and the
paper's two planned at full width on (2, 2), (1, 4) and (2, 4) under
``tp``: ``held == placement`` on every leaf and a rank's held parameter
bytes equal to the planned term.
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

import _torch_recurrent_tp_ranks as R
from conftest import distributed_run
from repro.configs import RunConfig, ShapeConfig, get_config, reduced
from repro.core.transform import get_runner as jget_runner
from repro.utils.tree import named_leaves
import repro_torch.configs as tc
from repro_torch.core.plan import per_device_bytes
from repro_torch.core.runtime import Runtime
from repro_torch.core.transform import analyze
from repro_torch.launch.mesh import MeshShape, spawn
from repro_torch.models.layers import flatten_specs
from repro_torch.models.model import build_model

pytestmark = pytest.mark.distributed

LM_MODES = {"hybrid": {"comm_mode": "hybrid"}, "ps": {"comm_mode": "ps"},
            "mpi": {"comm_mode": "mpi"}}
# key -> (arch, flags)
RUNS = {**{f"lm/{k}": (R.LM, f) for k, f in LM_MODES.items()},
        "nmt": (R.NMT, {}), "hymba": (R.HYMBA, {}), "rwkv": (R.RWKV, {}),
        "grok": (R.GROK, {})}
MESH_RUNS = {
    (1, 2): list(RUNS),
    (2, 2): list(RUNS),
    (1, 4): ["lm/hybrid", "lm/ps", "lm/mpi", "nmt"],
}
CASES = [(mesh, key) for mesh, keys in MESH_RUNS.items() for key in keys]
# the checkpoint: written after step 3 of (2, 2)'s lm/hybrid, which runs on
# to step 6 uninterrupted
SAVE_AT, LONG = 3, 6
# f32 products in another summation order (gloo's sums, split products)
TOL = dict(rtol=1e-5, atol=1e-6)
PLAN_MESHES = [(2, 2), (1, 4), (2, 4)]
PLAN_CASES = [(a, m) for a in tc.ALL_ARCHS + tc.PAPER_ARCHS
              for m in PLAN_MESHES]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_run(arch: str):
    c = reduced(get_config(arch))
    kw = R.MOE_KW if arch == R.GROK else R.KW
    if c.n_experts:
        c = dataclasses.replace(c, moe_capacity_factor=8.0)
    jr = jget_runner(c, ShapeConfig("tiny", R.SEQ, R.BATCH, "train"),
                     RunConfig(**kw), seed=0)
    named = {n: np.asarray(a) for n, a in named_leaves(jr.state.params)}
    return named, [float(jr.run(b)["loss"]) for b in R.batches(arch)]


_DATA_PARALLEL = """
import dataclasses
from repro.configs import get_config, reduced, RunConfig, ShapeConfig
from repro.core.transform import get_runner
from repro.data import SyntheticLM
cfg = dataclasses.replace(reduced(get_config("grok-1-314b")),
                          moe_capacity_factor=8.0)
ds = SyntheticLM(cfg.vocab_size, {seq}, {batch})
mesh = make_mesh((2, 1), ("data", "model"))
with use_mesh(mesh):
    run = get_runner(cfg, ShapeConfig("tiny", {seq}, {batch}, "train"),
                     RunConfig(**{kw!r}), mesh=mesh)
    out = [float(run.run(ds.batch(i))["loss"]) for i in range({steps})]
print("RESULT:" + json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference():
    """Per arch: the JAX package's seeded parameters and one-device
    losses, and the port's one-device losses and step-0 gradients from
    them; grok-1's losses on the JAX package's (2, 1) mesh."""
    out = {}
    for arch in (R.LM, R.NMT, R.HYMBA, R.RWKV, R.GROK):
        named, losses = _jax_run(arch)
        out[arch] = {"named": named, "jax": losses,
                     "port": R.one_device(arch, named)}
    out["grok/2x1"] = distributed_run(_DATA_PARALLEL.format(
        kw=R.MOE_KW, seq=R.SEQ, batch=R.BATCH, steps=R.STEPS),
        devices=2, timeout=300)
    return out


@pytest.fixture(scope="module")
def meshes(reference, tmp_path_factory):
    ckpt = str(tmp_path_factory.mktemp("recurrent_ckpt"))
    out = {}
    for mesh, keys in MESH_RUNS.items():
        cases = []
        for key in keys:
            arch, flags = RUNS[key]
            long = mesh == (2, 2) and key == "lm/hybrid"
            cases.append((key, arch, flags, reference[arch]["named"],
                          LONG if long else R.STEPS,
                          SAVE_AT if long else None))
        if mesh == (2, 2):
            cases.append(("lm/zero1", R.LM, {"zero_stage": 1},
                          reference[R.LM]["named"], LONG, None))
        out[mesh] = spawn(R.train_rank, mesh[0] * mesh[1], "gloo",
                          args=(mesh, cases, ckpt), timeout=600)
    named = reference[R.LM]["named"]
    out["restored"] = {
        (1, 4): spawn(R.restore_rank, 4, "gloo",
                      args=((1, 4), R.LM, named, ckpt, SAVE_AT, LONG),
                      timeout=300),
        None: [R.restore_rank(0, 1, None, R.LM, named, ckpt, SAVE_AT,
                              LONG)]}
    return out


def _within_bar(got, want, what):
    for i, (a, b) in enumerate(zip(got, want)):
        assert abs(a - b) < 5e-4 + 1e-4 * i, (what, i, got, want)


@pytest.mark.parametrize("mesh,key", CASES,
                         ids=["x".join(map(str, m)) + "-" + k
                              for m, k in CASES])
def test_trains_on_the_mesh_as_on_one_device(reference, meshes, mesh, key):
    arch, _ = RUNS[key]
    ref = reference[arch]
    ranks = [r[key] for r in meshes[mesh]]
    got = ranks[0]["loss"][:R.STEPS]
    assert all(r["loss"] == ranks[0]["loss"] for r in ranks), key
    _within_bar(ref["port"]["loss"], ref["jax"], "port one device")
    if arch == R.GROK and mesh[0] > 1:
        # the aux is a mean over the data shards: the data-parallel run
        _within_bar(got, reference["grok/2x1"], key)
    else:
        _within_bar(got, ref["jax"], key)
        for n, g in ref["port"]["grads"].items():
            np.testing.assert_allclose(ranks[0]["grads"][n], g, err_msg=n,
                                       **TOL)
    m = mesh[1]
    for r in ranks:
        assert r["held_is_placement"] and r["init_equal"], key
        assert r["bytes"] == r["plan_bytes"], (r["bytes"], r["plan_bytes"])
        blocks = [n for n in r["model_sharded"]
                  if n not in ("embed", "enc_embed", "head")]
        # every block the family runs over model is sharded
        assert blocks, key
        for n in blocks:
            # 1/M over model, and 1/D more where the plan puts an fsdp
            # leaf's other dimension on data
            assert r["shards"][n] % m == 0, (n, r["shards"][n])
            assert r["shares"][n] == 1 / r["shards"][n], (n, r["shares"][n])


@pytest.mark.parametrize("mesh", [(1, 2), (2, 2), (1, 4)],
                         ids=["1x2", "2x2", "1x4"])
def test_each_family_shards_its_recurrent_blocks(meshes, mesh):
    """The leaves the tentpole moves onto the model axis: the LSTM's
    gates and projection, the SSM's channel products, the RWKV's head and
    d_ff products, the routed experts' d_ff."""
    want = {
        "lm/hybrid": {"layers.w_x", "layers.w_h", "layers.bias",
                      "layers.w_proj"},
        "nmt": {"enc_layers.w_x", "enc_layers.w_h", "enc_layers.bias",
                "enc_layers.w_proj", "layers.w_x", "layers.w_proj"},
        "hymba": {"layers.ssm.w_in", "layers.ssm.w_gate", "layers.ssm.w_dt",
                  "layers.ssm.w_out"},
        "rwkv": {"layers.tm.w_r", "layers.tm.w_k", "layers.tm.w_v",
                 "layers.tm.w_g", "layers.tm.w_o", "layers.cm.w_in",
                 "layers.cm.w_out"},
        "grok": {"layers.moe.w_gate", "layers.moe.w_up",
                 "layers.moe.w_down"},
    }
    for key, leaves in want.items():
        if key not in MESH_RUNS[mesh]:
            continue
        for r in meshes[mesh]:
            assert leaves <= set(r[key]["model_sharded"]), key
            for n in leaves:
                assert r[key]["shards"][n] % mesh[1] == 0, (key, n)
                assert r[key]["shares"][n] == 1 / r[key]["shards"][n], \
                    (key, n)
    if "rwkv" in MESH_RUNS[mesh]:
        # the SSM's and the WKV's replicated leaves stay whole
        r = meshes[mesh][0]
        for n in ("layers.ssm.w_b", "layers.ssm.a_log"):
            assert r["hymba"]["shares"][n] == 1
        for n in ("layers.tm.mu", "layers.tm.bonus", "layers.cm.w_recv"):
            assert r["rwkv"]["shares"][n] == 1


def test_zero1_over_gate_strided_blocks_is_bit_equal(meshes):
    """(2, 2): ZeRO-1 holds 1/D of each dense moment beside the gate-
    strided LSTM blocks, and its 6 steps are zero_stage 0's bit for bit:
    every loss, and the whole parameters and moments after them."""
    for r in meshes[(2, 2)]:
        z0, z1 = r["lm/hybrid"], r["lm/zero1"]
        assert z1["zero_leaves"] > 0 and z0["zero_leaves"] == 0
        assert z1["loss"] == z0["loss"]
        assert set(z1["final"]) == set(z0["final"])
        for k, a in z0["final"].items():
            np.testing.assert_array_equal(z1["final"][k], a, err_msg=k)


def test_checkpoint_restores_across_meshes(meshes):
    """Written whole after step 3 on (2, 2): one device and (1, 4) restore
    the same state bit for bit (the gate-strided blocks cut and gathered
    on 4 model ranks), and their steps 4-6 lie within the bar of the
    uninterrupted (2, 2) run's."""
    long = meshes[(2, 2)][0]["lm/hybrid"]["loss"]
    one = meshes["restored"][None][0]
    quad = meshes["restored"][(1, 4)]
    assert one["step"] == SAVE_AT and all(r["step"] == SAVE_AT for r in quad)
    for r in quad:
        assert set(r["restored"]) == set(one["restored"])
        for k, a in one["restored"].items():
            np.testing.assert_array_equal(r["restored"][k], a, err_msg=k)
        assert r["loss"] == quad[0]["loss"]
    _within_bar(one["loss"], long[SAVE_AT:], "one device")
    _within_bar(quad[0]["loss"], long[SAVE_AT:], "(1, 4)")


@pytest.mark.parametrize("arch,mesh", PLAN_CASES,
                         ids=[f"{a}-{m[0]}x{m[1]}" for a, m in PLAN_CASES])
def test_full_width_plans_hold_every_placement(arch, mesh):
    """No ranks: the published width on the meta device, planned on a
    ``MeshShape`` under ``tp`` at ``launch/train.py``'s default shape."""
    rt = Runtime(tc.get_config(arch), tc.RunConfig(dense_strategy="tp"),
                 tc.ShapeConfig("train", 512, 8, "train"),
                 mesh=MeshShape(mesh, ("data", "model")), device="meta")
    model = build_model(rt.model_cfg, rt)
    plan = analyze(model, rt)
    specs = flatten_specs(model.specs())
    for name, p in plan.params.items():
        assert p.held == p.placement, (name, p.held, p.placement)
    plans = [plan.params[n] for n, _ in specs]
    # the parameter term always; the moments too unless a fused apply
    # keeps its bucketed moments whole
    assert per_device_bytes(specs, plan.rules, plans, opt_bytes=0,
                            held=True) == \
        per_device_bytes(specs, plan.rules, plans, opt_bytes=0)
    if not plan.fused_apply:
        assert per_device_bytes(specs, plan.rules, plans, held=True) == \
            per_device_bytes(specs, plan.rules, plans)
    # a rank's held shape of each leaf is the planned share of the whole
    m = math.prod(mesh)
    for name, spec in specs:
        p = plan.params[name]
        shards = math.prod(rt.mesh.axes_size((a,) if isinstance(a, str)
                                             else a)
                           for a in p.held if a is not None)
        assert shards <= m and math.prod(spec.shape) % shards == 0, name
