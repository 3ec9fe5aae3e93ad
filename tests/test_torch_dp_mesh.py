"""The ``dp`` dense strategy on gloo process meshes: the model axis joins
the batch axes (no tensor or sequence parallelism, tables not row-sharded,
FSDP over ``(data, model)`` where the plan stamps it). The port of the
reference's ``tests/test_perf_paths.py::test_perf_paths_exact`` dp cases
(reduced phi3, hymba and rwkv6; phi3 with ``explicit_sp=True,
dense_strategy="auto"``) on (2, 2) — the reference's mesh is (2, 4) — at
the reference test's RunConfig (f32, naive attention, no remat) and
``ShapeConfig("tiny", 32, 8)``, 3 steps from the JAX package's seeded
init: every step's loss within the reference's bar, 2e-5, of the JAX
package's one-device run. Beyond the reference's cases: phi3 under
``comm_mode`` ps (every dense leaf FSDP over both axes, the table on
mpi_gatherv) and mpi, hymba with ZeRO-1 over both axes, and reduced
grok-1 (the moe family's experts whole under dp, ``moe_exec="ep"`` too).

Also: ``auto`` resolves as the reference's ``pick_dense_strategy`` for
the archs of ``test_auto_strategy_picks_sensibly``; under dp no
collective of a step runs over the model axis alone (in particular no
``copy_to`` / ``reduce_from`` of a tensor-parallel block); every leaf's
``held`` is its placement, with the model axis only beside ``data`` in an
FSDP entry.
"""
import numpy as np
import pytest
import torch

import _torch_zero_ranks as R
from repro.configs import SHAPES, RunConfig, ShapeConfig, get_config, reduced
from repro.core.cost_model import MeshDims as JMeshDims
from repro.core.cost_model import pick_dense_strategy as jpick
from repro.core.transform import get_runner as jget_runner
from repro.utils.tree import named_leaves
import repro_torch.configs as tc
from repro_torch.core import cost_model
from repro_torch.core.runtime import Runtime
from repro_torch.launch.mesh import MeshShape, spawn

pytestmark = pytest.mark.distributed

PHI3, HYMBA, RWKV = "phi3-medium-14b", "hymba-1.5b", "rwkv6-7b"
BAR = 2e-5
DP = {"dense_strategy": "dp"}
# key -> (arch, RunConfig flags)
CASES = {
    "phi3/dp": (PHI3, DP),
    "hymba/dp": (HYMBA, DP),
    "rwkv6/dp": (RWKV, DP),
    "phi3/sp-auto": (PHI3, {"explicit_sp": True, "dense_strategy": "auto"}),
    "phi3/dp-ps": (PHI3, dict(DP, comm_mode="ps")),
    "phi3/dp-mpi": (PHI3, dict(DP, comm_mode="mpi")),
    "hymba/dp-zero1": (HYMBA, dict(DP, zero_stage=1)),
}
DP_CASES = [k for k, (_, f) in CASES.items()
            if f.get("dense_strategy") == "dp"]
# the moe family under dp, from the port's seed-0 init: the default
# moe_exec and a forced "ep", which the model axis cannot carry under dp
GROK = "grok-1-314b"
MOE_CASES = {"grok/dp": (GROK, DP),
             "grok/dp-ep": (GROK, dict(DP, moe_exec="ep"))}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def reference():
    out = {}
    for arch in (PHI3, HYMBA, RWKV):
        jr = jget_runner(reduced(get_config(arch)),
                         ShapeConfig("tiny", *R.SHAPE, "train"),
                         RunConfig(**R.KW), seed=0)
        named = {n: np.asarray(a) for n, a in named_leaves(jr.state.params)}
        out[arch] = (named, [float(jr.run(b)["loss"])
                             for b in R.batches(arch)])
    return out


@pytest.fixture(scope="module")
def ranks(reference):
    cases = [(k, a, f, reference[a][0]) for k, (a, f) in CASES.items()]
    cases += [(k, a, f, None) for k, (a, f) in MOE_CASES.items()]
    return spawn(R.dp_rank, 4, "gloo", args=((2, 2), cases), timeout=400)


@pytest.mark.parametrize("key", list(CASES))
def test_dp_steps_equal_one_device(reference, ranks, key):
    arch = CASES[key][0]
    want = reference[arch][1]
    got = ranks[0][key]["loss"]
    assert all(r[key]["loss"] == got for r in ranks)
    for i, (a, b) in enumerate(zip(got, want)):
        assert abs(a - b) < BAR, (key, i, got, want)


@pytest.mark.parametrize("key", DP_CASES + list(MOE_CASES))
def test_dp_layout(ranks, key):
    """The model axis is a batch axis: four replicas, the vocab whole
    (the lookup names no row axis), no leaf tensor-parallel; ``held`` is
    the placement, and ``model`` appears in it only beside ``data`` in
    an FSDP leaf's entry."""
    for r in ranks:
        x = r[key]
        assert x["strategy"] == "dp"
        assert x["batch_axes"] == ("data", "model") and x["replicas"] == 4
        assert x["vocab_shards"] == 1 and x["row_axis"] == ""
        for n, leaf in x["leaves"].items():
            assert leaf["held_is_placement"], n
            assert leaf["model_in_held"] == (n in x["fsdp"]), n
        assert x["bytes"] == x["plan_bytes"] == x["plan_bytes_planned"]


def test_collectives_over_both_axes_take_data_major_order(ranks):
    """``all_gather`` / ``reduce_scatter`` over ``("data", "model")``: the
    blocks in the order ``add_fsdp``'s two-axis entry implies, as JAX's
    ``P(("data", "model"))`` lays them out (data major: rank (d, m) holds
    block 2d + m on (2, 2))."""
    for r in ranks:
        d, m, me = r["order"]["coords"]
        assert me == 2 * d + m
        assert r["order"]["gathered"] == [0.0, 1.0, 2.0, 3.0]
        assert r["order"]["scattered"] == [me * 10.0]


def test_dp_ps_runs_fsdp_over_both_axes(ranks):
    """comm_mode ps under dp: no row shards for the PS (``can_shard_rows``
    is False), so the table goes to mpi_gatherv and every dense leaf to
    FSDP over (data, model): each rank 1/4 of it, all-gathered before the
    forward and reduce-scattered after the backward over both axes."""
    x = ranks[0]["phi3/dp-ps"]
    assert x["methods"] == {"embed": "mpi_gatherv"}
    dense = [n for n, leaf in x["leaves"].items() if not leaf["sparse"]]
    assert sorted(dense) == x["fsdp"]
    whole = ranks[0]["phi3/dp"]["leaves"]
    for n in dense:
        p, w = x["leaves"][n]["param"], whole[n]["param"]
        assert np.prod(p) * 4 == np.prod(w), (n, p, w)
    kinds = {(c, a) for c, a in x["collectives"]}
    assert ("all-gather", ("data", "model")) in kinds
    assert ("reduce-scatter", ("data", "model")) in kinds


@pytest.mark.parametrize("key", DP_CASES + list(MOE_CASES))
def test_dp_issues_no_model_axis_collective(ranks, key):
    """The collectives of one step: every one spans both batch axes
    (``model`` never alone: no tensor-parallel ``copy_to`` /
    ``reduce_from``, no vocab-shard pull), and the mesh's step issues
    some."""
    for r in ranks:
        calls = r[key]["collectives"]
        assert calls
        for name, axes in calls:
            assert set(axes) == {"data", "model"}, (name, axes)


def test_dp_moe_runs_its_experts_whole(ranks):
    """The moe family under dp: every expert on every rank, so a forced
    ``moe_exec="ep"`` (whose all-to-all would move tokens over a batch
    axis) runs as the default does, bit for bit."""
    for r in ranks:
        ep, base = r["grok/dp-ep"], r["grok/dp"]
        assert ep["moe_exec"] == "ep"
        assert ep["leaves"]["layers.moe.w_gate"]["param"] == \
            base["leaves"]["layers.moe.w_gate"]["param"]
        assert all(np.isfinite(ep["loss"]))
        assert ep["loss"] == base["loss"]
        for k, a in base["whole"].items():
            np.testing.assert_array_equal(ep["whole"][k], a, err_msg=k)


def test_dp_zero1_shards_moments_over_both_axes(ranks):
    """hymba under dp with ZeRO-1: each dense moment is 1/4 of its leaf
    (over data x model), the sparse table's whole, and the run is bit for
    bit the dp run without it."""
    for r in ranks:
        z, base = r["hymba/dp-zero1"], r["hymba/dp"]
        assert z["zero_stage"] == 1 and not z["fused_apply"]
        for n, leaf in z["leaves"].items():
            assert leaf["share"] == leaf["plan_share"], n
            assert leaf["share"] == (1 if leaf["sparse"] else 1 / 4), n
        assert z["loss"] == base["loss"]
        for k, a in base["whole"].items():
            np.testing.assert_array_equal(z["whole"][k], a, err_msg=k)


def test_sp_auto_resolves_to_tp_at_this_width(ranks):
    """phi3 reduced on (2, 2) at 256 tokens: ``auto`` prices tp+sp below
    dp (``pick_dense_strategy``), so the reference's explicit-SP case
    runs tensor-parallel here."""
    x = ranks[0]["phi3/sp-auto"]
    assert x["strategy"] == "tp" and x["batch_axes"] == ("data",)
    dims = cost_model.MeshDims(model=2, data=2)
    want = jpick(reduced(get_config(PHI3)), ShapeConfig("t", 32, 8, "train"),
                 JMeshDims(model=2, data=2))
    got = cost_model.pick_dense_strategy(
        tc.reduced(tc.get_config(PHI3)), tc.ShapeConfig("t", 32, 8, "train"),
        dims)
    assert got == want == "tp"


AUTO = [("hymba-1.5b", "train_4k"), ("phi3-medium-14b", "train_4k"),
        ("grok-1-314b", "train_4k"), ("llama4-maverick-400b-a17b",
                                      "train_4k"),
        ("hymba-1.5b", "decode_32k")]


@pytest.mark.parametrize("arch,shape", AUTO,
                         ids=[f"{a}-{s}" for a, s in AUTO])
def test_auto_resolves_as_the_reference(arch, shape):
    """``dense_strategy="auto"`` on a 16 x 16 mesh: the port's
    ``pick_dense_strategy`` and ``Runtime.resolved_strategy`` give what
    the reference's picks (hymba dp; the moe archs and decode tp)."""
    want = jpick(get_config(arch), SHAPES[shape],
                 JMeshDims(model=16, data=16))
    s = tc.SHAPES[shape]
    got = cost_model.pick_dense_strategy(tc.get_config(arch), s,
                                         cost_model.MeshDims(model=16,
                                                             data=16))
    rt = Runtime(tc.get_config(arch), tc.RunConfig(dense_strategy="auto"),
                 s, mesh=MeshShape((16, 16), ("data", "model")),
                 device="meta")
    assert got == want == rt.resolved_strategy
    if arch == "hymba-1.5b":
        assert got == ("dp" if shape == "train_4k" else "tp")
    if "grok" in arch or "llama4" in arch:
        assert got == "tp"
