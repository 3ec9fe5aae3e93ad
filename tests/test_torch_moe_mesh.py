"""The port's MoE on gloo process meshes: the counterparts of
tests/test_moe.py::test_ep_equals_tp_distributed and of
tests/test_transform_correctness.py's grok-1 case.

  * ``all_to_all`` (core/collectives.py) over 4 ranks for every (split,
    concat) pair of a 3-d tensor: the blocks land where
    ``jax.lax.all_to_all`` puts them, the swapped call brings them home,
    and the gradient is the inverse all-to-all of the upstream gradient.
  * ``moe_ffn`` on (2, 4) and (2, 2), under ``ep`` (the default: the
    model axis divides the 8 experts) and ``tp``, with the sequence split
    over ``model`` (seq 8) and without it (seq 6 on (2, 4): every model
    rank routes the same tokens), and llama4's top-1 with the shared
    expert: each rank's output within 1e-4 of the port's one-device
    ``moe_ffn`` and of the JAX package's; the gradients of
    sum(out * w) + moe_aux, averaged over the replicas as the step
    averages them, within 1e-4 (1e-4 of their scale) of the one-device
    gradients of sum(out * w) / D + the mean of each token shard's aux;
    under ``ep`` each rank holds E/M experts, under ``tp`` its d_ff/M
    block of every expert (the outputs summed over ``model``).
  * Reduced grok-1 trains 3 steps on (2, 4) and (2, 2) under comm_mode
    hybrid and mpi (``ep``) and hybrid with ``moe_exec="tp"``, capacity
    factor 8 (no drops), SGD at 0.3, f32, from the JAX package's
    parameters: every ``ep`` step within 5e-4 + 1e-4·i of the port's
    one-device run, which is within the same bar of the JAX package's;
    every ``tp`` step within that bar of the JAX package on a (2, 1) mesh
    (two devices), whose data-parallel trajectory it is. Each rank's
    expert leaves are 1/M of the whole under ``ep`` (on the experts) and
    under ``tp`` (on d_ff);
    a seeded init gives every rank its slice of the one-device draw.

The JAX package runs on one device, and once on two, here: the (2, 4) and
(2, 2) meshes are held against those values.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_moe_ranks as R
from conftest import distributed_run
from repro.configs import RunConfig, ShapeConfig, get_config, reduced
from repro.core.runtime import Runtime as JRuntime
from repro.core.transform import get_runner as jget_runner
from repro.models import moe as jmoe
from repro.models.layers import init_tree
from repro.utils.tree import named_leaves
import repro_torch.configs as tc
from repro_torch.core.transform import get_runner
from repro_torch.launch.mesh import spawn
from repro_torch.models import moe
from repro_torch.weights import load_reference_params

pytestmark = pytest.mark.distributed

GROK, LLAMA4 = "grok-1-314b", "llama4-maverick-400b-a17b"
# name -> (mesh, arch, k, moe_exec, seq)
FFN_CASES = {
    "2x4-ep": ((2, 4), GROK, 2, "auto", 8),
    "2x4-tp": ((2, 4), GROK, 2, "tp", 8),
    "2x4-ep-unsplit": ((2, 4), GROK, 2, "auto", 6),
    "2x2-ep": ((2, 2), GROK, 2, "auto", 8),
    "2x2-tp": ((2, 2), GROK, 2, "tp", 8),
    "2x2-ep-llama4": ((2, 2), LLAMA4, 1, "auto", 8),
}
MESHES = [(2, 4), (2, 2)]


def _jcfg(arch, k):
    c = reduced(get_config(arch), d_model=16, d_ff=32, experts=8)
    return type(c)(**{**c.__dict__, "experts_per_token": k,
                      "moe_capacity_factor": 8.0})


def _inputs(arch, k, seq):
    """The JAX package's seeded layer, x and the loss weights w."""
    jc = _jcfg(arch, k)
    params = init_tree(jax.random.key(0), jmoe.moe_specs(jc, "tp"),
                       jnp.float32)
    x = jax.random.normal(jax.random.key(1), (R.FFN_BATCH, seq, 16),
                          jnp.float32)
    rng = np.random.default_rng(2)
    w = rng.standard_normal((R.FFN_BATCH, seq, 16)).astype(np.float32)
    return ({n: np.asarray(a) for n, a in params.items()}, np.asarray(x), w)


def _jax_out(arch, k, params, x):
    jc = _jcfg(arch, k)
    rt = JRuntime(jc, RunConfig(**R.KW), ShapeConfig("t", x.shape[1],
                                                     R.FFN_BATCH, "train"))
    out, _ = jmoe.moe_ffn({n: jnp.asarray(a) for n, a in params.items()},
                          jnp.asarray(x), cfg=jc, rt=rt, exec_mode="tp")
    return np.asarray(out)


def _one_device(arch, k, params, x, w, mesh, split):
    """The port's one-device output of x, and the gradients of
    sum(out * w) / D + mean over the mesh's token shards of each shard's
    aux (the loss whose gradient the mesh's replica average is)."""
    cfg = R.ffn_cfg(arch, k)
    d, m = mesh
    rt = R.ffn_rt(cfg, x.shape[1])
    p = {n: torch.from_numpy(a.copy()).requires_grad_()
         for n, a in params.items()}
    xt = torch.from_numpy(x.copy()).requires_grad_()
    out, _ = moe.moe_ffn(p, xt, cfg=cfg, rt=rt, exec_mode="tp")
    shards = []
    b, s = R.FFN_BATCH // d, x.shape[1] // (m if split else 1)
    for i in range(d):
        for j in range(m if split else 1):
            xs = xt[i * b:(i + 1) * b, j * s:(j + 1) * s]
            shards.append(moe.moe_ffn(p, xs, cfg=cfg,
                                      rt=R.ffn_rt(cfg, s), exec_mode="tp")
                          [1]["moe_aux"])
    loss = (out * torch.from_numpy(w)).sum() / d + torch.stack(shards).mean()
    loss.backward()
    return (out.detach().numpy(), xt.grad.numpy(),
            {n: t.grad.numpy() for n, t in p.items()})


@pytest.fixture(scope="module")
def ffn_runs():
    inputs = {name: _inputs(arch, k, seq)
              for name, (_, arch, k, _, seq) in FFN_CASES.items()}
    out = {}
    for mesh in MESHES:
        cases = [(name, arch, k, mode, *inputs[name])
                 for name, (ms, arch, k, mode, seq) in FFN_CASES.items()
                 if ms == mesh]
        ranks = spawn(R.ffn_rank, mesh[0] * mesh[1], "gloo",
                      args=(mesh, cases), timeout=300)
        for name, *_ in cases:
            out[name] = [r[name] for r in ranks]
    return inputs, out


def _close(got, want, what):
    scale = float(np.abs(want).max()) or 1.0
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * scale,
                               err_msg=what)


@pytest.mark.parametrize("name", list(FFN_CASES))
def test_moe_ffn_on_the_mesh_equals_one_device(ffn_runs, name):
    (d, m), arch, k, mode, seq = FFN_CASES[name]
    params, x, w = ffn_runs[0][name]
    ranks = ffn_runs[1][name]
    ep = mode == "auto"
    split = ep and seq % m == 0
    assert all(r["exec"] == ("ep" if ep else "tp") for r in ranks)
    want_out, want_xg, want_g = _one_device(arch, k, params, x, w, (d, m),
                                            split)
    jout = _jax_out(arch, k, params, x)
    _close(want_out, jout, "one device vs the JAX package")
    b = R.FFN_BATCH // d
    e_loc = 8 // m if ep else 8
    for rank, r in enumerate(ranks):
        i, j = divmod(rank, m)
        rows = slice(i * b, (i + 1) * b)
        _close(r["out"], want_out[rows], f"rank {rank} output")
        _close(r["out"], jout[rows], f"rank {rank} vs the JAX package")
        # the step scales every replica's gradient by 1/D
        _close(r["x_grad"] / d, want_xg[rows], f"rank {rank} x grad")
        assert r["dropped"] == 0
        for n in R.EXPERTS:
            assert r["shapes"][n][0] == e_loc, (n, r["shapes"][n])
            f_dim = 1 if n == "w_down" else 2
            assert r["shapes"][n][f_dim] == (32 if ep else 32 // m), \
                (n, r["shapes"][n])
    # every gradient averaged over the replicas, as the step's exchange
    for j in range(m):
        reps = [ranks[i * m + j] for i in range(d)]
        for n, g in want_g.items():
            got = np.mean([r["grads"][n] for r in reps], axis=0)
            want = g
            if ep and n in R.EXPERTS:
                want = g[j * e_loc:(j + 1) * e_loc]
            elif n in R.EXPERTS:
                # tp: this model rank's block of every expert's d_ff
                dim = 1 if n == "w_down" else 2
                f_loc = g.shape[dim] // m
                want = np.take(g, range(j * f_loc, (j + 1) * f_loc),
                               axis=dim)
            _close(got, want, f"model rank {j}: {n}")


def test_all_to_all_round_trip_and_gradient():
    ranks = spawn(R.a2a_rank, 4, "gloo", timeout=120)
    for (split, concat), _ in ranks[0].items():
        xs = [r[(split, concat)]["x"] for r in ranks]
        for me, r in enumerate(ranks):
            got = r[(split, concat)]
            # jax.lax.all_to_all: block `me` of every rank's split dim,
            # concatenated along concat in rank order
            want = np.concatenate(
                [np.split(x, 4, axis=split)[me] for x in xs], axis=concat)
            np.testing.assert_array_equal(got["y"], want)
            np.testing.assert_array_equal(got["back"], got["x"])
            # the gradient: each rank's upstream block `me` sent home
            cs = [q[(split, concat)]["c"] for q in ranks]
            grad = np.concatenate(
                [np.split(c, 4, axis=concat)[me] for c in cs], axis=split)
            np.testing.assert_array_equal(got["grad"], grad)


@pytest.fixture(scope="module")
def grok_reference():
    """The JAX package's and the port's one-device losses from the JAX
    package's seeded parameters, and the JAX package's on a (2, 1) mesh of
    two devices (its aux averaged over the two data shards)."""
    cfg = reduced(get_config(GROK))
    cfg = type(cfg)(**{**cfg.__dict__, "moe_capacity_factor": 8.0})
    jr = jget_runner(cfg, ShapeConfig("tiny", R.SEQ, R.BATCH, "train"),
                     RunConfig(**R.TRAIN_KW), seed=0)
    named = {n: np.asarray(a) for n, a in named_leaves(jr.state.params)}
    c = R.train_cfg()
    jl = [float(jr.run(b)["loss"]) for b in R.batches(c.vocab_size)]
    one = get_runner(c, tc.ShapeConfig("tiny", R.SEQ, R.BATCH, "train"),
                     tc.RunConfig(**R.TRAIN_KW), device="cpu",
                     params=load_reference_params(named, "cpu"))
    pl = [float(one.run(b)["loss"]) for b in R.batches(c.vocab_size)]
    data_parallel = distributed_run(_DATA_PARALLEL.format(
        kw=R.TRAIN_KW, seq=R.SEQ, batch=R.BATCH, steps=R.STEPS),
        devices=2, timeout=300)
    return named, jl, pl, data_parallel


_DATA_PARALLEL = """
import dataclasses
from repro.configs import get_config, reduced, RunConfig, ShapeConfig
from repro.core.transform import get_runner
from repro.data import SyntheticLM
cfg = dataclasses.replace(reduced(get_config("grok-1-314b")),
                          moe_capacity_factor=8.0)
shape = ShapeConfig("tiny", {seq}, {batch}, "train")
ds = SyntheticLM(cfg.vocab_size, {seq}, {batch})
mesh = make_mesh((2, 1), ("data", "model"))
with use_mesh(mesh):
    run = get_runner(cfg, shape, RunConfig(**{kw!r}), mesh=mesh)
    out = [float(run.run(ds.batch(i))["loss"]) for i in range({steps})]
print("RESULT:" + json.dumps(out))
"""


def _within_bar(got, want, what):
    for i, (a, b) in enumerate(zip(got, want)):
        assert abs(a - b) < 5e-4 + 1e-4 * i, (what, i, got, want)


@pytest.mark.parametrize("mesh", MESHES, ids=["2x4", "2x2"])
def test_grok_trains_on_the_mesh_as_on_one_device(grok_reference, mesh):
    """``ep`` (hybrid, mpi) within the reference test's bar of one device.
    ``tp`` routes each replica's rows whole, so its trajectory is the data-
    parallel one: the aux is averaged over the data shards, which moves
    the router under SGD at 0.3 by more than the bar in both packages; it
    is held to the JAX package's (2, 1) mesh instead."""
    named, jax_losses, port_losses, data_parallel = grok_reference
    _within_bar(port_losses, jax_losses, "one device")
    ranks = spawn(R.train_rank, mesh[0] * mesh[1], "gloo",
                  args=(mesh, named), timeout=300)
    e = R.train_cfg().n_experts
    for name in R.RUNS:
        got = ranks[0][name]["loss"]
        assert all(r[name]["loss"] == got for r in ranks), name
        ep = name != "tp"
        _within_bar(got, port_losses if ep else data_parallel, name)
        assert ranks[0][name]["exec"] == ("ep" if ep else "tp")
        assert ranks[0][name]["dropped"] == [0.0] * R.STEPS
        f = R.train_cfg().d_ff
        for r in ranks:
            for n in ("layers.moe.w_gate", "layers.moe.w_up",
                      "layers.moe.w_down"):
                shape = r[name]["shapes"][n]
                assert shape[1] == (e // mesh[1] if ep else e), (name, n)
                # tp: each rank's block of every expert's d_ff
                f_dim = 2 if n.endswith("w_down") else 3
                assert shape[f_dim] == (f if ep else f // mesh[1]), \
                    (name, n, shape)
    assert all(r["init_equal"] for r in ranks)
