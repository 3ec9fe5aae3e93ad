"""The ranks of tests/test_torch_moe_mesh.py: spawned processes
(``launch/mesh.py::spawn``) that run the port's MoE on a gloo process mesh.
They import the port alone, not the JAX package."""
import dataclasses

import torch

import repro_torch.configs as tc
from repro_torch.core import collectives as coll
from repro_torch.core.runtime import Runtime
from repro_torch.core.transform import get_runner, init_params_
from repro_torch.data import SyntheticLM
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import moe
from repro_torch.models.model import build_model
from repro_torch.utils.tree import named_parameters
from repro_torch.weights import load_reference_params, shard_tensor

# tests/test_moe.py::test_ep_equals_tp_distributed's layer: reduced grok-1
# at d 16, d_ff 32, 8 experts, top-2, capacity factor 8 (no drops), f32
KW = dict(attention_impl="naive", remat="none", compute_dtype="float32",
          param_dtype="float32", wire_dtype="float32")
FFN_BATCH = 4
EXPERTS = ("w_gate", "w_up", "w_down")


def ffn_cfg(arch: str = "grok-1-314b", k: int = 2):
    c = tc.reduced(tc.get_config(arch), d_model=16, d_ff=32, experts=8)
    return dataclasses.replace(c, experts_per_token=k,
                               moe_capacity_factor=8.0)


def ffn_rt(cfg, seq: int, mesh=None, mode: str = "auto"):
    return Runtime(cfg, tc.RunConfig(**KW, moe_exec=mode),
                   tc.ShapeConfig("t", seq, FFN_BATCH, "train"), mesh=mesh,
                   device="cpu")


def ffn_rank(rank, world, mesh_shape, cases):
    """``cases``: [(name, arch, k, mode, params {name: numpy}, x (B, S, D),
    w (B, S, D))]. Each: this rank's ``moe_ffn`` of its replica's rows
    under ``mode`` (its experts under ``ep``, its block of every expert's
    d_ff under ``tp``) and its gradients of sum(out * w) + moe_aux."""
    m = make_mesh(mesh_shape, ("data", "model"), device="cpu")
    out = {}
    for name, arch, k, mode, params, x, w in cases:
        cfg = ffn_cfg(arch, k)
        rt = ffn_rt(cfg, x.shape[1], m, mode)
        exec_mode = moe.pick_exec_mode(cfg, rt)
        n_data, n_model = m.shape["data"], m.shape["model"]
        rows = slice(m.index("data") * FFN_BATCH // n_data,
                     (m.index("data") + 1) * FFN_BATCH // n_data)
        p = {}
        for n, a in params.items():
            t = torch.from_numpy(a.copy())
            j = m.index("model")
            if exec_mode == "ep" and n in EXPERTS:
                e_loc = cfg.n_experts // n_model
                t = t[j * e_loc:(j + 1) * e_loc].clone()
            elif n in EXPERTS:
                # tp: this rank's block of every expert's d_ff
                f_loc = cfg.d_ff // n_model
                dim = 1 if n == "w_down" else 2
                t = t.narrow(dim, j * f_loc, f_loc).clone()
            p[n] = t.requires_grad_()
        xr = torch.from_numpy(x[rows].copy()).requires_grad_()
        y, met = moe.moe_ffn(p, xr, cfg=cfg, rt=rt, exec_mode=exec_mode)
        loss = (y * torch.from_numpy(w[rows])).sum() + met["moe_aux"]
        loss.backward()
        out[name] = {"exec": exec_mode, "out": y.detach().numpy(),
                     "aux": float(met["moe_aux"]),
                     "dropped": int(met["moe_dropped"]),
                     "x_grad": xr.grad.numpy(),
                     "grads": {n: t.grad.numpy() for n, t in p.items()},
                     "shapes": {n: tuple(t.shape) for n, t in p.items()}}
    return out


def a2a_rank(rank, world):
    """``all_to_all`` over the 4 ranks of a (1, 4) mesh for each (split,
    concat) pair of a (4, 8, 12) tensor: the result, the round trip back
    through the swapped dims, and the gradient of sum(y * c) for a fixed
    c (the inverse all-to-all of c)."""
    m = make_mesh((1, 4), ("data", "model"), device="cpu")
    out = {}
    for split in range(3):
        for concat in range(3):
            x = (torch.arange(4 * 8 * 12, dtype=torch.float32)
                 .reshape(4, 8, 12) + 1000 * rank).requires_grad_()
            y = coll.all_to_all(x, "model", m, split, concat)
            back = coll.all_to_all(y, "model", m, concat, split)
            c = torch.sin(torch.arange(y.numel(), dtype=torch.float32)
                          + rank).reshape(y.shape)
            (y * c).sum().backward()
            out[(split, concat)] = {"y": y.detach().numpy(),
                                    "back": back.detach().numpy(),
                                    "x": x.detach().numpy(),
                                    "c": c.numpy(),
                                    "grad": x.grad.numpy()}
    return out


# ---------------------------------------------------------------------------
# tests/test_transform_correctness.py's grok-1 case
# ---------------------------------------------------------------------------

SEQ, BATCH, STEPS = 32, 4, 3
# the reference test's knobs for the moe family: ample capacity (drops are
# partition-dependent), SGD at 0.3 (a direct gradient check)
TRAIN_KW = dict(KW, optimizer="sgd", learning_rate=0.3)
RUNS = {"hybrid": {"comm_mode": "hybrid"}, "mpi": {"comm_mode": "mpi"},
        "tp": {"comm_mode": "hybrid", "moe_exec": "tp"}}


def train_cfg():
    return dataclasses.replace(tc.reduced(tc.get_config("grok-1-314b")),
                               moe_capacity_factor=8.0)


def batches(vocab: int):
    ds = SyntheticLM(vocab, SEQ, BATCH)
    return [ds.batch(i) for i in range(STEPS)]


def train_rank(rank, world, mesh_shape, named):
    """Each run of ``RUNS``: 3 steps of reduced grok-1 on this rank of
    ``mesh_shape`` from the JAX package's parameters, its expert leaves'
    shapes, and whether its seeded init's expert shard is its slice of
    the one-device draw."""
    m = make_mesh(mesh_shape, ("data", "model"), device="cpu")
    c = train_cfg()
    shape = tc.ShapeConfig("tiny", SEQ, BATCH, "train")
    out = {}
    for name, flags in RUNS.items():
        r = get_runner(c, shape, tc.RunConfig(**TRAIN_KW, **flags), mesh=m,
                       params=load_reference_params(named, "cpu"))
        mets = [r.run(b) for b in batches(c.vocab_size)]
        out[name] = {
            "loss": [float(x["loss"]) for x in mets],
            "exec": moe.pick_exec_mode(c, r.rt),
            "dropped": [float(x["moe_dropped"]) for x in mets],
            "shapes": {n: tuple(t.shape) for n, t in
                       named_parameters(r.model).items()
                       if n.startswith("layers.moe.")}}
    # the seeded init on the mesh: every rank draws the whole leaf, then
    # keeps its experts
    r = get_runner(c, shape, tc.RunConfig(**TRAIN_KW), mesh=m, seed=5)
    rt = Runtime(c, tc.RunConfig(**TRAIN_KW), shape, device="cpu")
    whole = build_model(c, rt)
    init_params_(whole, 5)
    mine, ref = named_parameters(r.model), named_parameters(whole)
    out["init_equal"] = all(
        torch.equal(mine[n], shard_tensor(ref[n], r.plan.params[n].held, m))
        for n in ref)
    return out
