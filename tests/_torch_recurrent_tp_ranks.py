"""The ranks of tests/test_torch_recurrent_tp.py and test_torch_toy_mesh.py:
spawned processes (``launch/mesh.py::spawn``) that train the recurrent
families (the LSTM, hymba's selective SSM, rwkv6's time and channel mixes)
and grok-1's routed experts tensor-parallel over ``model``, and serve them
through ``ToyServer`` on a gloo process mesh. They import the port alone,
not the JAX package."""
import dataclasses
import math

import numpy as np
import torch

import repro_torch.configs as tc
from repro_torch.checkpoint.ckpt import restore_checkpoint, save_checkpoint
from repro_torch.core import collectives as coll
from repro_torch.core.plan import entry_axes, per_device_bytes
from repro_torch.core.transform import build_step, get_runner
from repro_torch.data import SyntheticLM
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.layers import flatten_specs
from repro_torch.runtime.server import Request, ServerConfig, ToyServer
from repro_torch.utils.tree import named_parameters
from repro_torch.weights import (gather_params, gather_state, gather_tensor,
                                 load_reference_params)

SEQ, BATCH, STEPS = 32, 4, 3
LM, NMT = "parallax-lm", "parallax-nmt"
HYMBA, RWKV, GROK = "hymba-1.5b", "rwkv6-7b", "grok-1-314b"
# the reference correctness test's RunConfig (tests/test_transform_
# correctness.py): f32 end to end, plain attention, no remat
KW = dict(attention_impl="naive", remat="none", param_dtype="float32",
          compute_dtype="float32", wire_dtype="float32")
# its knobs for the moe family: SGD at 0.3 (a direct gradient check)
MOE_KW = dict(KW, optimizer="sgd", learning_rate=0.3, moe_exec="tp")


def cfg(arch: str):
    c = tc.reduced(tc.get_config(arch))
    if c.n_experts:
        # ample capacity: drops are partition-dependent
        c = dataclasses.replace(c, moe_capacity_factor=8.0)
    return c


def run_cfg(arch: str, **flags):
    return tc.RunConfig(**(MOE_KW if arch == GROK else KW), **flags)


def batches(arch: str, steps=STEPS):
    c = cfg(arch)
    audio = c.family == "audio"
    ds = SyntheticLM(c.vocab_size, SEQ, BATCH, is_encdec=c.is_encdec,
                     frames_dim=c.d_model if audio else 0,
                     frames_len=SEQ // 4)
    return [ds.batch(i) for i in range(steps)]


def shape():
    return tc.ShapeConfig("tiny", SEQ, BATCH, "train")


def capture_grads(runner) -> dict:
    """{name: gradient} of the runner's next step as the optimizer gets
    it (exchanged over the replicas: this rank's block), filled on the
    first update."""
    rec = {}
    opt = runner.optimizer

    def hook(fn):
        def run(state, grads, *rest):
            if not rec:
                rec.update({n: g.detach().clone() for n, g in grads.items()})
            return fn(state, grads, *rest)
        return run

    # the step calls the optimizer it was built with: wrap its (frozen)
    # fields in place
    object.__setattr__(opt, "update", hook(opt.update))
    if opt.update_fused is not None:
        object.__setattr__(opt, "update_fused", hook(opt.update_fused))
    return rec


def _numpy(t: torch.Tensor) -> np.ndarray:
    """A copy (a later step writes the parameters in place)."""
    return t.detach().float().numpy().copy()


def one_device(arch: str, named: dict, flags=None, steps=STEPS) -> dict:
    """The port's one-device losses and step-0 gradients from ``named``."""
    r = get_runner(cfg(arch), shape(), run_cfg(arch, **(flags or {})),
                   device="cpu", params=load_reference_params(named, "cpu"))
    grads = capture_grads(r)
    losses = [float(r.run(b)["loss"]) for b in batches(arch, steps)]
    return {"loss": losses, "grads": {n: _numpy(g) for n, g in grads.items()}}


def _layout(runner, mesh) -> dict:
    """Each leaf's held shape, its share of the whole, and the rank's
    parameter bytes beside ``per_device_bytes``'s planned term."""
    plan = runner.plan
    own = named_parameters(runner.model)
    specs = flatten_specs(runner.model.specs())
    whole = dict(specs)
    shapes = {n: tuple(t.shape) for n, t in own.items()}
    shares = {n: t.numel() / math.prod(whole[n].shape)
              for n, t in own.items()}
    got = sum(t.numel() * t.element_size() for t in own.values())
    plans = [plan.params[n] for n, _ in specs]
    want = per_device_bytes(specs, plan.rules, plans, dtype_bytes=4,
                            opt_bytes=0)
    shards = {n: math.prod(mesh.axes_size(entry_axes(e)) for e in p.held)
              for n, p in plan.params.items()}
    return {"shapes": shapes, "shares": shares, "shards": shards,
            "bytes": got,
            "plan_bytes": want,
            "held_is_placement": all(p.held == p.placement
                                     for p in plan.params.values()),
            "model_sharded": sorted(
                n for n, p in plan.params.items()
                if any("model" in entry_axes(e) for e in p.held))}


def train_rank(rank, world, mesh_shape, cases, ckpt_dir=None):
    """``cases``: [(key, arch, flags, named params, steps, save_at)]. Each
    case's steps on this rank of ``mesh_shape`` from ``named``: the
    losses, the step-0 gradients gathered whole, the layout, the whole
    state after the run; ``save_at``: after that many steps the state is
    gathered whole and rank 0 writes a checkpoint to ``ckpt_dir``."""
    m = make_mesh(mesh_shape, ("data", "model"), device="cpu")
    out = {}
    for key, arch, flags, named, steps, save_at in cases:
        r = get_runner(cfg(arch), shape(), run_cfg(arch, **flags), mesh=m,
                       params=load_reference_params(named, "cpu"))
        init = gather_params(named_parameters(r.model), r.plan, m)
        init_equal = all(torch.equal(init[n], t) for n, t in
                         load_reference_params(named, "cpu").items())
        layout = _layout(r, m)
        grads = capture_grads(r)
        losses = []
        for i, b in enumerate(batches(arch, steps)):
            losses.append(float(r.run(b)["loss"]))
            if save_at is not None and i + 1 == save_at:
                whole = gather_state(r.state, r.plan, m)
                if m.rank == 0:
                    save_checkpoint(ckpt_dir, save_at, whole)
                coll.barrier(m)
        plan = r.plan
        whole_grads = {n: _numpy(gather_tensor(g, plan.params[n].held, m,
                                               plan.params[n].groups))
                       for n, g in grads.items()}
        final = gather_state(r.state, plan, m)
        out[key] = {"loss": losses, "grads": whole_grads,
                    "init_equal": init_equal,
                    "final": {f"{part}.{n}": _numpy(t)
                              for part in ("params", "m", "v")
                              if getattr(final, part) is not None
                              for n, t in getattr(final, part).items()},
                    "zero_leaves": sum(p.opt_held != p.held
                                       for p in plan.params.values()),
                    **layout}
    return out


def restore_rank(rank, world, mesh_shape, arch, named, ckpt_dir, step,
                 steps):
    """A fresh runner on ``mesh_shape`` (None: one device) restores the
    checkpoint written at ``step`` and runs batches ``step`` ..
    ``steps - 1``: the losses and the restored state gathered whole."""
    m = None if mesh_shape is None else \
        make_mesh(mesh_shape, ("data", "model"), device="cpu")
    dev = {} if m is not None else {"device": "cpu"}
    r = get_runner(cfg(arch), shape(), run_cfg(arch), mesh=m,
                   params=load_reference_params(named, "cpu"), **dev)
    like = gather_state(r.state, r.plan, m) if m is not None else r.state
    disk, got_step, _ = restore_checkpoint(ckpt_dir, like)
    r.train_step, r.live_state = build_step(r.model, r.optimizer, r.rt,
                                            r.plan, state=disk)
    whole = gather_state(r.state, r.plan, m) if m is not None else r.state
    restored = {f"{part}.{n}": _numpy(t) for part in ("params", "m", "v")
                if getattr(whole, part) is not None
                for n, t in getattr(whole, part).items()}
    losses = [float(r.run(b)["loss"])
              for b in batches(arch, steps)[step:]]
    return {"step": got_step, "loss": losses, "restored": restored}


# ---------------------------------------------------------------------------
# ToyServer on a mesh
# ---------------------------------------------------------------------------

def toy_cfg(arch: str):
    return tc.reduced(tc.get_config(arch))


def toy_logits(sv) -> list:
    """Wrap the server's decode step: record every step's logits,
    gathered whole (the vocab shards, then every data rank's slots)."""
    rec = []
    step = sv.decode_step
    rt = sv.rt

    def run(cache, tokens, cache_len):
        logits, cache = step(cache, tokens, cache_len)
        x = logits[:, 0].float()
        if rt.mesh is not None:
            if rt.vocab_shards > 1:
                x = coll.all_gather(x, "model", rt.mesh, dim=-1)
            x = coll.all_gather(x, tuple(rt.batch_axes), rt.mesh)
        rec.append(x[:, :rt.model_cfg.vocab_size].numpy())
        return logits, cache

    sv.decode_step = run
    return rec


def toy_serve(arch, named, scfg_kw, prompts, new, mesh=None) -> dict:
    """``ToyServer`` on ``mesh`` (None: one device) from ``named``: the
    greedy tokens of ``prompts``, every decode step's whole logits and
    each cache tensor's shape on this rank."""
    dev = {} if mesh is not None else {"device": "cpu"}
    sv = ToyServer(toy_cfg(arch), tc.RunConfig(**KW),
                   ServerConfig(**scfg_kw), mesh=mesh,
                   params=load_reference_params(named, "cpu"), **dev)
    rec = toy_logits(sv)
    for i, p in enumerate(prompts):
        sv.submit(Request(i, np.asarray(p, np.int32), max_new_tokens=new))
    done = sv.run_until_drained()
    return {"tokens": {r.uid: list(r.out_tokens) for r in done},
            "logits": rec, "cache": [tuple(c.shape) for c in sv.cache],
            "stats": dict(sv.stats)}


def toy_rank(rank, world, runs, named, scfg_kw, prompts, new):
    """``runs``: [(mesh shape, arch)], each on this rank of a mesh of
    ``world`` ranks: ``toy_serve``'s record."""
    out = {}
    for mesh_shape, arch in runs:
        m = make_mesh(mesh_shape, ("data", "model"), device="cpu")
        out[(mesh_shape, arch)] = toy_serve(arch, named[arch], scfg_kw,
                                            prompts, new, mesh=m)
    return out
