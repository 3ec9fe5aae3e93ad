"""The ranks of tests/test_torch_zero_mesh.py and test_torch_dp_mesh.py:
spawned processes (``launch/mesh.py::spawn``) that train on a gloo process
mesh with the optimizer state sharded apart from its parameter (ZeRO-1)
and under the ``dp`` dense strategy (the model axis a batch axis). They
import the port alone, not the JAX package."""
import dataclasses
import math

import numpy as np
import torch

import repro_torch.configs as tc
from repro_torch.core import collectives as coll
from repro_torch.core import cost_model
from repro_torch.core.plan import entry_axes, per_device_bytes, plan_diff
from repro_torch.core.runtime import Runtime
from repro_torch.core.transform import (Runner, _escalate, analyze,
                                        apply_replan, build_step,
                                        get_runner)
from repro_torch.data import SyntheticLM
from repro_torch.launch import train as launch_train
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.layers import flatten_specs
from repro_torch.models.model import build_model
from repro_torch.optim.optimizer import is_fused, make_optimizer
from repro_torch.runtime.trainer import Trainer, TrainerConfig
from repro_torch.weights import gather_state, load_reference_params

STEPS = 3
# the reference tests' RunConfig (tests/test_perf_paths.py)
KW = dict(attention_impl="naive", remat="none", param_dtype="float32",
          compute_dtype="float32", wire_dtype="float32")
# parallax-lm's (tests/test_transform_correctness.py): the LSTM has no
# attention
LM_KW = dict(param_dtype="float32", compute_dtype="float32",
             wire_dtype="float32")
# (seq, global batch) of each arch's runs: the reference tests' shapes
SHAPES = {"parallax-lm": (32, 4)}
SHAPE = (32, 8)


def cfg(arch: str):
    return tc.reduced(tc.get_config(arch))


def kw(arch: str) -> dict:
    return LM_KW if arch == "parallax-lm" else KW


def shape(arch: str):
    seq, batch = SHAPES.get(arch, SHAPE)
    return tc.ShapeConfig("tiny", seq, batch, "train")


def batches(arch: str, steps=STEPS, start=0):
    seq, batch = SHAPES.get(arch, SHAPE)
    ds = SyntheticLM(cfg(arch).vocab_size, seq, batch)
    return [ds.batch(i) for i in range(start, start + steps)]


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().copy()


def whole(state, plan, mesh) -> dict:
    """{part.name: numpy} of a canonical state gathered whole."""
    st = gather_state(state, plan, mesh)
    out = {}
    for part in ("params", "m", "v"):
        tree = getattr(st, part)
        for n, t in (tree or {}).items():
            out[f"{part}.{n}"] = _np(t)
    return out


def _axes_size(placement: tuple, mesh) -> int:
    return math.prod(mesh.axes_size(entry_axes(e)) for e in placement)


def layout(runner) -> dict:
    """This rank's state beside its plan: each leaf's parameter and
    moment shapes, its moments' share of the parameter it lies beside and
    the share the plan gives (``held`` against ``opt_held``), the bytes of
    parameters and moments the rank holds against ``per_device_bytes``
    (by the placements executed, and by the planned ones)."""
    plan, mesh, st = runner.plan, runner.rt.mesh, runner.state
    specs = flatten_specs(runner.model.specs())
    leaves, held_bytes, opt_bytes = {}, 0, 0
    for n, p in plan.params.items():
        par, m = st.params[n], st.m[n]
        leaves[n] = {
            "param": tuple(par.shape), "m": tuple(m.shape),
            "v": tuple(st.v[n].shape) if st.v is not None else None,
            "share": m.numel() / par.numel(),
            "plan_share": _axes_size(p.held, mesh)
            / _axes_size(p.opt_held, mesh),
            "sparse": p.sparse, "zero": p.opt_placement != p.placement,
            "held_is_placement": p.held == p.placement,
            "model_in_held": any("model" in entry_axes(e) for e in p.held)}
        held_bytes += par.numel() * par.element_size()
        for t in (st.m[n], st.v[n]):
            opt_bytes += t.numel() * t.element_size()
    plans = [plan.params[n] for n, _ in specs]
    itemsize = torch.empty((), dtype=runner.rt.param_dtype).element_size()
    return {
        "leaves": leaves, "bytes": held_bytes + opt_bytes,
        "opt_bytes": opt_bytes,
        "plan_bytes": per_device_bytes(specs, plan.rules, plans,
                                       dtype_bytes=itemsize, held=True),
        "plan_bytes_planned": per_device_bytes(specs, plan.rules, plans,
                                               dtype_bytes=itemsize),
        "plan_opt_bytes": per_device_bytes(specs, plan.rules, plans,
                                           dtype_bytes=0, held=True),
        "zero_stage": plan.zero_stage, "fused_apply": plan.fused_apply,
        "live_fused": is_fused(runner.live_state),
        "bucketed": sorted(n for i, n in enumerate(plan.params)
                           if plan.bucket_plan is not None and any(
                               i in b.idx for b in plan.bucket_plan.buckets)),
        "strategy": runner.rt.resolved_strategy,
        "batch_axes": tuple(runner.rt.batch_axes),
        "replicas": runner.rt.replicas,
        "vocab_shards": runner.rt.vocab_shards,
        "row_axis": runner.rt.embed_ctx().model_axis,
        "methods": dict(plan.table_methods)}


def stage1_budget(model, rt) -> float:
    """The per-device bytes of ``rt``'s plan at ZeRO-1: a memory budget
    under which the escalation stops at stage 1."""
    plan = analyze(model, rt)
    specs = flatten_specs(model.specs())
    plan = _escalate(plan, specs, rt, 1)
    return per_device_bytes(specs, rt.rules, list(plan.params.values()))


def budget_runner(arch, flags, mesh, named, budget=None) -> Runner:
    """``get_runner`` with ``analyze``'s memory budget set: at None, the
    stage-1 bytes of the plan (the escalation stamps ZeRO-1)."""
    c = cfg(arch)
    rt = Runtime(c, tc.RunConfig(**kw(arch), **flags), shape(arch),
                 mesh=mesh, device="cpu")
    model = build_model(c, rt)
    if budget is None:
        budget = stage1_budget(model, rt)
    plan = analyze(model, rt, memory_budget=budget)
    rt.plan = plan
    opt = make_optimizer(rt)
    step, state = build_step(model, opt, rt, plan,
                             load_reference_params(named, "cpu"))
    return Runner(model=model, optimizer=opt, plan=plan, rt=rt,
                  train_step=step, live_state=state)


def _record(runner, arch, mesh) -> dict:
    losses = [float(runner.run(b)["loss"]) for b in batches(arch)]
    return {"loss": losses, **layout(runner),
            "whole": whole(runner.state, runner.plan, mesh)}


def zero_rank(rank, world, mesh_shape, cases):
    """``cases``: [(key, arch, RunConfig flags, named params, escalate)]:
    each case's 3 steps on this rank of ``mesh_shape``; ``escalate``: the
    plan's memory budget set so that the escalation stamps ZeRO-1."""
    m = make_mesh(mesh_shape, ("data", "model"), device="cpu")
    out = {}
    for key, arch, flags, named, escalate in cases:
        if escalate:
            r = budget_runner(arch, flags, m, named)
        else:
            r = get_runner(cfg(arch), shape(arch),
                           tc.RunConfig(**kw(arch), **flags), mesh=m,
                           params=load_reference_params(named, "cpu"))
        out[key] = _record(r, arch, m)
    return out


def replan_rank(rank, world, mesh_shape, arch, named, first):
    """``first`` steps at zero_stage 0, then a replan onto the escalated
    plan (ZeRO-1: every dense leaf's ``opt_placement`` moves), then the
    rest of the 3: the moments carried across, against an uninterrupted
    run."""
    m = make_mesh(mesh_shape, ("data", "model"), device="cpu")
    r = get_runner(cfg(arch), shape(arch), tc.RunConfig(**kw(arch)), mesh=m,
                   params=load_reference_params(named, "cpu"))
    bs = batches(arch)
    losses = [float(r.run(b)["loss"]) for b in bs[:first]]
    before = layout(r)
    new = analyze(r.model, r.rt,
                  memory_budget=stage1_budget(r.model, r.rt))
    diff = plan_diff(r.plan, new)
    r.plan = new
    r.train_step, r.live_state = apply_replan(r.model, r.optimizer, r.rt,
                                              new, r.live_state, diff)
    carried = whole(r.state, r.plan, m)
    after = layout(r)
    losses += [float(r.run(b)["loss"]) for b in bs[first:]]
    return {"loss": losses, "before": before, "after": after,
            "carried": carried, "whole": whole(r.state, r.plan, m),
            "pspecs_changed": diff["pspecs_changed"],
            "rebuilt": diff["rebuilt"]}


def state_rank(rank, world, mesh_shape, arch, named, steps):
    """The whole state (parameters and moments) after ``steps`` steps at
    zero_stage 0 on this mesh: what a replan's carried state is held
    against."""
    m = make_mesh(mesh_shape, ("data", "model"), device="cpu")
    r = get_runner(cfg(arch), shape(arch), tc.RunConfig(**kw(arch)), mesh=m,
                   params=load_reference_params(named, "cpu"))
    for b in batches(arch, steps):
        r.run(b)
    return whole(r.state, r.plan, m)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

CKPT_ARCH = "phi3-medium-14b"


def ckpt_trainer(mesh, zero_stage, total, ckpt_dir=None, every=3):
    c = cfg(CKPT_ARCH)
    seq, batch = SHAPE
    return Trainer(c, shape(CKPT_ARCH),
                   tc.RunConfig(**KW, zero_stage=zero_stage),
                   TrainerConfig(total_steps=total, ckpt_dir=ckpt_dir,
                                 ckpt_every=every),
                   SyntheticLM(c.vocab_size, seq, batch), mesh=mesh,
                   device="cpu")


def ckpt_run(mesh, zero_stage, total, ckpt_dir=None, restore=False) -> dict:
    """A trainer's run on ``mesh`` (None: one device): restored from
    ``ckpt_dir`` first when ``restore``. -> its losses, the step it
    started at, the whole state it started from and the moments' layout
    at its start."""
    t = ckpt_trainer(mesh, zero_stage, total, ckpt_dir)
    if restore:
        t.maybe_restore()
    start = t.step
    st = t._canonical_state()
    start_whole = whole(st, t.plan, mesh)
    shares = {n: st.m[n].numel() / st.params[n].numel() for n in st.params}
    losses = []
    t.run(on_metrics=lambda step, mt: losses.append(float(mt["loss"])))
    return {"start": start, "loss": losses, "start_whole": start_whole,
            "shares": shares, "zero_stage": t.plan.zero_stage,
            "final": whole(t._canonical_state(), t.plan, mesh)}


def ckpt_rank(rank, world, mesh_shape, runs):
    """``runs``: [(key, zero_stage, total steps, ckpt_dir or None,
    restore)] in order, on this rank of ``mesh_shape``."""
    m = make_mesh(mesh_shape, ("data", "model"), device="cpu")
    return {key: ckpt_run(m, z, total, d, restore)
            for key, z, total, d, restore in runs}


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def launcher_rank(rank, world, argv, dims, escalate):
    """One rank of ``launch/train.py``'s ``--devices N --mesh DxM`` run
    (its own ``_rank_main``). ``escalate``: the card's memory set so that
    the default plan's escalation stamps ZeRO-1 (between the stage-0 and
    stage-1 bytes of the plan)."""
    mesh = make_mesh(dims, ("data", "model"), device="cpu")
    c, sh, rc, _ = launch_train._configs(launch_train._parse(argv))
    rt = Runtime(c, rc, sh, mesh=mesh, device="cpu")
    model = build_model(c, rt)
    specs = flatten_specs(model.specs())
    plan0 = analyze(model, rt)
    b0 = per_device_bytes(specs, rt.rules, list(plan0.params.values()))
    b1 = stage1_budget(model, rt)
    saved = cost_model.HW
    if escalate:
        cost_model.HW = dataclasses.replace(
            saved, hbm_bytes=(b0 + b1) / 2 / 0.9)
    try:
        plan = analyze(model, rt)
        out = launch_train._rank_main(rank, world, argv, "cpu", dims,
                                      ("data", "model"))
    finally:
        cost_model.HW = saved
    out["zero_stage"] = plan.zero_stage
    out["zero_leaves"] = sum(p.opt_held != p.held
                             for p in plan.params.values())
    return out


# ---------------------------------------------------------------------------
# dp
# ---------------------------------------------------------------------------

def record_collectives(runner, batch) -> list:
    """[(kind, axes)] of every collective ``core/collectives.py`` issues in
    one step (the forward, the backward and the update), as its record
    (``collectives.record``) sees them."""
    with coll.record() as rec:
        runner.run(batch)
    return [(ev.kind, ev.axes) for ev in rec.events]


def dp_rank(rank, world, mesh_shape, cases):
    """``cases``: [(key, arch, RunConfig flags, named params or None:
    the seed-0 init)]: each case's 3 steps on this rank of
    ``mesh_shape``, its layout, and the collectives of a fourth step."""
    m = make_mesh(mesh_shape, ("data", "model"), device="cpu")
    both = ("data", "model")
    me = torch.tensor([float(m.index(both))])
    n = m.axes_size(both)
    out = {"order": {
        "coords": (m.coords["data"], m.coords["model"], int(me)),
        "gathered": coll.all_gather(me, both, m).tolist(),
        # every rank sends (rank + 1) * [0, 1, .., n - 1]: block i sums to
        # i * n (n + 1) / 2
        "scattered": coll.reduce_scatter(
            (me + 1) * torch.arange(n, dtype=torch.float32), both,
            m).tolist()}}
    for key, arch, flags, named in cases:
        r = get_runner(cfg(arch), shape(arch),
                       tc.RunConfig(**kw(arch), **flags), mesh=m, seed=0,
                       params=None if named is None
                       else load_reference_params(named, "cpu"))
        rec = _record(r, arch, m)
        rec["moe_exec"] = r.rt.run_cfg.moe_exec
        rec["collectives"] = record_collectives(
            r, batches(arch, 1, start=STEPS)[0])
        rec["fsdp"] = sorted(n for n, p in r.plan.params.items()
                             if p.method == "fsdp")
        out[key] = rec
    return out
