"""The ranks of tests/test_torch_checkpoint.py and
test_torch_replan_mesh.py: spawned processes (``launch/mesh.py::spawn``)
that import the port alone, not the JAX package."""
import numpy as np
import torch

import repro_torch.configs as tc
from repro_torch.checkpoint.ckpt import restore_checkpoint, state_leaves
from repro_torch.core.sparsity import SparsityProfile, observed_census
from repro_torch.core.transform import estimate_census, get_runner
from repro_torch.data import SyntheticLM
from repro_torch.launch.mesh import make_mesh
from repro_torch.optim.optimizer import is_fused
from repro_torch.runtime.trainer import Trainer, TrainerConfig, host_scalars
from repro_torch.weights import (gather_state, load_reference_params,
                                 shard_state, to_numpy)

F32 = dict(param_dtype="float32", compute_dtype="float32",
           wire_dtype="float32")


def _np(t) -> np.ndarray:
    """A leaf's bits as a numpy copy (later in-place steps leave it be)."""
    if not isinstance(t, torch.Tensor):
        return np.asarray(t)
    if t.dtype == torch.bfloat16:
        return t.detach().cpu().view(torch.int16).numpy().copy()
    return t.detach().cpu().numpy().copy()


def whole_numpy(state, plan, mesh) -> dict:
    """The canonical state gathered whole, {leaf path: numpy bits}."""
    return {p: _np(t) for p, t in
            state_leaves(gather_state(state, plan, mesh))}


# ---------------------------------------------------------------------------
# checkpoints across meshes
# ---------------------------------------------------------------------------

def _ckpt_trainer(ckpt_dir, mesh):
    cfg = tc.reduced(tc.get_config("parallax-lm"))
    shape = tc.ShapeConfig("t", 16, 4, "train")
    return Trainer(cfg, shape, tc.RunConfig(comm_mode="ps"),
                   TrainerConfig(total_steps=2, ckpt_dir=ckpt_dir,
                                 ckpt_every=2),
                   SyntheticLM(cfg.vocab_size, 16, 4), mesh=mesh,
                   device="cpu")


def save_on_mesh(rank, world, ckpt_dir):
    """2 steps on (2, 2) (``ps``: the table row-sharded); the final save
    gathers on every rank and rank 0 writes."""
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    t = _ckpt_trainer(ckpt_dir, mesh)
    t.run()
    return whole_numpy(t._canonical_state(), t.plan, mesh)


def restore_on_mesh(rank, world, ckpt_dir, shape):
    """A fresh trainer on ``shape`` (None: one device) restores the
    checkpoint; each live shard equals its block of the whole leaf."""
    mesh = None if shape is None else \
        make_mesh(shape, ("data", "model"), device="cpu")
    t = _ckpt_trainer(ckpt_dir, mesh)
    t.maybe_restore()
    live = t._canonical_state()
    disk, _, _ = restore_checkpoint(ckpt_dir, live)
    whole_shapes = {n: s.shape for n, s in t.model.param_specs()}
    cut = shard_state(disk, t.plan, mesh, whole_shapes)
    equal = all(np.array_equal(_np(a), _np(b)) for (_, a), (_, b) in
                zip(state_leaves(live)[1:], state_leaves(cut)[1:]))
    return {"step": t.step, "state_step": live.step, "shards_equal": equal,
            "whole": whole_numpy(live, t.plan, mesh)}


# ---------------------------------------------------------------------------
# replans on a mesh
# ---------------------------------------------------------------------------

FLIP_VOCAB, FLIP_SEQ, FLIP_BATCH, FLIP_STEPS, FLIP_AT = 256, 32, 8, 8, 3
FLIP_KW = dict(F32, capacity_mode="capped", capacity_factor=2.0,
               link_latency=0.0)


def flip_cfg():
    return tc.reduced(tc.get_config("parallax-lm"), vocab=FLIP_VOCAB)


def flip_rank(rank, world, named):
    """Reduced parallax-lm (vocab 256) on (4, 2), 8 steps statically and
    with a replan from the observed census after step 4."""
    mesh = make_mesh((4, 2), ("data", "model"), device="cpu")
    ds = SyntheticLM(FLIP_VOCAB, FLIP_SEQ, FLIP_BATCH)
    out = {}
    for adaptive in (False, True):
        r = get_runner(flip_cfg(), tc.ShapeConfig("tiny", FLIP_SEQ,
                                                  FLIP_BATCH, "train"),
                       tc.RunConfig(**FLIP_KW), mesh=mesh,
                       params=load_reference_params(named, "cpu"))
        first, prof, losses, d = r.plan.embed_method, SparsityProfile(), \
            [], {}
        for i in range(FLIP_STEPS):
            m = host_scalars(r.run(ds.batch(i)))
            losses.append(m["loss"])
            prof.update(m)
            if adaptive and i == FLIP_AT:
                d = r.replan(observed_census(
                    prof, estimate_census(r.model, r.rt), FLIP_VOCAB,
                    r.rt.run_cfg))
        out["adaptive" if adaptive else "static"] = {
            "first": first, "last": r.plan.embed_method, "losses": losses,
            "flips": d.get("flips", []),
            "pspecs_changed": d.get("pspecs_changed"),
            "rebuilt": d.get("rebuilt"), "alpha": r.plan.alpha,
            "tables": r.plan.tables()}
    return out


NMT_VOCAB = 256
TWO_TABLE = dict(capacity_mode="capped", capacity_factor=1.5,
                 link_latency=0.0, table_zipf=(("embed", 1.3),),
                 table_alpha=(("enc_embed", 0.99),))
CENSUS_STEPS = 3


def nmt_cfg():
    return tc.reduced(tc.get_config("parallax-nmt"), vocab=NMT_VOCAB)


def nmt_batches(steps):
    ds = SyntheticLM(NMT_VOCAB, 32, 4, is_encdec=True, src_zipf_a=0.0)
    return [ds.batch(i) for i in range(steps)]


def census_rank(rank, world, named, overlap):
    """Reduced parallax-nmt on (4, 1) with the two-table knobs and
    wire_dtype_auto: the magnitude census of 3 steps, then the plan a
    replan from this run's own observed census installs."""
    mesh = make_mesh((4, 1), ("data", "model"), device="cpu")
    r = get_runner(nmt_cfg(), tc.ShapeConfig("tiny", 32, 4, "train"),
                   tc.RunConfig(**F32, **TWO_TABLE, wire_dtype_auto=True,
                                overlap=overlap),
                   mesh=mesh, params=load_reference_params(named, "cpu"))
    prof, metrics = SparsityProfile(), []
    for b in nmt_batches(CENSUS_STEPS):
        m = host_scalars(r.run(b))
        prof.update(m)
        metrics.append({k: v for k, v in m.items()
                        if k.endswith(("_gmax", "_grms", "_unique",
                                       "_dropped")) or k == "loss"})
    d = r.replan(observed_census(prof, estimate_census(r.model, r.rt),
                                 NMT_VOCAB, r.rt.run_cfg), force=True)
    loss = host_scalars(r.run(nmt_batches(CENSUS_STEPS + 1)[-1]))["loss"]
    return {"metrics": metrics, "tables": r.plan.tables(),
            "table_capacity": d["table_capacity"], "loss_after": loss}


def placement_rank(rank, world):
    """The flip case's model and knobs on (4, 2), where the table starts on
    ``ps`` (row-sharded over model): 2 steps, then a replan whose census
    prices the table near-dense (the dense all-reduce: replicated). Every
    state bit survives the move; the next loss is the static run's."""
    mesh = make_mesh((4, 2), ("data", "model"), device="cpu")
    shape = tc.ShapeConfig("tiny", FLIP_SEQ, FLIP_BATCH, "train")
    ds = SyntheticLM(FLIP_VOCAB, FLIP_SEQ, FLIP_BATCH)
    out = {}
    for adaptive in (False, True):
        r = get_runner(flip_cfg(), shape, tc.RunConfig(**FLIP_KW),
                       mesh=mesh, seed=0)
        losses = [host_scalars(r.run(ds.batch(i)))["loss"]
                  for i in range(2)]
        if adaptive:
            before = whole_numpy(r.state, r.plan, mesh)
            shard0 = tuple(r.model.embed.shape)
            c = estimate_census(r.model, r.rt)
            t = c.tables["embed"]
            c.tables["embed"] = type(t)(**{**t.__dict__, "alpha": 0.99})
            old = r.plan.table_methods["embed"]
            d = r.replan(c)
            after = whole_numpy(r.state, r.plan, mesh)
            out["move"] = {
                "methods": (old, r.plan.table_methods["embed"]),
                "pspecs_changed": d["pspecs_changed"],
                "rebuilt": d["rebuilt"],
                "shards": (shard0, tuple(r.model.embed.shape)),
                "bits_equal": before.keys() == after.keys() and all(
                    np.array_equal(before[k], after[k]) for k in before)}
        losses.append(host_scalars(r.run(ds.batch(2)))["loss"])
        out["adaptive" if adaptive else "static"] = losses
    return out


def regroup_rank(rank, world):
    """Reduced parallax-nmt on (4, 1), fused apply on and off: 2 steps,
    a replan whose census pins one dense parameter to bf16 on the wire
    (its bucket splits off: the layout regroups), 2 more. The fused
    optimizer state migrates through copies; both runs agree bit for
    bit."""
    mesh = make_mesh((4, 1), ("data", "model"), device="cpu")
    out = {}
    for fused in (True, False):
        r = get_runner(nmt_cfg(), tc.ShapeConfig("tiny", 32, 4, "train"),
                       tc.RunConfig(**F32, **TWO_TABLE, fused_apply=fused),
                       mesh=mesh, seed=0)
        bs = nmt_batches(4)
        losses = [host_scalars(r.run(b))["loss"] for b in bs[:2]]
        sig = lambda: [(b.idx, b.key[1]) for b in r.plan.bucket_plan.buckets]
        pre_sig, pre_fused = sig(), is_fused(r.live_state)
        before = whole_numpy(r.state, r.plan, mesh)
        c = estimate_census(r.model, r.rt)
        c.wire_dtypes = {"layers.w_x": "bfloat16"}
        d = r.replan(c)
        after = whole_numpy(r.state, r.plan, mesh)
        losses += [host_scalars(r.run(b))["loss"] for b in bs[2:]]
        out[str(fused)] = {
            "losses": losses, "pre_sig": pre_sig, "post_sig": sig(),
            "pre_fused": pre_fused, "post_fused": is_fused(r.live_state),
            "rebuilt": d["rebuilt"], "wire_flips": d["wire_flips"],
            "bits_equal": all(np.array_equal(before[k], after[k])
                              for k in before),
            "params": {n: to_numpy(p) for n, p in r.state.params.items()}}
    return out
