"""The ranks of tests/test_torch_elastic_mesh.py: spawned processes
(``launch/mesh.py::spawn``) that import the port alone, not the JAX
package. A rank returns numpy and Python values, never tensors."""
import dataclasses
import json
import shutil

import torch

import repro_torch.configs as tc
from repro_torch.benchmarks import elastic_remesh as EB
from repro_torch.checkpoint.ckpt import latest_step
from repro_torch.core import collectives as coll
from repro_torch.data import SyntheticLM
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch.mesh import grow_mesh, make_mesh, shrink_mesh
from repro_torch.runtime.trainer import Trainer, TrainerConfig

SEQ, BATCH = 32, 8
PHI3_RC = dict(attention_impl="naive", remat="none", param_dtype="float32",
               compute_dtype="float32", wire_dtype="float32",
               link_latency=0.0)


def _grid(mesh) -> list:
    return mesh.ranks.tolist()


# ---------------------------------------------------------------------------
# shrink_mesh / grow_mesh on process groups
# ---------------------------------------------------------------------------

def shrink_grow(rank, world):
    """(4, 2) -> drop data slice 1 -> grow it back at index 1: the grids,
    who is on each mesh, and a sum over each new mesh's data axis (its
    groups work) on the ranks that hold it."""
    mesh = make_mesh((4, 2), ("data", "model"), device="cpu")
    m3 = shrink_mesh(mesh, drop_axis_index=1)
    out = {"m3": _grid(m3), "m3_shape": dict(m3.shape),
           "m3_member": m3.member, "m3_lead": m3.lead}
    if m3.member:
        x = torch.tensor([float(rank)])
        out["m3_sum"] = float(coll.all_reduce(x, "data", m3))
        out["m3_coords"] = m3.coords
    m4 = grow_mesh(m3, mesh.ranks[1], insert_axis_index=1)
    out["m4"] = _grid(m4)
    out["m4_coords"] = m4.coords
    out["m4_sum"] = float(coll.all_reduce(torch.tensor([float(rank)]),
                                          ("data", "model"), m4))
    try:
        grow_mesh(m4, mesh.ranks[1], insert_axis_index=1)
        out["overlap_raises"] = False
    except ValueError:
        out["overlap_raises"] = True
    out["floored"] = shrink_mesh(m4, 0, min_axis_size=4) is None
    # a second round trip makes no group: it reuses the first one's
    made = len(mesh_mod._GROUPS)
    m3b = shrink_mesh(m4, drop_axis_index=1)
    m4b = grow_mesh(m3b, mesh.ranks[1], insert_axis_index=1)
    out["groups_made"] = (made, len(mesh_mod._GROUPS))
    out["groups_reused"] = all(
        a.group(ax) is b.group(ax)
        for a, b in ((m3, m3b), (m4, m4b)) if a.member
        for ax in ("data", "model", ("data", "model")))
    out["m4b_sum"] = float(coll.all_reduce(torch.tensor([float(rank)]),
                                           ("data", "model"), m4b))
    coll.barrier(m4)
    return out


# ---------------------------------------------------------------------------
# the trainer's elastic half
# ---------------------------------------------------------------------------

def _lm_trainer(mesh, tcfg, **rc):
    cfg = tc.reduced(tc.get_config("parallax-lm"), vocab=512)
    shape = tc.ShapeConfig("t", SEQ, BATCH, "train")
    kw = dict(param_dtype="float32", compute_dtype="float32",
              wire_dtype="float32", capacity_mode="capped",
              capacity_factor=2.0, link_latency=0.0)
    kw.update(rc)
    return Trainer(cfg, shape, tc.RunConfig(**kw), tcfg,
                   SyntheticLM(512, SEQ, BATCH), mesh=mesh, device="cpu")


def _losses(t, upto, out):
    t.tcfg = dataclasses.replace(t.tcfg, total_steps=upto)
    t.run(on_metrics=lambda s, m: out.append((s, m["loss"])))


def evict_readmit(rank, world, ckpt_dir):
    """The reference's grow scenario on (4, 2): 4 steps; ``_auto_remesh``
    by convention (slice 3); to step 8 on (3, 2); ``readmit`` on
    probation; to step 10 (the final save); then a fresh trainer on
    (4, 2) restores the last checkpoint and trains 2 steps."""
    mesh = make_mesh((4, 2), ("data", "model"), device="cpu")
    tcfg = TrainerConfig(total_steps=4, ckpt_dir=ckpt_dir, ckpt_every=100,
                         min_data_parallel=2, probation_steps=30)
    t = _lm_trainer(mesh, tcfg)
    losses = []
    _losses(t, 4, losses)
    diff = t._auto_remesh()
    shrunk = dict(t.mesh.shape)
    evicted_ranks = t._evicted[-1]["ranks"].tolist() if t._evicted else None
    live_after_shrink = t.live
    _losses(t, 8, losses)
    t.readmit()
    grown = dict(t.mesh.shape)
    probation = t.monitor._probation[0] if t.monitor._probation else None
    _losses(t, 10, losses)
    latest = latest_step(ckpt_dir)
    t2 = _lm_trainer(make_mesh((4, 2), ("data", "model"), device="cpu"),
                     dataclasses.replace(tcfg, total_steps=12))
    cap_estimate = t2.plan.table_capacity["embed"]
    t2.maybe_restore()
    restored = t2.step
    after = []
    t2.run(on_metrics=lambda s, m: after.append(m["loss"]))
    return {"rank": rank, "shrunk": shrunk, "grown": grown,
            "live_after_shrink": live_after_shrink,
            "diff_none": diff is None, "probation": probation,
            "remeshes": t.monitor.remeshes, "regrows": t.monitor.regrows,
            "evicted_left": len(t._evicted), "losses": losses,
            "step": t.step, "latest": latest, "evicted": evicted_ranks,
            "restored": restored, "cap_estimate": cap_estimate,
            "cap_saved": t.plan.table_capacity["embed"],
            "cap_restored": t2.plan.table_capacity["embed"],
            "after": after}


def _phi3_trainer(mesh, tcfg, **rc):
    cfg = tc.reduced(tc.get_config("phi3-medium-14b"), vocab=256)
    shape = tc.ShapeConfig("t", SEQ, BATCH, "train")
    return Trainer(cfg, shape, tc.RunConfig(**{**PHI3_RC, **rc}), tcfg,
                   SyntheticLM(cfg.vocab_size, SEQ, BATCH), mesh=mesh,
                   device="cpu")


def reprice(rank, world, ckpt_dir):
    """The reference's reprice scenario: reduced phi3 at vocab 256, α 0.3
    on (4, 1), from the JAX package's step-0 state (``ckpt_dir``); 2
    steps, the shrink to (3, 1) by hand, 2 more steps."""
    mesh = make_mesh((4, 1), ("data", "model"), device="cpu")
    t = _phi3_trainer(mesh, TrainerConfig(total_steps=2, ckpt_dir=ckpt_dir,
                                          ckpt_every=100),
                      table_alpha=(("embed", 0.3),))
    t.maybe_restore()
    method4, tables4 = t.plan.table_methods["embed"], t.plan.tables()
    pre = []
    t.run(on_metrics=lambda s, m: pre.append(m["loss"]))
    t.remesh(shrink_mesh(mesh, drop_axis_index=3))
    post = []
    _losses(t, 4, post)
    out = {"rank": rank, "method4": method4, "tables4": tables4,
           "pre": pre, "post": post, "live": t.live}
    if t.live:
        out.update(method3=t.plan.table_methods["embed"],
                   tables3=t.plan.tables(), shape3=dict(t.mesh.shape),
                   bucket3=_buckets(t.plan))
    return out


def _buckets(plan):
    bp = plan.bucket_plan
    if bp is None:
        return None
    return {"replicas": bp.replicas, "batch_axes": list(bp.batch_axes),
            "idx": [list(b.idx) for b in bp.buckets]}


STEPS, SLOW_FROM, SLEEP = 14, 6, 0.3


def straggle(rank, world, slow, ckpt_dir):
    """The reference's acceptance scenario on (4, 2) over 8 ranks: from
    step ``SLOW_FROM`` the ranks of data slice 3 sleep inside each step
    (``slow``), the monitor escalates and the trainer evicts
    that slice (by convention: no heartbeat) after a checkpoint; the run
    goes on to ``STEPS`` on (3, 2). ``slow`` False: the never-straggled
    run. The ranks left on (3, 2) then build a fresh trainer there from
    the pre-remesh checkpoint and take one step."""
    mesh = make_mesh((4, 2), ("data", "model"), device="cpu")
    tcfg = TrainerConfig(total_steps=STEPS, ckpt_dir=ckpt_dir,
                         ckpt_every=100, remesh_on_straggle=slow,
                         remesh_cooldown=20, min_data_parallel=2)
    kw = dict(capacity_mode="capped", capacity_factor=2.0)
    t = _phi3_trainer(mesh, tcfg, **kw)
    t.monitor.sustained, t.monitor.min_samples = 3, 4
    tables0 = t.plan.tables()
    hist = []
    if slow and mesh.coords["data"] == 3:
        # the slow host: 5x its healthy median step (at least 0.3 s, the
        # reference's), gone with the rebuild at the remesh
        EB._slow(t, lambda s: s >= SLOW_FROM, "5x", hist, SLEEP)
    t.run(on_metrics=lambda s, m: hist.append(dict(
        step=s, loss=m["loss"], remeshes=int(m.get("remeshes", 0)),
        step_time_s=m["step_time_s"])))
    out = {"rank": rank, "live": t.live, "hist": hist, "tables0": tables0,
           "remeshes": t.monitor.remeshes, "step": t.step,
           "latest": latest_step(ckpt_dir) if ckpt_dir else None}
    if not slow:
        return out
    at = next((h["step"] for h in hist if h["remeshes"]), None)
    at = coll.broadcast_object(at, src=0)
    out["remesh_at"] = at
    if t.live:
        out.update(mesh_after=dict(t.mesh.shape), tables1=t.plan.tables())
        with open(f"{ckpt_dir}/step_{at:08d}/manifest.json") as f:
            out["manifest"] = json.load(f)["extra"]
    # a fresh trainer on the shrunk mesh (every rank builds it; the ranks
    # off it wait in its calls) from the pre-remesh checkpoint: its first
    # step against the remeshed run's
    fresh_dir = ckpt_dir + "_fresh"
    if rank == 0:
        # the pre-remesh state, with the plan record the remesh arrived at
        shutil.copytree(f"{ckpt_dir}/step_{at:08d}",
                        f"{fresh_dir}/step_{at:08d}")
        path = f"{fresh_dir}/step_{at:08d}/manifest.json"
        with open(path) as f:
            manifest = json.load(f)
        manifest["extra"]["plan"] = t.plan.tables()
        with open(path, "w") as f:
            json.dump(manifest, f)
    coll.broadcast_object(None, src=0)       # the copy is in place
    fresh = _phi3_trainer(t.mesh, dataclasses.replace(
        tcfg, ckpt_dir=fresh_dir, total_steps=at + 1,
        remesh_on_straggle=False), **kw)
    fresh.maybe_restore()
    one = []
    fresh.run(on_metrics=lambda s, m: one.append(m["loss"]))
    out.update(fresh_loss=one, fresh_live=fresh.live,
               fresh_tables=fresh.plan.tables() if fresh.live else None)
    return out


# ---------------------------------------------------------------------------
# heartbeat_fn: the attribution against the reference's on the same beats
# ---------------------------------------------------------------------------

BEAT_STEPS = 8


def slow_slot_beats(step, n):
    """Per-slot beats (seconds): 0.01 everywhere, slot 2 at 0.2 once two
    steps are done. Self-contained: the JAX run takes its source text."""
    import numpy as np
    v = np.full((n,), 0.01, np.float32)
    if step >= 2 and n > 2:
        v[2] = 0.2
    return v


class _Ticks:
    """A monitor clock that moves 5 ms a reading: every step takes the
    same time, so the wall time flags nothing and the beats decide."""

    def __init__(self):
        self.t = 0.0

    def perf_counter(self):
        self.t += 0.005
        return self.t


def beat_attribution(rank, world):
    """Reduced phi3 on (4, 1) with ``heartbeat_fn = slow_slot_beats`` and
    a steady monitor clock: each step's attributed slice and escalation,
    and the eviction the escalation makes (``remesh_on_straggle``)."""
    from repro_torch.runtime import monitor as monitor_mod
    monitor_mod.time = _Ticks()
    mesh = make_mesh((4, 1), ("data", "model"), device="cpu")
    tcfg = TrainerConfig(total_steps=BEAT_STEPS, remesh_on_straggle=True,
                         remesh_cooldown=20, min_data_parallel=2)
    t = _phi3_trainer(mesh, tcfg, heartbeat=True)
    t.monitor.sustained, t.monitor.min_samples = 3, 4
    t.heartbeat_fn = slow_slot_beats
    hist = []
    t.run(on_metrics=lambda s, m: hist.append(
        [s, m.get("straggler_slice"), t.monitor.remesh_suggested,
         int(m.get("remeshes", 0))]))
    ev = coll.broadcast_object(
        [[e["step"], e["index"], e["slot"]] for e in t._evicted], src=0)
    return {"rank": rank, "live": t.live, "hist": hist, "evicted": ev,
            "shape": dict(t.mesh.shape) if t.live else None}


def stale_zero(rank, world, zero_stage):
    """Reduced phi3 (``embed`` at α 0.1: ``mpi_gatherv``) on (2, 1) with
    stale buffers: 2 steps, the stale flip, 2 steps, the flip back (the
    drain), 2 steps. ZeRO-1 (``zero_stage`` 1) against the fused apply of
    stage 0: the buffers ride both."""
    from repro_torch.optim.optimizer import is_fused
    mesh = make_mesh((2, 1), ("data", "model"), device="cpu")
    t = _phi3_trainer(mesh, TrainerConfig(total_steps=2),
                      table_alpha=(("embed", 0.1),), max_staleness=2,
                      zero_stage=zero_stage)
    losses, ages = [], []
    cb = lambda s, m: (losses.append(m["loss"]),
                       ages.append(m.get("staleness_age")))
    t.run(on_metrics=cb)
    t._flip_stale(True)
    fused = is_fused(t.state)
    t.tcfg = dataclasses.replace(t.tcfg, total_steps=4)
    t.run(on_metrics=cb)
    buffered = float(t.state.stale["embed"]["g"].abs().sum())
    t._flip_stale(False)
    t.tcfg = dataclasses.replace(t.tcfg, total_steps=6)
    t.run(on_metrics=cb)
    return {"losses": losses, "ages": ages, "fused": fused,
            "zero_stage": t.plan.zero_stage, "buffered": buffered,
            "drained": float(t.state.stale["embed"]["g"].abs().sum())}


def zero_remesh(rank, world, zero_stage):
    """ZeRO-1 (``zero_stage`` 1: each rank holds its block of the dense
    moments over ``data``) on (2, 1): 2 steps, the shrink to (1, 1) by
    hand (the leaving rank's blocks are gathered with the rest), 2 steps,
    the grow back, 2 steps."""
    mesh = make_mesh((2, 1), ("data", "model"), device="cpu")
    t = _phi3_trainer(mesh, TrainerConfig(total_steps=2),
                      zero_stage=zero_stage)
    losses = []
    _losses(t, 2, losses)
    t.remesh(shrink_mesh(t.mesh, drop_axis_index=1))
    _losses(t, 4, losses)
    t.remesh(grow_mesh(t.mesh, mesh.ranks[1], insert_axis_index=1))
    _losses(t, 6, losses)
    return {"losses": losses, "zero_stage": t.plan.zero_stage}
