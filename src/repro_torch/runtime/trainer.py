"""Fault-tolerant, elastic training driver (the port of
``repro/runtime/trainer.py``).

Beyond the step:
  * deterministic resume: the data pipeline is step-addressed, so
    restoring (state, step) from a checkpoint reproduces the remaining
    stream; a checkpoint records the live plan (``Plan.tables()``, its
    stale flags and the dense wire pins), and ``maybe_restore`` rebuilds
    that plan, so a run saved after a growth replan, a remesh or inside a
    stale window resumes with it;
  * checkpoint / restart: async checkpoints every ``ckpt_every`` steps in
    the JAX package's layout (checkpoint/ckpt.py); on a mesh every rank
    gathers the state whole and the mesh's lead rank writes;
  * retries: a failed step restores the last committed checkpoint, or
    re-initializes from the seed when none is committed. The port's step
    updates the state in place, so a step that raised may have left it
    half-written: the live state is never reused;
  * adaptive replanning: with ``replan_every > 0`` the step's census
    scalars feed a ``SparsityProfile`` EMA and the planner periodically
    re-runs on the observed census (paper §5's profile -> re-optimize
    loop), hot-swapping the step on a change (``transform.apply_replan``);
  * elastic remesh: ``remesh(new_mesh)`` re-plans on the new mesh with the
    observed census carried across (so methods, capacities and buckets
    re-price at the new N) and gathers the live state whole and cuts it
    for the new plan, or leaves it where every staying rank keeps its
    shards (a data-axis change with no leaf cut over a batch axis and no
    placement moved). ``remesh_on_straggle`` acts on the monitor's
    sustained-outlier escalation (``_auto_remesh``): a checkpoint, then
    the shrink of the data axis by one slice (``launch/mesh.py::
    shrink_mesh``, floored at ``min_data_parallel``). With
    ``RunConfig.heartbeat`` the eviction is attributed: each rank's beat
    rides the fused metrics all-reduce and the monitor names the slow
    slice; without it the last slice goes by convention;
  * re-admission: ``readmit()`` grows the most recently evicted slice back
    at its grid position (``grow_mesh``) and arms the monitor's probation
    on it: a re-straggle inside ``probation_steps`` re-evicts at once;
  * bounded staleness: with ``stale_on_jitter`` and
    ``RunConfig.max_staleness > 0``, sustained jitter below the eviction
    threshold flips the sparse tables to the stale push (``_flip_stale``)
    and back, with the drain, once the jitter drains;
  * step-time monitoring (runtime/monitor.py).

Process meshes. The reference is one controller over every device; here
every rank runs this driver, so:

  * every decision is the same on every rank: the monitor times each
    rank's own clock, so a remesh, a stale flip or an eviction's slice is
    the live mesh's lead rank's verdict, broadcast (``_agree``), and a
    replan decides from all-reduced census values;
  * a rank's heartbeat is its own work, not its wall time: the step's
    time less the time it spent blocked in collectives
    (``collectives.blocked_seconds``), since every rank of a synchronous
    step waits for the slowest at each collective. The reference fills
    every slot with its one clock; ``heartbeat_fn`` (per-slot values by
    step) stands in for both;
  * an evicted rank is a live process. The trainer's entry points
    (``run``, ``remesh``, ``readmit``, ``_auto_remesh``, ``_flip_stale``,
    ``maybe_restore``, ``maybe_replan``) are called on every rank of the
    world; on a rank off the live mesh each waits on the world group for
    the live lead's messages: a new grid (whose groups every rank
    creates), its own re-admission (the live state then arrives by
    broadcast), or the end of the call. So no rank hangs and none is left
    behind; ``run`` returns None on a rank that is off the mesh;
  * the lead rank, not global rank 0, writes checkpoints and decides.

The step's scalar metrics reach the host in one transfer every step, so
the reference's ``metrics_host_every`` has no counterpart.
"""
from __future__ import annotations

import dataclasses
import functools
import gc
import logging
import time
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.analysis.contract import ContractViolation
from repro_torch.checkpoint.ckpt import (AsyncCheckpointer, latest_step,
                                         restore_checkpoint, state_leaves)
from repro_torch.configs.base import ModelConfig, RunConfig, ShapeConfig
from repro_torch.core import collectives as coll
from repro_torch.core.plan import entry_axes, plan_diff
from repro_torch.core.runtime import Runtime, mesh_dims
from repro_torch.core.sparsity import (SparsityProfile, observed_census,
                                       run_census, wire_dtype_hints)
from repro_torch.core.transform import (analyze, apply_replan, build_step,
                                        estimate_census, fresh_state,
                                        load_state, local_batch,
                                        stale_buffer_tables)
from repro_torch.data.pipeline import Dataset
from repro_torch.launch.mesh import (MeshShape, grow_mesh, mesh_from_ranks,
                                     shrink_mesh)
from repro_torch.models.model import build_model
from repro_torch.optim.optimizer import (TrainState, fuse_state, is_fused,
                                         make_optimizer, unfuse_state)
from repro_torch.runtime.monitor import StepMonitor
from repro_torch.utils.dtypes import dtype_name
from repro_torch.utils.roofline import HW
from repro_torch.utils.spans import span
from repro_torch.weights import gather_state

log = logging.getLogger("repro_torch.trainer")

_LIVE = object()       # ``_observed_census``'s default: the live mesh


class _Evicted(BaseException):
    """This rank left the live mesh inside a trainer call: unwinds to the
    outermost call, which then waits off the mesh (not an error, so no
    ``except Exception`` on the way swallows it)."""


def _elastic(fn):
    """A trainer entry point, called on every rank of the world. On the
    live mesh it runs; a rank that the call evicts, or that is off the
    mesh when the call starts, waits for the live lead's messages until
    the call ends there (``Trainer._outside``). The outermost call on the
    live ranks ends by telling the ranks off the mesh so. A ``remesh``
    onto a mesh that holds a rank now off the live one re-admits it."""
    @functools.wraps(fn)
    def call(self, *args, **kw):
        if self._depth:
            return fn(self, *args, **kw)
        if not self.live:
            new = (args[0] if args else kw.get("new_mesh")) \
                if fn.__name__ == "remesh" else None
            if not _on(new):
                if new is not None:
                    self.mesh = new    # the live ranks' next mesh, its lead
                return self._outside(fn.__name__, args, kw)
        self._depth = 1
        evicted = False
        try:
            out = fn(self, *args, **kw)
        except _Evicted:
            evicted = True            # waits below, its frames let go
        finally:
            self._depth = 0
        if evicted:
            return self._outside(fn.__name__, args, kw)
        if self._others_outside():
            self._to_world(("return",))
        return out
    return call


def _on(mesh) -> bool:
    """Is this rank on ``mesh`` (a process mesh)?"""
    return mesh is not None and getattr(mesh, "member", False)


def _ranks(mesh) -> set:
    return set(mesh.ranks.ravel().tolist())


# the axes the replicas lie along: a leaf's state cut over one of them
# differs between replicas
_BATCH = ("data", "pod")


def _batch_held(plan) -> bool:
    """Is some leaf's state cut over a batch axis (FSDP, ZeRO-1, dp)?"""
    axes = set(_BATCH)
    if plan.rules is not None:
        axes |= set(entry_axes(plan.rules.rules.get("batch")))
    return any(set(entry_axes(e)) & axes
               for p in plan.params.values()
               for e in tuple(p.held) + tuple(p.opt_held))


def _bucket_signature(plan) -> tuple:
    """A plan's bucket layout: per-bucket member indices and wire dtype.
    Index-keyed gbucket EMAs compare only between equal signatures."""
    if plan.bucket_plan is None:
        return ()
    return tuple((b.idx, b.key[1]) for b in plan.bucket_plan.buckets)


def host_scalars(metrics: dict) -> dict:
    """Every 0-d metric as a Python float, in one device-to-host transfer
    (each ``float(t)`` of a card tensor would synchronize on its own)."""
    keys = [k for k, v in metrics.items()
            if isinstance(v, torch.Tensor) and v.dim() == 0]
    out = {k: float(v) for k, v in metrics.items()
           if isinstance(v, (int, float))}
    if keys:
        vals = torch.stack([metrics[k].detach().float() for k in keys])
        out.update(zip(keys, vals.cpu().tolist()))
    return out


def _state_from_leaves(step: int, leaves: dict) -> TrainState:
    """A TrainState from ``{path: tensor}`` named as ``state_leaves`` names
    them (a part without leaves is None)."""
    parts = {"params": None, "m": None, "v": None, "ema": None,
             "stale": None}
    for path, t in leaves.items():
        part, name = path.split(".", 1)
        if part == "stale":
            table, key = name.rsplit(".", 1)
            parts["stale"] = parts["stale"] or {}
            parts["stale"].setdefault(table, {})[key] = t
        else:
            parts[part] = parts[part] or {}
            parts[part][name] = t
    return TrainState(step=step, **parts)


@dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    keep_ckpts: int = 3
    max_retries: int = 3
    log_every: int = 10
    # ---- profile -> replan loop (0 disables) ----
    replan_every: int = 0          # consider replanning every N steps
    replan_warmup: int = 2         # min profiled steps before first replan
    replan_drift: float = 1.5      # capacity drift factor that triggers it
    profile_decay: float = 0.9     # EMA decay of the sparsity profile
    # ---- elastic straggler response (auto-remesh) ----
    remesh_on_straggle: bool = False  # act on the monitor's escalation
    remesh_cooldown: int = 50      # steps before the monitor may re-escalate
    min_data_parallel: int = 1     # never shrink the data axis below this
    # ---- straggler attribution + probationary re-admission ----
    attribution: bool = True       # evict the heartbeat-attributed slice
                                   # (else the last slice, by convention)
    probation_steps: int = 100     # probation window after readmit()
    probation_sustained: int = 2   # outlier heartbeats on probation that
                                   # re-evict without a full escalation
    # ---- bounded-staleness sparse fallback (jitter below eviction) ----
    stale_on_jitter: bool = False  # flip sparse tables to stale pushes on
                                   # sustained jitter (needs
                                   # RunConfig.max_staleness > 0)


class Trainer:
    def __init__(self, model_cfg: ModelConfig, shape_cfg: ShapeConfig,
                 run_cfg: RunConfig, tcfg: TrainerConfig, dataset: Dataset,
                 mesh=None, *, device=None):
        self.model_cfg, self.shape_cfg = model_cfg, shape_cfg
        self.run_cfg, self.tcfg = run_cfg, tcfg
        self.dataset = dataset
        self.device = device
        self.monitor = StepMonitor(cooldown=tcfg.remesh_cooldown)
        self.ckpt = AsyncCheckpointer(tcfg.ckpt_dir, tcfg.keep_ckpts) \
            if tcfg.ckpt_dir else None
        self.step = 0
        self.profile = SparsityProfile(decay=tcfg.profile_decay)
        self.replan_history: list = []   # the diff of every hot-swap (with
                                         # its step and rebuild seconds)
        # per-slot heartbeat override: (step, n_slots) -> n step seconds.
        # Default: each rank's own work in the step (its time less the time
        # it spent blocked in collectives) in its slot
        self.heartbeat_fn: Optional[Callable] = None
        self._beat_origin = (0.0, 0.0)
        self._evicted: list = []       # LIFO of evicted slices (readmit)
        self._stale_tables: tuple = ()  # the live bounded-stale tables
        self._depth = 0                # nesting of the elastic entry points
        if mesh is not None and not _on(mesh):
            # a rank off ``mesh`` (made by a shrink on every rank): it
            # builds nothing and waits in each call, as an evicted rank
            self.mesh = mesh
            self.rt = self.model = self.plan = None
            self.state = self.train_step = None
            return
        self._build(mesh)

    # ------------------------------------------------------------------
    def _plan_on(self, mesh, census=None) -> tuple:
        """(runtime, model, plan) on ``mesh``: from ``census`` (the
        build-time estimate when None) and the live stale tables."""
        rt = Runtime(self.model_cfg, self.run_cfg, self.shape_cfg,
                     mesh=mesh, device=self.device)
        model = build_model(self.model_cfg, rt)
        plan = analyze(model, rt, census=census,
                       stale_tables=self._stale_tables)
        rt.plan = plan
        return rt, model, plan

    def _build(self, mesh, state=None, census=None, planned=None):
        """Build the plan (``planned``: ``_plan_on``'s, or made here) and
        the step on ``mesh``, on ``state`` (a canonical state, whole or
        this rank's shards) or a fresh one drawn from
        ``RunConfig.seed``."""
        self.mesh = mesh
        self.rt, self.model, self.plan = planned or self._plan_on(mesh,
                                                                  census)
        self.optimizer = make_optimizer(self.rt)
        self.train_step, self.state = build_step(
            self.model, self.optimizer, self.rt, self.plan, state=state,
            seed=self.run_cfg.seed)
        self._note_plan_costs()

    @property
    def live(self) -> bool:
        """Is this rank on the live mesh (not evicted)?"""
        return self.mesh is None or getattr(self.mesh, "member", True)

    @property
    def writer(self) -> bool:
        """Does this rank write the checkpoints (the live mesh's lead)?"""
        return self.mesh is None or self.mesh.rank == self.mesh.lead

    def _note_plan_costs(self):
        self.monitor.note_exchange(
            self.plan.bucket_plan.stats() if self.plan.bucket_plan else None)
        self.monitor.note_apply(self._apply_seconds_estimate())

    def _apply_seconds_estimate(self) -> Optional[float]:
        """Analytic optimizer-apply seconds for the live plan: the bytes
        the update moves (parameters read and written, each f32 moment and
        the EMA read and written, gradients read once; the per-param path
        under a bucket plan also the unflatten -> reflatten round trip the
        fused apply skips) over the hardware record's HBM rate."""
        leaves = list(self.plan.params.values())
        if not leaves:
            return None
        itemsize = torch.empty((), dtype=self.rt.param_dtype).element_size()
        pbytes = sum(p.bytes for p in leaves)
        f32b = sum(p.bytes // itemsize for p in leaves) * 4
        n_moments = {"adamw": 2, "momentum": 1}.get(
            self.run_cfg.optimizer, 0)
        total = 3 * pbytes + 2 * n_moments * f32b
        if self.run_cfg.ema_decay:
            total += 2 * f32b
        bp = self.plan.bucket_plan
        if bp is not None and not self.plan.fused_apply:
            total += 2 * bp.wire_bytes
        hw = bp.hw if bp is not None and bp.hw is not None else HW
        return total / hw.hbm_bw

    def _canonical_state(self):
        """The live state in the canonical per-param layout (a fused
        layout's moments as views of its flat buffers). Checkpoints,
        restore templates and remeshes never see the fused layout: it is a
        per-plan memory layout that build_step rebuilds."""
        if is_fused(self.state):
            return unfuse_state(self.state, self.plan.bucket_plan)
        return self.state

    # ------------------------------------------------------------------
    def _wire_pins(self, plan) -> dict:
        """Dense parameters whose planned wire dtype differs from the
        global knob (the profiled wire_dtype_auto pins): part of the
        manifest's plan record, which Plan.tables() (sparse only) lacks."""
        base = dtype_name(self.rt.wire_dtype)
        return {p.name: dtype_name(p.wire_dtype)
                for p in plan.params.values()
                if not p.sparse and dtype_name(p.wire_dtype) != base}

    def _ckpt_extra(self) -> dict:
        """The manifest's ``extra``: the dataset cursor, the live plan's
        per-table record and the dense wire pins (and the mesh), so a
        restore rebuilds the saved plan instead of the build-time
        estimate."""
        extra = {"dataset_step": self.step, "plan": self.plan.tables()}
        pins = self._wire_pins(self.plan)
        if pins:
            extra["wire_pins"] = pins
        if self.mesh is not None:
            extra["mesh"] = dict(self.mesh.shape)
        return extra

    def _save(self, sync: bool = False) -> None:
        """Checkpoint the live state: gathered whole on every rank of the
        live mesh (a collective), written by its lead alone."""
        state = gather_state(self._canonical_state(), self.plan, self.mesh)
        if self.writer:
            save = self.ckpt.save_sync if sync else self.ckpt.save
            save(self.step, state, extra=self._ckpt_extra())

    def _settle(self) -> None:
        """Wait for the writer's checkpoint in flight, then for every
        rank of the live mesh: what ``latest_step`` sees is the same on all
        of them."""
        if self.writer:
            self.ckpt.wait()
        coll.barrier(self.mesh)

    @_elastic
    def maybe_restore(self):
        if self.ckpt is None:
            return
        self._settle()
        if latest_step(self.tcfg.ckpt_dir) is None:
            return
        state, self.step, extra = restore_checkpoint(
            self.tcfg.ckpt_dir, self._canonical_state(),
            device=self.rt.device)
        saved = (extra or {}).get("plan")
        pins = (extra or {}).get("wire_pins", {})
        if (saved and saved != self.plan.tables()) or \
                pins != self._wire_pins(self.plan):
            self._adopt_saved_plan(saved or {}, pins, state)
        else:
            # the plan holds: the values go into the live parameters in
            # place and the step is kept
            self.state = load_state(self.model, self.rt, self.plan, state)
            if self.plan.fused_apply:
                self.state = fuse_state(self.state, self.plan.bucket_plan)
        self.monitor.note_recovery()
        log.info("restored checkpoint at step %d", self.step)

    def _adopt_saved_plan(self, saved: dict, wire_pins: dict, state):
        """Re-plan against a checkpoint's plan record and rebuild the step
        on the restored (whole) state: the saved α reproduces each
        table's method, the saved capacities and grown flags override the
        build-time census, ``wire_pins`` re-applies the dense wire dtypes,
        and the saved stale flags say which tables resume stale."""
        census = estimate_census(self.model, self.rt)
        if wire_pins:
            census.wire_dtypes.update(wire_pins)
        for name, ent in saved.items():
            t = census.tables.get(name)
            if t is None:
                continue
            alpha = ent.get("alpha")
            census.tables[name] = dataclasses.replace(
                t, alpha=float(alpha) if alpha is not None else t.alpha,
                capacity=int(ent.get("capacity", t.capacity)),
                grown=bool(ent.get("grown", False)))
            if ent.get("wire_dtype"):
                census.wire_dtypes[name] = ent["wire_dtype"]
        if census.tables:
            census.capacity = max(
                census.capacity,
                max(t.capacity for t in census.tables.values()))
        # the checkpoint's stale flags decide which tables run the bounded
        # stale push: a run saved inside a stale window resumes stale
        self._stale_tables = tuple(sorted(
            n for n, e in saved.items() if e.get("stale")))
        self.monitor._stale_on = bool(self._stale_tables)   # no flip counted
        new_plan = analyze(self.model, self.rt, census=census,
                           stale_tables=self._stale_tables)
        diff = plan_diff(self.plan, new_plan)
        log.info("restore adopted the checkpoint's plan record: "
                 "capacities %s -> %s, flips=%s", diff["table_capacity"][0],
                 diff["table_capacity"][1], diff["flips"])
        self.plan = new_plan
        self.rt.plan = new_plan
        self.train_step, self.state = build_step(
            self.model, self.optimizer, self.rt, new_plan, state=state)
        self._note_plan_costs()

    def _observed_census(self, live_plan, mesh=_LIVE):
        """The census the replan loop runs on: the profile's observed
        uniques and overflow over the build-time estimate for ``mesh``
        (default: the live one; a remesh prices the new world), sticky
        growth against ``live_plan`` and, under wire_dtype_auto, the wire
        hints from the magnitude census."""
        if mesh is _LIVE:
            base = estimate_census(self.model, self.rt)
        else:
            base = run_census(self.model.specs(), self.model_cfg,
                              self.shape_cfg, self.run_cfg,
                              mesh_dims(mesh).replicas)
        live = {n: (live_plan.table_capacity.get(n, 0),
                    n in live_plan.grown_tables)
                for n in live_plan.table_methods}
        census = observed_census(self.profile, base,
                                 self.model_cfg.vocab_size, self.run_cfg,
                                 live=live)
        if self.run_cfg.wire_dtype_auto and live_plan.bucket_plan is not None:
            census.wire_dtypes = wire_dtype_hints(
                self.profile, live_plan.bucket_plan, list(live_plan.params),
                outlier_ratio=self.run_cfg.wire_outlier_ratio,
                default=self.run_cfg.wire_dtype,
                # tables with their own exchange emit a name-keyed census
                sparse_tables=[n for n, m in live_plan.table_methods.items()
                               if m != "allreduce"])
        return census

    # ------------------------------------------------------------------
    # the elastic half: every rank of the world, on the mesh or off it
    # ------------------------------------------------------------------
    def _others_outside(self) -> bool:
        """Are there ranks of the world off the live mesh?"""
        return self.mesh is not None and \
            self.mesh.ranks.size < coll.world_size()

    def _to_world(self, msg):
        """The live lead's message to every rank of the world (the ranks
        off the mesh wait on it)."""
        return coll.broadcast_object(msg, src=self.mesh.lead)

    def _agree(self, value):
        """The live lead's ``value`` on every rank of the live mesh: each
        rank's monitor reads its own clock, so a decision taken on
        per-rank times is the lead's."""
        if self.mesh is None:
            return value
        return coll.broadcast_object(value, self.mesh)

    def _shape(self) -> MeshShape:
        """The live mesh's grid as a ``MeshShape`` (no process groups)."""
        m = self.mesh
        return MeshShape(m.ranks.shape, m.axis_names, ranks=m.ranks,
                         host_of=m.host_of)

    def _realize(self, grid: MeshShape):
        """``grid`` as a process mesh: collective over the world, so the
        ranks off the live mesh are sent the grid first."""
        if self._others_outside():
            self._to_world(("mesh", grid.ranks))
        return mesh_from_ranks(grid.ranks, self.mesh.axis_names,
                               device=self.mesh.device,
                               host_of=self.mesh.host_of)

    def _outside(self, name: str, args: tuple, kw: dict):
        """Off the live mesh: wait on the world for the live lead's
        messages until its call ``name`` ends there. A new grid is created
        here as on every rank; one that holds this rank re-admits it (the
        live state arrives, ``remesh``), after which a ``run`` goes on
        training and any other call ends with the live ranks'."""
        while True:
            msg = coll.broadcast_object(None, src=self.mesh.lead)
            if msg[0] == "return":
                return None
            mesh = mesh_from_ranks(msg[1], self.mesh.axis_names,
                                   device=self.mesh.device,
                                   host_of=self.mesh.host_of)
            if not mesh.member:
                self.mesh = mesh
                continue
            self._depth = 1
            Trainer.remesh.__wrapped__(self, mesh)
            self._depth = 0
            if name == "run":
                return self.run(*args, **kw)
            if self._others_outside():
                self._to_world(None)      # the live ranks' end of the call
            return None

    def _drop_state(self) -> None:
        """Let the live state, the model and the step go, and hand the
        card's cached blocks back (ranks that share a card need them)."""
        if self.rt is not None and self.rt.overlap is not None:
            self.rt.overlap.remove()   # the step's gradient hooks
        self.state = self.train_step = self.model = None
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    def _send_join(self, new_mesh, state, census, keep: bool) -> None:
        """Hand the returning ranks of ``new_mesh`` what they need to build
        on it as the live ranks do: the driver's bookkeeping from the live
        lead, over the new mesh's ranks; then the state: ``keep`` (every
        shard stays its rank's) this rank's shards from the first live
        rank of each data group to that group, else the whole state from
        the live lead to every rank of the new mesh."""
        src = self.mesh.lead
        book = None
        if self.mesh.rank == src:
            book = {"step": self.step, "profile": self.profile,
                    "monitor": self.monitor,
                    "stale_tables": self._stale_tables,
                    "evicted": self._evicted,
                    "replan_history": self.replan_history,
                    "census": census, "keep": keep,
                    "bucket_signature": _bucket_signature(self.plan)}
        coll.broadcast_object(book, new_mesh, src=src)
        self._send_state(new_mesh, state, keep)

    def _state_src(self, new_mesh, keep: bool) -> tuple:
        """(the rank the state comes from, the axes it travels over)."""
        if not keep:
            return self.mesh.lead, new_mesh.axis_names
        live = _ranks(self.mesh)
        group = np.moveaxis(new_mesh.ranks, new_mesh.axis_names.index(
            "data"), -1).reshape(-1, new_mesh.shape["data"])
        row = next(r for r in group.tolist() if new_mesh.rank in r)
        return next(r for r in row if r in live), ("data",)

    def _send_state(self, new_mesh, state, keep: bool) -> None:
        src, axes = self._state_src(new_mesh, keep)
        leaves = state_leaves(state)
        coll.broadcast_object((state.step, [(p, tuple(t.shape), t.dtype)
                                            for p, t in leaves[1:]]),
                              new_mesh, src=src, axes=axes)
        for _, t in leaves[1:]:
            # a leaf is the live parameter itself: received in place (the
            # same values) outside autograd
            coll.broadcast(t.detach(), new_mesh, src=src, axes=axes)

    def _receive_join(self, new_mesh) -> tuple:
        """The returning side of ``_send_join`` -> (state: this rank's
        shards or whole, census, the live plan's bucket signature)."""
        book = coll.broadcast_object(None, new_mesh, src=self.mesh.lead)
        self.step, self.profile = book["step"], book["profile"]
        self.monitor = book["monitor"]
        self._stale_tables = book["stale_tables"]
        self._evicted = book["evicted"]
        self.replan_history = book["replan_history"]
        src, axes = self._state_src(new_mesh, book["keep"])
        step, spec = coll.broadcast_object(None, new_mesh, src=src,
                                           axes=axes)
        leaves = {}
        for path, shape, dtype in spec:
            t = torch.empty(shape, dtype=dtype, device=new_mesh.device)
            leaves[path] = coll.broadcast(t, new_mesh, src=src, axes=axes)
        return (_state_from_leaves(step, leaves), book["census"],
                book["bucket_signature"])

    def _keeps_shards(self, new_mesh, new_plan) -> bool:
        """Does every rank staying on ``new_mesh`` keep its shards under
        ``new_plan`` (a change of the data axis alone, no leaf's state over
        a batch axis, every leaf's placements and groups the same)? Then
        a remesh moves no state on the staying ranks."""
        old = self.mesh
        if new_mesh is None or old is None or _batch_held(self.plan) or \
                _batch_held(new_plan) or \
                new_mesh.axis_names != old.axis_names or any(
                    new_mesh.shape[a] != old.shape[a]
                    for a in old.axis_names if a not in _BATCH):
            return False
        return all((p.held, p.opt_held, p.groups) ==
                   (q.held, q.opt_held, q.groups)
                   for p, q in zip(self.plan.params.values(),
                                   new_plan.params.values()))

    @_elastic
    def remesh(self, new_mesh):
        """Move the live state onto ``new_mesh`` (a shrink or a grow of the
        live mesh, made on every rank of the world; None: one device): the
        plan re-run on the new world with the observed census carried
        across (grown capacities and profiled choices survive, the
        world-size terms re-price); the state gathered whole and cut for
        the new plan, or, where every staying rank keeps its shards
        (``_keeps_shards``), left in place. Ranks the new mesh leaves out
        stop training; ranks it brings back receive the state from the live
        ranks (their data group's shards, else the whole from the lead).
        The bucket EMAs reset when the bucket layout regroups."""
        planned = None
        if not self.live:
            state, census, old_sig = self._receive_join(new_mesh)
        else:
            census = (self._observed_census(self.plan, new_mesh)
                      if self.profile.ready() else None)
            old_sig = _bucket_signature(self.plan)
            staying = new_mesh is None or new_mesh.member
            if staying:
                planned = self._plan_on(new_mesh, census)
            # the same on every rank of the old mesh: the first of them
            # that stays decides (the lead may be leaving)
            keep = staying and self._keeps_shards(new_mesh, planned[2])
            if self.mesh is not None and new_mesh is not None:
                keep = coll.broadcast_object(keep, self.mesh, src=next(
                    r for r in self.mesh.ranks.ravel().tolist()
                    if r in _ranks(new_mesh)))
            if torch.cuda.is_available():
                torch.cuda.empty_cache()   # the steps' cached blocks
            state = self._canonical_state()
            log.info("remesh %s -> %s: %s", dict(self.mesh.shape)
                     if self.mesh is not None else None,
                     dict(new_mesh.shape) if new_mesh is not None else None,
                     "every shard stays" if keep else "the state moves whole")
            if not keep and (staying or _batch_held(self.plan)):
                # a leaving rank's shards are needed only where some leaf
                # is cut over a batch axis; else the leaving ranks are
                # whole data slices, whose groups leave with them
                state = gather_state(state, self.plan, self.mesh)
            if self.mesh is not None and new_mesh is not None and \
                    _ranks(new_mesh) - _ranks(self.mesh):
                if self.mesh.lead not in _ranks(new_mesh):
                    raise ValueError("a mesh that brings ranks back must "
                                     "keep the live lead rank")
                self._send_join(new_mesh, state, census, keep)
        self._drop_state()             # ``state`` holds what stays
        if new_mesh is not None and not new_mesh.member:
            # evicted: this process stays up, off the mesh, holding nothing
            self.mesh = new_mesh
            del state
            raise _Evicted
        self._build(new_mesh, state=state, census=census, planned=planned)
        if _bucket_signature(self.plan) != old_sig:
            # bucket magnitude EMAs are index-keyed: a regrouped layout on
            # the new mesh makes the old samples mis-attributed
            self.profile.reset_grad_census()

    @_elastic
    def _auto_remesh(self) -> Optional[dict]:
        """Act on the monitor's straggler escalation: commit a checkpoint,
        evict the slow data slice, and resume on the live state. With
        heartbeat attribution the monitor names the slice (on a mesh that
        spans hosts, through the host that owns it:
        ``shrink_mesh(drop_process_index=...)``); otherwise the last slice
        goes by convention. The evicted slice (its ranks and grid
        position) is recorded for ``readmit``. Returns the plan diff
        across the remesh, or None when the mesh cannot shrink."""
        if self.mesh is None or "data" not in self.mesh.axis_names:
            self.monitor.note_recovery()
            return None
        grid = self._shape()
        ax = grid.axis_names.index("data")
        size = grid.shape["data"]
        slot = self.monitor.straggler_slice() if self.tcfg.attribution \
            else None
        slot = self._agree(slot)
        if slot is not None and tuple(self.rt.batch_axes) == ("data",) \
                and 0 <= int(slot) < size:
            drop = int(slot)       # heartbeat slots are data grid indices
        else:
            slot = None
            drop = size - 1        # the by-convention fallback
        ranks = np.take(grid.ranks, drop, axis=ax)
        kw = {"drop_axis_index": drop}
        if slot is not None and grid.hosts > 1:
            procs = {grid.host_of[int(r)] for r in ranks.flat}
            if len(procs) == 1:
                kw = {"drop_process_index": procs.pop()}
        shrunk = shrink_mesh(grid, axis="data",
                             min_axis_size=self.tcfg.min_data_parallel, **kw)
        if shrunk is None:
            log.warning(
                "straggler escalation at step %d but the mesh cannot "
                "shrink (data axis at or below min_data_parallel=%d): "
                "re-arming the monitor", self.step,
                self.tcfg.min_data_parallel)
            self.monitor.note_recovery()   # re-arm instead of re-firing
            self.monitor._probation_trip = None
            return None
        if self.ckpt is not None:
            # a synchronous commit before the state moves: a crash in the
            # remesh recovers from this step. Its failure does not stop
            # the live-state remesh, which does not depend on it
            try:
                self._save(sync=True)
            except Exception as e:
                log.exception("pre-remesh checkpoint failed; continuing "
                              "with the live-state remesh")
                self.monitor.note_ckpt_error(e)
        old_plan, old_shape = self.plan, dict(self.mesh.shape)
        self._evicted.append({"ranks": ranks, "index": drop, "slot": slot,
                              "step": self.step})
        self.remesh(self._realize(shrunk))
        diff = plan_diff(old_plan, self.plan)
        self.monitor.note_remesh()
        log.warning(
            "auto-remesh at step %d: mesh %s -> %s (%s data slice %d), "
            "flips=%s, capacities %s -> %s", self.step, old_shape,
            dict(self.mesh.shape),
            "heartbeat-attributed" if slot is not None else "by-convention",
            drop, diff["flips"], diff["table_capacity"][0],
            diff["table_capacity"][1])
        return diff

    @_elastic
    def readmit(self) -> Optional[dict]:
        """Re-admit the most recently evicted slice on probation: commit a
        checkpoint, grow the mesh back with the slice at its grid position
        (``grow_mesh``), move the live state onto it (``remesh``: the
        returning ranks receive it) and arm the monitor's probation on the
        slice: ``probation_sustained`` outlier heartbeats from it within
        ``probation_steps`` re-evict it at once. Returns the plan diff, or
        None when nothing is evicted."""
        if not self._evicted or self.mesh is None:
            return None
        ev = self._evicted[-1]
        try:
            grown = grow_mesh(self._shape(), ev["ranks"],
                              insert_axis_index=ev["index"], axis="data")
        except ValueError as e:
            log.warning("readmit at step %d impossible: %s", self.step, e)
            return None
        self._evicted.pop()
        if self.ckpt is not None:
            try:
                self._save(sync=True)
            except Exception as e:
                log.exception("pre-readmit checkpoint failed; continuing "
                              "with the live-state re-grow")
                self.monitor.note_ckpt_error(e)
        old_plan, old_shape = self.plan, dict(self.mesh.shape)
        # before the remesh, so that the returning ranks receive it armed
        self.monitor.note_regrow(
            slot=ev["index"], probation_steps=self.tcfg.probation_steps,
            probation_sustained=self.tcfg.probation_sustained)
        self.remesh(self._realize(grown))
        diff = plan_diff(old_plan, self.plan)
        log.warning(
            "readmit at step %d: mesh %s -> %s (slice %d back on probation "
            "for %d steps), flips=%s", self.step, old_shape,
            dict(self.mesh.shape), ev["index"], self.tcfg.probation_steps,
            diff["flips"])
        return diff

    @_elastic
    def _flip_stale(self, on: bool) -> Optional[dict]:
        """Flip the stale-eligible sparse tables to (or back from) the
        bounded-staleness push and hot-swap the step. The buffers are part
        of the state whatever the flags (``ensure_stale_buffers``): only
        ``Plan.stale_tables`` and the step change, and the first
        synchronous step after a flip back drains the last buffered
        gradient in its own update. Returns the plan diff, or None when
        nothing flips."""
        target = stale_buffer_tables(self.plan, self.rt) if on else ()
        if tuple(target) == tuple(self.plan.stale_tables):
            return None
        census = self._observed_census(self.plan) if self.profile.ready() \
            else None
        new_plan = analyze(self.model, self.rt, census=census,
                           stale_tables=tuple(target))
        diff = plan_diff(self.plan, new_plan)
        if not diff["changed"]:
            return None
        self._stale_tables = tuple(new_plan.stale_tables)
        self.plan = new_plan
        self.train_step, self.state = apply_replan(
            self.model, self.optimizer, self.rt, new_plan, self.state, diff)
        self.monitor.note_stale_flip(bool(new_plan.stale_tables))
        self._note_plan_costs()
        log.warning(
            "stale flip at step %d (jitter %.2f): tables %s now %s "
            "(max_staleness=%d)", self.step, self.monitor.jitter_ratio,
            list(new_plan.stale_tables) or diff["stale_flips"],
            "bounded-stale" if new_plan.stale_tables else "synchronous",
            self.run_cfg.max_staleness)
        return diff

    def _heartbeat_batch(self, batch: dict) -> dict:
        """The batch with the per-slot heartbeat vector the step carries
        through the fused metrics all-reduce (``RunConfig.heartbeat``, on a
        mesh); ``local_batch`` keeps this replica's slot. The values are
        ``heartbeat_fn(step, n)`` when it is set; else the step reports
        this rank's own work (``_own_work`` as ``Runtime.beat``)."""
        if not self.run_cfg.heartbeat or self.mesh is None:
            return batch
        n = max(self.rt.replicas, 1)
        self.rt.beat = None if self.heartbeat_fn is not None \
            else self._own_work
        hb = np.zeros((n,), np.float32) if self.heartbeat_fn is None else \
            np.asarray(self.heartbeat_fn(self.step, n), np.float32).reshape(n)
        return {**batch, "_heartbeat": hb}

    def _own_work(self) -> float:
        """Seconds since the running step started less the time this rank
        spent blocked in collectives since: its own work, which a slow
        rank's exceeds while every rank's wall time is the slowest's."""
        t0, blocked0 = self._beat_origin
        return time.perf_counter() - t0 - (coll.blocked_seconds() - blocked0)

    def _decide(self) -> Optional[str]:
        """This step's elastic action, the lead's verdict on every rank:
        "remesh" (a straggler escalation with ``remesh_on_straggle``),
        "stale_on" / "stale_off" (the jitter fallback, below eviction), or
        None."""
        m, act = self.monitor, None
        stale_knob = self.tcfg.stale_on_jitter and \
            self.run_cfg.max_staleness > 0
        if m.remesh_suggested and self.tcfg.remesh_on_straggle:
            act = "remesh"
        elif m.straggler_suspected:
            log.warning("sustained step-time regression at step %d: "
                        "straggler suspected; consider remesh() or "
                        "remesh_on_straggle=True", self.step)
        elif stale_knob:
            if m.stale_suggested:
                act = "stale_on"
            elif m.stale_recovered:
                act = "stale_off"
        if self.tcfg.remesh_on_straggle or stale_knob:
            act = self._agree(act)
        return act

    # ------------------------------------------------------------------
    @_elastic
    def maybe_replan(self) -> Optional[dict]:
        """Re-run the planner on the observed census; hot-swap on change.
        Returns the plan diff when a replan was evaluated, None while the
        profile has too few steps."""
        if not self.profile.ready(self.tcfg.replan_warmup):
            return None
        census = self._observed_census(self.plan)
        new_plan = analyze(self.model, self.rt, census=census,
                           stale_tables=self._stale_tables)
        diff = plan_diff(self.plan, new_plan, self.tcfg.replan_drift)
        self.monitor.note_alpha(census.alpha)
        if not diff["changed"]:
            return diff
        log.info(
            "replan at step %d: alpha %.4f -> %.4f, capacity %d -> %d "
            "(tables %s -> %s%s), flips=%s, wire_flips=%s, "
            "pspecs_changed=%s", self.step, diff["alpha"][0],
            diff["alpha"][1], diff["capacity"][0], diff["capacity"][1],
            diff["table_capacity"][0], diff["table_capacity"][1],
            ", overflow-grown" if diff["capacity_grown"] else "",
            diff["flips"], diff["wire_flips"], diff["pspecs_changed"])
        old_sig = _bucket_signature(self.plan)
        self.plan = new_plan
        t0 = time.perf_counter()
        self.train_step, self.state = apply_replan(
            self.model, self.optimizer, self.rt, new_plan, self.state, diff)
        diff["rebuild_s"] = time.perf_counter() - t0
        diff["step"] = self.step
        self.replan_history.append(diff)
        if _bucket_signature(new_plan) != old_sig:
            # bucket metrics are index-keyed: a regrouped layout makes the
            # old per-bucket EMAs mis-attributed
            self.profile.reset_grad_census()
        self.monitor.note_replan()
        self._note_plan_costs()
        return diff

    def _recover(self) -> None:
        """After a failed step: restore the last committed checkpoint, or
        re-initialize from the seed at step 0 when none is committed. The
        failed step may have half-updated the live state in place."""
        try:
            self._settle()
        except Exception:
            log.exception("in-flight checkpoint also failed")
            coll.barrier(self.mesh)
        if latest_step(self.tcfg.ckpt_dir) is None:
            log.warning("no committed checkpoint: reinitializing state "
                        "from seed %d at step 0", self.run_cfg.seed)
            self.train_step, self.state = build_step(
                self.model, self.optimizer, self.rt, self.plan,
                state=fresh_state(self.model, self.optimizer,
                                  self.run_cfg.seed))
            self.step = 0
            self.monitor.note_recovery()
        else:
            self.maybe_restore()

    @_elastic
    def run(self, on_metrics: Optional[Callable[[int, dict], None]] = None):
        """Train to ``total_steps``; -> the live state (None on a rank the
        run left off the mesh)."""
        tokens_per_step = self.shape_cfg.tokens
        retries = 0
        while self.step < self.tcfg.total_steps:
            with span("trainer.batch"):
                batch = local_batch(self.rt, self._heartbeat_batch(
                    self.dataset.batch(self.step)))
            self.monitor.start()
            self._beat_origin = (time.perf_counter(), coll.blocked_seconds())
            try:
                with span("trainer.step"):
                    self.state, metrics = self.train_step(self.state, batch)
                with span("trainer.metrics"):
                    metrics = host_scalars(metrics)
                with span("trainer.profile"):
                    # the heartbeat slots leave the user's metrics for the
                    # attribution state (stats carries their EMAs)
                    beats = {int(k[9:]): metrics.pop(k) for k in list(metrics)
                             if k.startswith("heartbeat") and k[9:].isdigit()}
                    if beats:
                        self.monitor.note_heartbeats(beats)
                    self.profile.update(metrics)
                    self.monitor.note_overflow(
                        self.profile.dropped(self.plan.table_methods))
                retries = 0
            except ContractViolation:
                raise             # the step breaks its plan: no retry mends it
            except Exception:     # the failure path: restore and retry
                retries += 1
                log.exception("step %d failed (retry %d/%d)",
                              self.step, retries, self.tcfg.max_retries)
                if retries > self.tcfg.max_retries or self.ckpt is None:
                    raise
                self._recover()
                continue
            stats = self.monitor.stop(tokens=tokens_per_step)
            self.step += 1
            if self.tcfg.replan_every and \
                    self.step % self.tcfg.replan_every == 0:
                with span("trainer.replan"):
                    self.maybe_replan()
                # this step's stats reflect a replan it triggered
                stats["replans"] = self.monitor.replans
                if self.monitor.observed_alpha is not None:
                    stats["observed_alpha"] = self.monitor.observed_alpha
            if self.ckpt is not None:
                self.monitor.note_ckpt_error(self.ckpt.error)
                self.monitor.note_ckpt_retries(self.ckpt.total_retries)
            if self.ckpt is not None and self.step % self.tcfg.ckpt_every == 0:
                # a failed earlier background write re-raises out of the
                # save's wait(): surface it and try again next period
                try:
                    with span("trainer.ckpt"):
                        self._save()
                except Exception as e:
                    log.exception("checkpoint at step %d failed", self.step)
                    self.monitor.note_ckpt_error(e)
            with span("trainer.decide"):
                act = self._decide()
                if act == "remesh":
                    if self._auto_remesh() is not None:
                        stats["remeshes"] = self.monitor.remeshes
                        if self.mesh is not None:
                            stats["mesh"] = dict(self.mesh.shape)
                elif act is not None:
                    if self._flip_stale(act == "stale_on") is not None:
                        stats["stale_flips"] = self.monitor.stale_flips
                        stats["stale_mode"] = self.monitor._stale_on
            if on_metrics is not None:
                on_metrics(self.step, {**metrics, **stats})
            elif self.step % self.tcfg.log_every == 0:
                log.info("step %d loss %.4f %.0f tok/s", self.step,
                         float(metrics.get("loss", float("nan"))),
                         stats["tokens_per_s"])
        if self.ckpt is not None:
            with span("trainer.ckpt"):
                self._save()
                self._settle()
        return self.state
