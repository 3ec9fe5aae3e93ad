"""Fault-tolerant training driver (the port of ``repro/runtime/trainer.py``).

Beyond the step:
  * deterministic resume: the data pipeline is step-addressed, so
    restoring (state, step) from a checkpoint reproduces the remaining
    stream; a checkpoint records the live plan (``Plan.tables()`` and the
    dense wire pins), and ``maybe_restore`` rebuilds that plan, so a run
    saved after a growth replan resumes with its grown capacities;
  * checkpoint / restart: async checkpoints every ``ckpt_every`` steps in
    the JAX package's layout (checkpoint/ckpt.py); on a mesh every rank
    gathers the state whole and rank 0 writes;
  * retries: a failed step restores the last committed checkpoint, or
    re-initializes from the seed when none is committed. The port's step
    updates the state in place, so a step that raised may have left it
    half-written: the live state is never reused;
  * adaptive replanning: with ``replan_every > 0`` the step's census
    scalars (``{table}_unique`` / ``_dropped``, and under
    ``RunConfig.wire_dtype_auto`` the magnitude census) feed a
    ``SparsityProfile`` EMA, and the planner periodically re-runs on the
    observed census (paper §5's profile -> re-optimize loop); a method
    flip, a capacity drift past ``replan_drift``x, an overflow growth or a
    wire flip hot-swaps the step (``transform.apply_replan``);
  * step-time monitoring (runtime/monitor.py).

The step's scalar metrics reach the host in one transfer every step (one
synchronize a step on the card), so the reference's
``metrics_host_every``, which spread the per-metric syncs out, has no
counterpart. The elastic half of the reference's
trainer (``remesh``, ``_auto_remesh``, ``readmit``, ``_flip_stale``,
``_heartbeat_batch`` and the ``remesh_on_straggle`` / ``stale_on_jitter``
knobs) is refused by name: ROADMAP slice 7.
"""
from __future__ import annotations

import dataclasses
import logging
import time
from dataclasses import dataclass
from typing import Callable, Optional

import torch

from repro_torch.analysis.contract import ContractViolation
from repro_torch.checkpoint.ckpt import (AsyncCheckpointer, latest_step,
                                         restore_checkpoint)
from repro_torch.configs.base import ModelConfig, RunConfig, ShapeConfig
from repro_torch.core import collectives as coll
from repro_torch.core.plan import plan_diff
from repro_torch.core.runtime import Runtime
from repro_torch.core.sparsity import (SparsityProfile, observed_census,
                                       wire_dtype_hints)
from repro_torch.core.transform import (analyze, apply_replan, build_step,
                                        estimate_census, fresh_state,
                                        load_state, local_batch)
from repro_torch.data.pipeline import Dataset
from repro_torch.models.model import build_model
from repro_torch.optim.optimizer import (fuse_state, is_fused,
                                         make_optimizer, unfuse_state)
from repro_torch.runtime.monitor import StepMonitor
from repro_torch.utils.dtypes import dtype_name
from repro_torch.utils.roofline import HW
from repro_torch.weights import gather_state

log = logging.getLogger("repro_torch.trainer")

_SLICE_7 = "ROADMAP slice 7 (elasticity)"


def _refuse(what: str):
    raise NotImplementedError(f"{what} is not ported yet: {_SLICE_7}")


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
    # ---- elasticity: away from these defaults, refused (slice 7) ----
    remesh_on_straggle: bool = False
    remesh_cooldown: int = 50      # the monitor's cooldown (it reads it)
    min_data_parallel: int = 1
    attribution: bool = True
    probation_steps: int = 100
    probation_sustained: int = 2
    stale_on_jitter: bool = False

    def __post_init__(self):
        for name in ("remesh_on_straggle", "min_data_parallel",
                     "attribution", "probation_steps",
                     "probation_sustained", "stale_on_jitter"):
            f = self.__dataclass_fields__[name]
            if getattr(self, name) != f.default:
                _refuse(f"TrainerConfig.{name}")


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
        self._build(mesh)

    # ------------------------------------------------------------------
    def _build(self, mesh):
        """Build the plan and the step from the build-time estimate, with
        a fresh state drawn from ``RunConfig.seed``."""
        self.mesh = mesh
        self.rt = Runtime(self.model_cfg, self.run_cfg, self.shape_cfg,
                          mesh=mesh, device=self.device)
        self.model = build_model(self.model_cfg, self.rt)
        self.plan = analyze(self.model, self.rt)
        self.rt.plan = self.plan
        self.optimizer = make_optimizer(self.rt)
        self.train_step, self.state = build_step(
            self.model, self.optimizer, self.rt, self.plan,
            seed=self.run_cfg.seed)
        self._note_plan_costs()

    @property
    def writer(self) -> bool:
        """Does this rank write the checkpoints (rank 0 of a mesh)?"""
        return self.mesh is None or self.mesh.rank == 0

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
        layout's moments as views of its flat buffers). Checkpoints and
        restore templates never see the fused layout: it is a per-plan
        memory layout that build_step rebuilds."""
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
        """Checkpoint the live state: gathered whole on every rank of a
        mesh (a collective), written by rank 0 alone."""
        state = gather_state(self._canonical_state(), self.plan, self.mesh)
        if self.writer:
            save = self.ckpt.save_sync if sync else self.ckpt.save
            save(self.step, state, extra=self._ckpt_extra())

    def _settle(self) -> None:
        """Wait for the writer's checkpoint in flight, then for every
        rank: what ``latest_step`` sees is the same on all of them."""
        if self.writer:
            self.ckpt.wait()
        coll.barrier(self.mesh)

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
        build-time census, and ``wire_pins`` re-applies the dense wire
        dtypes."""
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
        if any(e.get("stale") for e in saved.values()):
            _refuse("restoring a checkpoint with bounded-stale tables")
        new_plan = analyze(self.model, self.rt, census=census)
        diff = plan_diff(self.plan, new_plan)
        log.info("restore adopted the checkpoint's plan record: "
                 "capacities %s -> %s, flips=%s", diff["table_capacity"][0],
                 diff["table_capacity"][1], diff["flips"])
        self.plan = new_plan
        self.rt.plan = new_plan
        self.train_step, self.state = build_step(
            self.model, self.optimizer, self.rt, new_plan, state=state)
        self._note_plan_costs()

    def _observed_census(self, live_plan):
        """The census the replan loop runs on: the profile's observed
        uniques and overflow over the build-time estimate, sticky growth
        against ``live_plan`` and, under wire_dtype_auto, the wire hints
        from the magnitude census."""
        base = estimate_census(self.model, self.rt)
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

    # ---- the elastic half: ROADMAP slice 7 ----
    def remesh(self, new_mesh):
        _refuse("Trainer.remesh")

    def _auto_remesh(self):
        _refuse("Trainer._auto_remesh")

    def readmit(self):
        _refuse("Trainer.readmit")

    def _flip_stale(self, on: bool):
        _refuse("Trainer._flip_stale")

    def _heartbeat_batch(self, batch: dict):
        _refuse("Trainer._heartbeat_batch")

    # ------------------------------------------------------------------
    def maybe_replan(self) -> Optional[dict]:
        """Re-run the planner on the observed census; hot-swap on change.
        Returns the plan diff when a replan was evaluated, None while the
        profile has too few steps."""
        if not self.profile.ready(self.tcfg.replan_warmup):
            return None
        census = self._observed_census(self.plan)
        new_plan = analyze(self.model, self.rt, census=census)
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

    def run(self, on_metrics: Optional[Callable[[int, dict], None]] = None):
        tokens_per_step = self.shape_cfg.tokens
        retries = 0
        while self.step < self.tcfg.total_steps:
            batch = local_batch(self.rt, self.dataset.batch(self.step))
            self.monitor.start()
            try:
                self.state, metrics = self.train_step(self.state, batch)
                metrics = host_scalars(metrics)
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
                    self._save()
                except Exception as e:
                    log.exception("checkpoint at step %d failed", self.step)
                    self.monitor.note_ckpt_error(e)
            if self.monitor.straggler_suspected:
                log.warning("sustained step-time regression at step %d: "
                            "straggler suspected (the remesh response is "
                            "%s)", self.step, _SLICE_7)
            if on_metrics is not None:
                on_metrics(self.step, {**metrics, **stats})
            elif self.step % self.tcfg.log_every == 0:
                log.info("step %d loss %.4f %.0f tok/s", self.step,
                         float(metrics.get("loss", float("nan"))),
                         stats["tokens_per_s"])
        if self.ckpt is not None:
            self._save()
            self._settle()
        return self.state

