"""Runtime handle threaded through model code: configs, mesh, rules, plan,
dtypes and the device (the port of ``repro/core/runtime.py``).

The device is explicit: ``None`` means the card (``"cuda"``), or the
mesh's device when a ``launch/mesh.py::Mesh`` is given; tests pass
``"cpu"``. Nothing moves to the CPU on its own when no card is found.

Every step of the port runs per rank, so the reference's
``manual_region`` / ``in_manual_region`` (which tell global-semantics
model code that it runs inside a shard_map) have no counterpart: model
code here always sees this rank's shards (ROADMAP Queue 3).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch

from repro_torch.configs.base import ModelConfig, RunConfig, ShapeConfig
from repro_torch.core import cost_model
from repro_torch.core.embedding import EmbedCtx
from repro_torch.core.plan import MeshRules, default_rules
from repro_torch.launch.mesh import Mesh, MeshShape
from repro_torch.utils.dtypes import torch_dtype


def resolve_device(device=None) -> torch.device:
    """``None`` -> the card. An explicit device is taken as given."""
    return torch.device("cuda" if device is None else device)


def check_ported(run_cfg: RunConfig, mesh: Any = None) -> None:
    """Refuse, by name, what this slice of the port does not run, rather
    than silently ignoring it. A mesh is a ``launch/mesh.py`` ``Mesh`` (or
    a ``MeshShape``, which plans but holds no process groups)."""
    if mesh is not None and not isinstance(mesh, MeshShape):
        raise TypeError(f"mesh must be a launch/mesh.py MeshShape or Mesh, "
                        f"got {type(mesh).__name__}")
    refusals = [
        (run_cfg.heartbeat, "RunConfig.heartbeat", "slice 7 (elasticity)"),
        (run_cfg.max_staleness > 0, "RunConfig.max_staleness > 0",
         "slice 7 (elasticity)"),
        (run_cfg.kernel_autotune, "RunConfig.kernel_autotune",
         "slice 8 (tooling)"),
        (run_cfg.verify_contract, "RunConfig.verify_contract",
         "slice 8 (tooling)"),
    ]
    for hit, what, where in refusals:
        if hit:
            raise NotImplementedError(
                f"{what} is not ported yet: ROADMAP {where}")


def mesh_dims(mesh) -> cost_model.MeshDims:
    if mesh is None:
        return cost_model.MeshDims()
    get = lambda a: mesh.shape[a] if a in mesh.axis_names else 1
    return cost_model.MeshDims(model=get("model"), data=get("data"),
                               pod=get("pod"),
                               hosts=cost_model.mesh_hosts(mesh))


@dataclass
class Runtime:
    model_cfg: ModelConfig
    run_cfg: RunConfig
    shape_cfg: ShapeConfig
    mesh: Any = None                    # launch/mesh.py MeshShape or Mesh
    plan: Optional[Any] = None          # core/plan.py Plan
    device: Any = None
    rules: Optional[MeshRules] = None

    def __post_init__(self):
        check_ported(self.run_cfg, self.mesh)
        if self.device is None and isinstance(self.mesh, Mesh):
            self.device = self.mesh.device
        self.device = resolve_device(self.device)
        strategy = self.run_cfg.dense_strategy
        if strategy == "auto" and self.mesh is not None:
            strategy = cost_model.pick_dense_strategy(
                self.model_cfg, self.shape_cfg, mesh_dims(self.mesh))
        elif strategy == "auto":
            strategy = "tp"
        self.resolved_strategy = strategy
        if self.rules is None:
            self.rules = MeshRules(self.mesh, default_rules(
                self.mesh, self.shape_cfg.kind,
                self.shape_cfg.global_batch, strategy))
        # per-step list the overlap=False step hands the lookups whose
        # push it runs after the backward (core/transform.py)
        self.deferred_pushes: Optional[list] = None

    # ---- dtypes ----
    @property
    def dtype(self) -> torch.dtype:
        return torch_dtype(self.run_cfg.compute_dtype)

    @property
    def param_dtype(self) -> torch.dtype:
        return torch_dtype(self.run_cfg.param_dtype)

    @property
    def wire_dtype(self) -> torch.dtype:
        # OPSW: cast to the cheap wire dtype before collectives; baseline f32
        return (torch_dtype(self.run_cfg.wire_dtype) if self.run_cfg.opsw
                else torch.float32)

    # ---- mesh helpers ----
    @property
    def batch_axes(self) -> tuple:
        if self.mesh is None:
            return ()
        return self.rules.rules.get("batch") or ()

    @property
    def model_shards(self) -> int:
        return max(self.rules.axis_size("vocab"),
                   self.rules.axis_size("mlp"))

    @property
    def vocab_shards(self) -> int:
        """Shards of the vocab dimension (the head's rows, the logits'
        columns) over the model axis: 1 off-mesh and under dp."""
        return self.rules.axis_size("vocab")

    @property
    def replicas(self) -> int:
        if self.mesh is None:
            return 1
        return self.mesh.axes_size(self.batch_axes)

    @property
    def bucketed(self) -> bool:
        return self.plan is not None and self.plan.bucket_plan is not None

    def pad_heads(self, h: int) -> int:
        """q heads padded to the model-axis shard count."""
        shards = self.rules.axis_size("q_heads")
        return ((h + shards - 1) // shards) * shards

    @property
    def padded_vocab(self) -> int:
        # the vocab rounded up to the model-axis shard count
        shards = max(self.model_shards, 1)
        v = self.model_cfg.vocab_size
        return ((v + shards - 1) // shards) * shards

    # ---- the sparse path (per table) ----
    def embed_ctx(self, name: str = "embed") -> EmbedCtx:
        method, wire = "dense", self.wire_dtype
        if self.plan is not None:
            method = self.plan.table_methods.get(name, self.plan.embed_method)
            wire = self.plan.table_wire.get(name, wire)
        elif self.mesh is not None:
            method = ("ps" if self.run_cfg.comm_mode in ("hybrid", "ps")
                      else "mpi_gatherv")
        # overlap=False: a gatherv table's push runs after the backward,
        # with the bucketed exchange (the reference's deferred_push)
        defer = (self.bucketed and method == "mpi_gatherv"
                 and not self.run_cfg.overlap)
        return EmbedCtx(
            method=method,
            vocab_padded=self.padded_vocab,
            wire_dtype=wire,
            local_agg=self.run_cfg.local_agg,
            exact=self.run_cfg.capacity_mode == "exact",
            census=self.shape_cfg.kind != "decode",
            mesh=self.mesh,
            batch_axes=tuple(self.batch_axes),
            model_axis=("model" if self.mesh is not None
                        and "model" in self.mesh.axis_names else ""),
            bucketed=self.bucketed,
            deferred=self.deferred_pushes if defer else None,
        )

    def embed_capacity_for(self, name: str = "embed") -> int:
        if self.plan is not None:
            cap = self.plan.table_capacity.get(name, self.plan.capacity)
            if cap:
                return cap
        # exact fallback: the local token count
        toks = self.shape_cfg.tokens // max(self.replicas, 1)
        if self.shape_cfg.kind == "decode":
            toks = max(self.shape_cfg.global_batch // max(self.replicas, 1),
                       1)
        return max(min(toks, self.padded_vocab), 8)
