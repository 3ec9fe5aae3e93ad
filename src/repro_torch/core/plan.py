"""The per-parameter communication plan and the logical-axis → mesh
resolution (the port of ``repro/core/plan.py``).

Every parameter gets a ``ParamPlan`` naming its exchange method (allreduce
| fsdp | ps | ps_gather | mpi_gatherv, chosen by core/cost_model.py), the
dtype its gradient rides (OPSW) and its placement. A placement is the
reference's ``PartitionSpec`` as a tuple: one entry per dimension, each
``None``, an axis name or a tuple of axis names (``()`` on one device).

``held`` is the placement the port executes. The reference runs the dense
model in global semantics, so its LSTM weights are tensor-parallel over
``model`` (``lstm_hidden``); the port runs every rank's LSTM whole and
keeps a parameter sharded over ``model`` only on its vocab dimension (the
PS tables and the head). ``held`` is ``placement`` with the model axis
dropped elsewhere; the data-axis (FSDP) entries stay. The values are the
same either way (ROADMAP Queue 3). ``plan_diff`` comes with slice 3; the
step refuses optimizer state sharded apart from its parameter (ZeRO-1),
which the plan records but the port does not execute yet.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Optional

from repro_torch.configs.base import ModelConfig, RunConfig, ShapeConfig
from repro_torch.utils.dtypes import dtype_name


# ---------------------------------------------------------------------------
# logical axis rules
# ---------------------------------------------------------------------------

def default_rules(mesh, shape_kind: str, batch: int,
                  dense_strategy: str = "tp") -> dict:
    """logical axis name -> mesh axes (tuple) or None."""
    if mesh is None:
        return {}
    names = mesh.axis_names
    has_pod = "pod" in names
    if dense_strategy == "dp" and shape_kind != "decode":
        # the model axis joins data parallelism; params fully sharded
        batch_axes = ("pod", "data", "model") if has_pod else ("data", "model")
        ba = list(batch_axes)
        while ba and batch % math.prod(mesh.shape[a] for a in ba) != 0:
            ba.pop(0)
        rules = {k: None for k in (
            "seq_sp", "vocab", "embed", "q_heads", "kv_heads", "heads_hd",
            "mlp", "experts", "moe_mlp", "layers", "state", "lstm_hidden",
            "conv")}
        rules["batch"] = tuple(ba) if ba else None
        rules["kv_seq"] = ("model",)
        return rules
    batch_axes = ("pod", "data") if has_pod else ("data",)
    # batch must divide the data(+pod) axes; drop axes until it does
    ba = list(batch_axes)
    while ba and batch % math.prod(mesh.shape[a] for a in ba) != 0:
        ba.pop(0)
    rules = {
        "batch": tuple(ba) if ba else None,
        "seq_sp": ("model",),
        "vocab": ("model",),           # PS server shards (row-sharded)
        "embed": None,
        "q_heads": ("model",),
        "kv_heads": None,
        "heads_hd": ("model",),
        "mlp": ("model",),
        "experts": ("model",),
        "moe_mlp": None,
        "kv_seq": ("model",),
        "layers": None,
        "state": None,
        "lstm_hidden": ("model",),
        "conv": None,
    }
    if shape_kind == "decode" and (not ba):
        rules["kv_seq"] = tuple(a for a in ("pod", "data", "model")
                                if a in names)
    return rules


@dataclass
class MeshRules:
    mesh: Any                           # launch/mesh.py MeshShape, or None
    rules: dict

    def axis_size(self, logical: str) -> int:
        if self.mesh is None:
            return 1
        ax = self.rules.get(logical)
        if ax is None:
            return 1
        return math.prod(self.mesh.shape[a] for a in ax)

    def pspec(self, axes: tuple, shape: Optional[tuple] = None) -> tuple:
        """Logical axes -> a placement tuple, with divisibility checks."""
        if self.mesh is None:
            return ()
        used: set = set()
        out = []
        for i, name in enumerate(axes):
            entry = None
            if name is not None:
                cand = self.rules.get(name)
                if cand:
                    cand = tuple(a for a in cand if a not in used)
                    if cand:
                        size = math.prod(self.mesh.shape[a] for a in cand)
                        if shape is None or shape[i] % size == 0:
                            entry = cand[0] if len(cand) == 1 else cand
                            used.update(cand)
            out.append(entry)
        return tuple(out)


def entry_axes(entry) -> tuple:
    """The mesh axes of one placement entry."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


# ---------------------------------------------------------------------------
# per-parameter plan
# ---------------------------------------------------------------------------

@dataclass
class ParamPlan:
    name: str
    method: str                        # allreduce | fsdp | ps | mpi_gatherv
    placement: tuple                   # the reference's pspec, as a tuple
    opt_placement: tuple               # optimizer state (ZeRO-1/3)
    wire_dtype: Any                    # torch dtype (OPSW)
    sparse: bool
    bytes: int
    capacity: int = 0                  # sparse tables: dedupe-buffer rows
    stale: bool = False                # bounded-staleness push (slice 7)
    est_cost: dict = field(default_factory=dict)
    held: tuple = ()                   # the placement the port executes


@dataclass
class Plan:
    model_cfg: ModelConfig
    run_cfg: RunConfig
    shape_cfg: ShapeConfig
    mesh: Any = None
    rules: Optional[MeshRules] = None
    params: dict = field(default_factory=dict)   # name -> ParamPlan, in
                                                 # flatten order
    alpha: float = 1.0                 # estimated sparse-access ratio
    capacity: int = 0                  # binding sparse-exchange row capacity
    zero_stage: int = 0
    embed_method: str = "ps"           # the "embed" table's exchange method
    bucket_plan: Any = None            # core/buckets.py BucketPlan (None =
                                       # per-tensor dense collectives)
    # ---- per-parameter planning (one record per sparse table) ----
    table_methods: dict = field(default_factory=dict)   # name -> method
    table_capacity: dict = field(default_factory=dict)  # name -> buffer rows
    table_wire: dict = field(default_factory=dict)      # name -> torch dtype
    table_alpha: dict = field(default_factory=dict)     # name -> priced α
    grown_tables: tuple = ()
    stale_tables: tuple = ()
    table_serve: dict = field(default_factory=dict)

    def census(self) -> dict:
        dense = sparse = 0
        for p in self.params.values():
            if p.sparse:
                sparse += p.bytes
            else:
                dense += p.bytes
        return {"dense_bytes": dense, "sparse_bytes": sparse,
                "alpha": self.alpha}

    def methods(self) -> dict:
        out: dict[str, int] = {}
        for p in self.params.values():
            out[p.method] = out.get(p.method, 0) + 1
        return out

    def tables(self) -> dict:
        """Per-sparse-table plan summary (JSON-friendly), key for key the
        reference's ``Plan.tables()``."""
        return {t: {
            "method": m,
            "capacity": self.table_capacity.get(t, self.capacity),
            "wire_dtype": dtype_name(self.table_wire[t])
            if t in self.table_wire else None,
            "grown": t in self.grown_tables,
            "alpha": self.table_alpha.get(t),
            "stale": t in self.stale_tables,
            "serve": self.table_serve.get(t),
        } for t, m in self.table_methods.items()}


def plan_leaves(plan: Plan) -> list:
    """ParamPlans in flatten order (the order gradient leaves share)."""
    return list(plan.params.values())


def _fsdp_axes(mesh, dense_strategy: str = "tp") -> tuple:
    axes = ("data", "model") if dense_strategy == "dp" else ("data",)
    return tuple(a for a in axes if a in mesh.axis_names)


def add_fsdp(pspec: tuple, shape: tuple, mesh,
             dense_strategy: str = "tp") -> tuple:
    """ZeRO-3: additionally shard the largest free dim over the data axis."""
    fax = _fsdp_axes(mesh, dense_strategy)
    if not fax:
        return pspec
    size = math.prod(mesh.shape[a] for a in fax)
    entries = list(pspec) + [None] * (len(shape) - len(pspec))
    used = {a for e in entries for a in entry_axes(e)}
    if any(a in used for a in fax):
        return pspec
    # pick the largest unsharded, divisible dim
    best, best_dim = None, -1
    for i, (e, d) in enumerate(zip(entries, shape)):
        if e is None and d % size == 0 and d > best_dim:
            best, best_dim = i, d
    if best is None:
        return pspec
    entries[best] = fax if len(fax) > 1 else fax[0]
    return tuple(entries)


def held_placement(placement: tuple, logical: tuple, batch_axes: tuple,
                   model_axis: str = "model") -> tuple:
    """The placement the port executes: ``placement`` with the model axis
    kept only on a ``vocab`` dimension (batch-axis entries always kept)."""
    out = []
    for e, name in zip(placement, logical):
        keep = tuple(a for a in entry_axes(e)
                     if a in batch_axes or (a == model_axis
                                            and name == "vocab"))
        out.append(keep[0] if len(keep) == 1 else (keep or None))
    return tuple(out)


def per_device_bytes(specs: list, rules: MeshRules, plans: list,
                     dtype_bytes: int = 2, opt_bytes: int = 8) -> float:
    """Rough params+optimizer per-chip bytes under the plan (for the
    memory escalation). ``specs``: [(name, ParamSpec)]; ``plans``: the
    ParamPlans in the same order."""
    total = 0.0
    for (_, spec), plan in zip(specs, plans):
        n = math.prod(spec.shape)
        shards = _pspec_shards(plan.placement, rules.mesh)
        opt_shards = _pspec_shards(plan.opt_placement, rules.mesh)
        total += n * dtype_bytes / shards + n * opt_bytes / opt_shards
    return total


def _pspec_shards(pspec: tuple, mesh) -> int:
    if mesh is None:
        return 1
    s = 1
    for e in pspec:
        for a in entry_axes(e):
            s *= mesh.shape[a]
    return s
