"""The per-parameter communication plan and the logical-axis → mesh
resolution (the port of ``repro/core/plan.py``).

Every parameter gets a ``ParamPlan`` naming its exchange method (allreduce
| fsdp | ps | ps_gather | mpi_gatherv, chosen by core/cost_model.py), the
dtype its gradient rides (OPSW) and its placement. A placement is the
reference's ``PartitionSpec`` as a tuple: one entry per dimension, each
``None``, an axis name or a tuple of axis names (``()`` on one device).

``held`` is the placement the port executes. For a training plan it is
the placement itself on every leaf of every family: each block that the
rules shard over ``model`` runs tensor-parallel on its held block (the
attention, the SwiGLU MLP, the LSTM, the selective SSM, the RWKV time and
channel mixes, the routed experts' d_ff under ``tp``, the shared expert;
every block keys on the held shape of its leaf, never on the mesh's), the
vocab-sharded tables and head, the experts under ``ep``. A server keeps
its weights whole over the batch axes (``model_part``: a placement from
the memory escalation prices optimizer bytes a server never holds).

``groups`` says how a rank's model-axis block is laid out: per dimension,
the number of equal groups it takes its share of each of. It is 1 (a
contiguous block) except on the 4H dimension of the LSTM's ``w_x``,
``w_h`` and ``bias`` (``gate_groups``): there a rank holds its H/M units
of each of the four gates i, f, g, o (4H/M columns), so the cell's
elementwise step finds every gate of its units on its own rank and
``w_proj``'s contiguous rows are the same units. The bytes are the plan's;
the leaf whole (on disk, in a gathered state) keeps the reference's
layout (``weights.py`` cuts and gathers it; ROADMAP Queue 3).

``opt_held`` is its counterpart for the optimizer state (AdamW's moments,
momentum's buffer): ``opt_placement`` read the same way. Under ZeRO-1
(``RunConfig.zero_stage >= 1``, or the memory escalation's stage 1) it
shards one more dimension over the FSDP axes than ``held`` does, and the
optimizer updates this rank's block of the parameter and all-gathers it
(optim/optimizer.py). A leaf that a fused plan applies from its bucket's
flat buffer keeps its moments whole (``opt_held == held``), as the
reference's ``state_shardings`` keeps the bucket buffers replicated.

``plan_diff`` is the replan loop's test of whether a plan recomputed from
an observed census differs enough from the live one to rebuild the step.
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
    opt_held: tuple = ()               # ... and the optimizer state's
    groups: tuple = ()                 # per dim: the groups a model-axis
                                       # block takes its share of (the
                                       # LSTM's gates: 4), else 1


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
    fused_apply: bool = False          # the optimizer applies straight from
                                       # the flat bucket buffers (fused
                                       # m/v/EMA layout; optim/optimizer.py)
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

    def exchange_contract(self) -> dict:
        """What ``analysis/contract.py`` needs to derive a step's expected
        collectives from this plan alone, key for key the reference's: the
        per-bucket dense collectives (kind and element count, in issue
        order), the overlap mode, and each sparse table's method, capacity,
        wire dtype and staleness."""
        bp = self.bucket_plan
        n_leaves = len(self.params)
        return {
            "n_leaves": n_leaves,
            "methods": self.methods(),
            "bucketed": bp is not None,
            "overlap": bool(bp.overlap) if bp is not None else False,
            "replicas": bp.replicas if bp is not None else 1,
            "buckets": (bp.expected_collectives(n_leaves)
                        if bp is not None else []),
            "n_sparse_push": bp.n_sparse_push if bp is not None else 0,
            "tables": {t: {
                "method": m,
                "capacity": self.table_capacity.get(t, self.capacity),
                "wire_dtype": dtype_name(self.table_wire[t])
                if t in self.table_wire else None,
                "stale": t in self.stale_tables,
            } for t, m in self.table_methods.items()},
        }


def _drifted(old_cap: int, new_cap: int, factor: float) -> bool:
    hi = max(old_cap, new_cap)
    lo = max(min(old_cap, new_cap), 1)
    return old_cap != new_cap and hi / lo >= factor


def plan_diff(old: Plan, new: Plan, capacity_drift: float = 1.5) -> dict:
    """Structural diff between two Plans for the replan loop, key for key
    the reference's ``plan_diff``.

    ``changed`` is True when any parameter's exchange method flips, any
    placement or optimizer placement differs (state must move), any wire
    dtype moves (the step must be rebuilt), any table's capacity drifts by
    ``capacity_drift``x or more in either direction, the overflow rule grew
    a table (never deadbanded: rows are being dropped under the live plan),
    or the plans price different mesh shapes. Dtypes render as the
    reference's names (``"bfloat16"``). ``stale_flips`` stays empty until
    the bounded-staleness fallback is ported (ROADMAP slice 7)."""
    olds = dict(old.params)
    flips, wire_flips, pspecs_changed = [], [], False
    for p in new.params.values():
        q = olds.get(p.name)
        if q is None:
            pspecs_changed = True
            continue
        if p.method != q.method:
            flips.append((p.name, q.method, p.method))
        if dtype_name(p.wire_dtype) != dtype_name(q.wire_dtype):
            wire_flips.append((p.name, dtype_name(q.wire_dtype),
                               dtype_name(p.wire_dtype)))
        if tuple(p.placement) != tuple(q.placement) or \
                tuple(p.opt_placement) != tuple(q.opt_placement):
            pspecs_changed = True
    capacity_drifted = _drifted(old.capacity, new.capacity, capacity_drift)
    for t, cap in new.table_capacity.items():
        if t in old.table_capacity:
            capacity_drifted |= _drifted(old.table_capacity[t], cap,
                                         capacity_drift)
    capacity_grown = any(
        new.table_capacity.get(t, 0) > old.table_capacity.get(t, 0)
        for t in new.grown_tables)
    mesh_shape = lambda p: dict(p.mesh.shape) if p.mesh is not None else None
    mesh_changed = mesh_shape(old) != mesh_shape(new)
    stale_flips = [
        (t, t in old.stale_tables, t in new.stale_tables)
        for t in sorted(set(old.stale_tables) ^ set(new.stale_tables))]
    return {
        "changed": bool(flips) or bool(wire_flips) or pspecs_changed
                   or capacity_drifted or capacity_grown or mesh_changed
                   or bool(stale_flips),
        "mesh_changed": mesh_changed,
        "mesh": (mesh_shape(old), mesh_shape(new)),
        "rebuilt": False,             # set by the caller that acts on it
        "flips": flips,
        "wire_flips": wire_flips,
        "stale_flips": stale_flips,
        "pspecs_changed": pspecs_changed,
        "capacity_drifted": capacity_drifted,
        "capacity_grown": capacity_grown,
        "capacity": (old.capacity, new.capacity),
        "table_capacity": (dict(old.table_capacity),
                           dict(new.table_capacity)),
        "table_methods": (dict(old.table_methods), dict(new.table_methods)),
        "alpha": (old.alpha, new.alpha),
        "embed_method": (old.embed_method, new.embed_method),
        "buckets": (len(old.bucket_plan.buckets) if old.bucket_plan else 0,
                    len(new.bucket_plan.buckets) if new.bucket_plan else 0),
    }


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


# the LSTM leaves whose lstm_hidden dimension is the four gates' 4H
GATE_LEAVES = ("w_x", "w_h", "bias")
N_GATES = 4


def gate_groups(name: str, logical: tuple, held: tuple,
                model_axis: str = "model") -> tuple:
    """``ParamPlan.groups`` of a leaf: ``N_GATES`` on the ``lstm_hidden``
    dimension of an LSTM gate leaf held over the model axis alone (the
    tensor-parallel cell's gate-strided block), 1 everywhere else (a
    ZeRO-3 or dp block over the batch axes is contiguous: the leaf is
    gathered whole before use)."""
    gates = name.split(".")[-1] in GATE_LEAVES
    return tuple(N_GATES if gates and axis == "lstm_hidden"
                 and entry_axes(e) == (model_axis,) else 1
                 for e, axis in zip(held, logical))


def model_part(placement: tuple, model_axis: str = "model") -> tuple:
    """``placement`` with every axis but the model axis dropped: a
    server's weights, whole over the batch axes."""
    return tuple(model_axis if model_axis in entry_axes(e) else None
                 for e in placement)


def per_device_bytes(specs: list, rules: MeshRules, plans: list,
                     dtype_bytes: int = 2, opt_bytes: int = 8,
                     held: bool = False) -> float:
    """Rough params+optimizer per-chip bytes under the plan (for the
    memory escalation). ``specs``: [(name, ParamSpec)]; ``plans``: the
    ParamPlans in the same order. ``held``: count by the placements the
    port executes (``held`` / ``opt_held``, set once the plan is built):
    the bytes a rank really holds, where the escalation reads the planned
    ones, as the reference does."""
    total = 0.0
    for (_, spec), plan in zip(specs, plans):
        n = math.prod(spec.shape)
        pl, opt = ((plan.held, plan.opt_held) if held
                   else (plan.placement, plan.opt_placement))
        shards = _pspec_shards(pl, rules.mesh)
        opt_shards = _pspec_shards(opt, rules.mesh)
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
