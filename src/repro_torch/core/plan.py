"""The per-parameter communication plan (the port of ``ParamPlan`` and
``Plan`` from ``repro/core/plan.py``).

Every parameter gets a ``ParamPlan`` naming its exchange method (allreduce
| fsdp | ps | ps_gather | mpi_gatherv, chosen by core/cost_model.py) and
the dtype its gradient rides (OPSW). Where the reference records a
``PartitionSpec``, the port records a ``placement``: ``None`` (the whole
tensor on the one device) until the distributed slice (ROADMAP slice 2)
places tensors over a mesh. The logical-axis rules, the bucket plan, ZeRO
stages and ``plan_diff`` come with slices 2 and 3.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

from repro_torch.configs.base import ModelConfig, RunConfig, ShapeConfig
from repro_torch.utils.dtypes import dtype_name


@dataclass
class ParamPlan:
    name: str
    method: str                        # allreduce | fsdp | ps | mpi_gatherv
    placement: Any                     # None: whole tensor on one device
    wire_dtype: Any                    # torch dtype (OPSW)
    sparse: bool
    bytes: int
    capacity: int = 0                  # sparse tables: dedupe-buffer rows
    stale: bool = False                # bounded-staleness push (slice 7)
    est_cost: dict = field(default_factory=dict)


@dataclass
class Plan:
    model_cfg: ModelConfig
    run_cfg: RunConfig
    shape_cfg: ShapeConfig
    params: dict = field(default_factory=dict)   # name -> ParamPlan, in
                                                 # flatten order
    alpha: float = 1.0                 # estimated sparse-access ratio
    capacity: int = 0                  # binding sparse-exchange row capacity
    embed_method: str = "ps"           # the "embed" table's exchange method
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
