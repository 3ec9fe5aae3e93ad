"""Table 3 of the paper, generalized and latency-aware — the port of
``repro/core/cost_model.py`` (training-step and serve-pull pricing).

Per-chip wire bytes per training step for one parameter of ``b`` bytes:

  dense:
    allreduce (MPI/ring):  2 (N-1)/N · b
    fsdp  (PS-for-dense):  2 (N-1)/N · b
  sparse (α = touched fraction per replica-step):
    ps (row-sharded):      pull 2α b (M-1)/M  +  push 2 b_shard (D-1)/D
    ps_gather push:        pull 2α b (M-1)/M  +  push D α b
    mpi_gatherv:           2 (N-1) α b

N = total replicas (data·pod), M = model-axis size, D = data(+pod) size.
The argmin runs over seconds, ``messages · α + bytes / β`` at the link
tier the collective spans (utils/roofline.py holds the card's constants).
On one device every count is zero: the plan is the same whatever the
hardware record says.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass, replace
from typing import Optional

from repro_torch.utils.roofline import HW, Hardware

# Hardware fields a fitted hw_profile JSON may override; others are ignored.
_PROFILE_FIELDS = ("name", "link_bw", "link_latency", "inter_bw",
                   "inter_latency")


def load_hw_profile(path: str, hw: Optional[Hardware] = None) -> Hardware:
    """Overlay a fitted α/β profile (a flat JSON object) onto the record."""
    hw = hw or HW
    with open(path) as f:
        prof = json.load(f)
    fields = {k: (str(v) if k == "name" else float(v))
              for k, v in prof.items()
              if k in _PROFILE_FIELDS and v is not None}
    return replace(hw, **fields)


def resolve_hw(run_cfg=None, hw: Optional[Hardware] = None) -> Hardware:
    """The record the planner prices against: ``hw`` (default: the H100),
    overlaid with RunConfig.hw_profile when set, then RunConfig.link_latency
    overriding the intra α term."""
    hw = hw or HW
    prof = getattr(run_cfg, "hw_profile", None) if run_cfg is not None else None
    if prof:
        hw = load_hw_profile(os.fspath(prof), hw)
    ll = getattr(run_cfg, "link_latency", None) if run_cfg is not None else None
    if ll is not None:
        hw = replace(hw, link_latency=float(ll))
    return hw


@dataclass(frozen=True)
class MeshDims:
    model: int = 1
    data: int = 1
    pod: int = 1
    hosts: int = 1                      # H: host groups among the replicas

    @property
    def replicas(self) -> int:          # N in the paper
        return self.data * self.pod

    @property
    def chips(self) -> int:
        return self.model * self.data * self.pod

    @property
    def local_replicas(self) -> int:
        """L: replicas per host; 1 when hosts do not divide them."""
        h = max(self.hosts, 1)
        n = self.replicas
        return n // h if h > 1 and n % h == 0 else (n if h <= 1 else 1)


def dense_allreduce_bytes(b: float, dims: MeshDims) -> float:
    n = dims.replicas
    if n <= 1:
        return 0.0
    return 2.0 * (n - 1) / n * b


def dense_fsdp_bytes(b: float, dims: MeshDims) -> float:
    n = dims.replicas
    if n <= 1:
        return 0.0
    return 2.0 * (n - 1) / n * b


def sparse_ps_bytes(b: float, alpha: float, dims: MeshDims) -> float:
    m, d = dims.model, dims.replicas
    pull = 2.0 * alpha * b * (m - 1) / m if m > 1 else 0.0
    push = 2.0 * (b / max(m, 1)) * (d - 1) / d if d > 1 else 0.0
    return pull + push


def sparse_ps_gather_bytes(b: float, alpha: float, dims: MeshDims) -> float:
    m, d = dims.model, dims.replicas
    pull = 2.0 * alpha * b * (m - 1) / m if m > 1 else 0.0
    push = d * alpha * b if d > 1 else 0.0
    return pull + push


def sparse_mpi_bytes(b: float, alpha: float, dims: MeshDims) -> float:
    n = dims.replicas
    if n <= 1:
        return 0.0
    return 2.0 * (n - 1) * alpha * b


def method_bytes(b: float, alpha: float, dims: MeshDims) -> dict:
    return {
        "allreduce": dense_allreduce_bytes(b, dims),
        "fsdp": dense_fsdp_bytes(b, dims),
        "ps": sparse_ps_bytes(b, alpha, dims),
        "ps_gather": sparse_ps_gather_bytes(b, alpha, dims),
        "mpi_gatherv": sparse_mpi_bytes(b, alpha, dims),
    }


def method_messages(method: str, dims: MeshDims) -> int:
    """Collective launches per step for one parameter under ``method``."""
    m, d = dims.model, dims.replicas
    if method == "allreduce":
        return 1 if d > 1 else 0
    if method == "fsdp":
        return 2 if d > 1 else 0                    # all-gather + reduce-scatter
    if method == "ps":                              # pull psum + push shard psum
        return (1 if m > 1 else 0) + (1 if d > 1 else 0)
    if method == "ps_gather":                       # pull psum + (ids, rows) AG
        return (1 if m > 1 else 0) + (2 if d > 1 else 0)
    if method == "mpi_gatherv":                     # (ids, rows) all-gather
        return 2 if d > 1 else 0
    raise ValueError(f"unknown method {method!r}")


def _tier_constants(hw: Hardware, tier: str) -> tuple[float, float]:
    """(α, β) for a link tier; the inter tier exists only when both inter
    constants are set."""
    if tier == "inter" and hw.hierarchical:
        return hw.inter_latency, hw.inter_bw
    return hw.link_latency, hw.link_bw


def span_tier(dims: MeshDims, hw: Hardware = HW) -> str:
    """The tier a replica-spanning collective runs at."""
    return "inter" if dims.hosts > 1 and hw.hierarchical else "intra"


def exchange_seconds(wire_bytes: float, messages: float,
                     hw: Hardware = HW, tier: str = "intra") -> float:
    """The α + β·b transfer model at the given link tier."""
    alpha, beta = _tier_constants(hw, tier)
    return messages * alpha + wire_bytes / beta


def dense_schedule_seconds(b: float, dims: MeshDims,
                           hw: Hardware = HW) -> dict:
    """Schedule candidates for ONE dense all-reduce of ``b`` bytes: the flat
    ring and, on multi-host meshes with inter constants, the two-level
    reduce-scatter -> inter all-reduce -> all-gather schedule."""
    n = dims.replicas
    out = {"ring": exchange_seconds(dense_allreduce_bytes(b, dims),
                                    1 if n > 1 else 0, hw,
                                    tier=span_tier(dims, hw))}
    h, loc = dims.hosts, dims.local_replicas
    if hw.hierarchical and h > 1 and loc > 1:
        intra_bytes = 2.0 * (loc - 1) / loc * b
        inter_bytes = 2.0 * (h - 1) / h * (b / loc)
        out["two_level"] = (2.0 * hw.link_latency + hw.inter_latency
                            + intra_bytes / hw.link_bw
                            + inter_bytes / hw.inter_bw)
    return out


def method_seconds(*, b: float, alpha: float, dims: MeshDims,
                   hw: Hardware = HW) -> dict:
    """Per-method step seconds for one parameter (the planner's argmin)."""
    bts = method_bytes(b, alpha, dims)
    tier = span_tier(dims, hw)
    secs = {k: exchange_seconds(v, method_messages(k, dims), hw, tier=tier)
            for k, v in bts.items()}
    if tier == "inter":
        secs["allreduce"] = min(
            dense_schedule_seconds(b, dims, hw).values())
    return secs


def choose_method(*, b: float, sparse: bool, alpha: float, dims: MeshDims,
                  comm_mode: str = "hybrid", can_shard_rows: bool = True,
                  hw: Optional[Hardware] = None) -> tuple[str, dict]:
    """Pick the exchange method for one parameter; returns (method, costs)
    with ``costs`` the per-chip wire bytes and the argmin over seconds.

    can_shard_rows: False when no mesh axis can row-shard the table — the
    PS family is then infeasible.
    """
    hw = hw or HW
    costs = method_bytes(b, alpha, dims)
    secs = method_seconds(b=b, alpha=alpha, dims=dims, hw=hw)
    if not sparse:
        if comm_mode == "ps":
            return "fsdp", costs
        return "allreduce", costs
    if comm_mode == "mpi":
        return "mpi_gatherv", costs
    if comm_mode in ("ps", "hybrid"):
        cands = ["mpi_gatherv", "allreduce"] if comm_mode == "hybrid" else []
        if can_shard_rows:
            cands += ["ps", "ps_gather"]
        if not cands:
            cands = ["mpi_gatherv"]
        best = min(cands, key=lambda k: secs[k])
        return best, costs
    raise ValueError(f"unknown comm_mode {comm_mode!r}")


def serve_pull_bytes(b: float, alpha: float, method: str,
                     dims: MeshDims) -> float:
    """Per-decode-step wire bytes for one sparse table's serve-time pull.

    Inference has no push leg: a row-sharded table (ps / ps_gather) pays the
    deduped row-buffer all-reduce over the model axis every decode step
    (2αb of the step's activated fraction, α from a decode-shape census); a
    replicated table (allreduce / mpi_gatherv / dense) gathers locally and
    moves nothing."""
    m = dims.model
    if method in ("ps", "ps_gather") and m > 1:
        return 2.0 * alpha * b * (m - 1) / m
    return 0.0


def serve_pull_messages(method: str, dims: MeshDims) -> int:
    return 1 if method in ("ps", "ps_gather") and dims.model > 1 else 0


def serve_pull_seconds(*, b: float, alpha: float, method: str,
                       dims: MeshDims, hw: Optional[Hardware] = None) -> float:
    """α + β·b seconds one decode step spends pulling this table."""
    hw = hw or HW
    return exchange_seconds(serve_pull_bytes(b, alpha, method, dims),
                            serve_pull_messages(method, dims), hw,
                            tier=span_tier(dims, hw))


def serve_table_pricing(*, b: float, alpha: float, method: str,
                        dims: MeshDims, batch_tokens: int,
                        hw: Optional[Hardware] = None) -> dict:
    """Serve pricing for one table at decode batch shapes: the wire bytes
    and seconds one decode step pays for the pull, and the per-token
    exchange seconds at this batch (one token per sequence per step).
    Stamped into ``Plan.table_serve`` when the planner runs at a decode
    ShapeConfig and surfaced via ``Plan.tables()``."""
    hw = hw or HW
    pull_b = serve_pull_bytes(b, alpha, method, dims)
    pull_s = serve_pull_seconds(b=b, alpha=alpha, method=method, dims=dims,
                                hw=hw)
    return {"pull_bytes": pull_b, "pull_s": pull_s,
            "s_per_token": pull_s / max(int(batch_tokens), 1)}
