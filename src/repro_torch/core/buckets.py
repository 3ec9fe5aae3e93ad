"""Bucketed dense-gradient exchange (the port of ``repro/core/buckets.py``):
Horovod-style tensor fusion over the replicas.

Each dense all-reduce costs a per-message latency (the α in α + β·b,
core/cost_model.py) however small its tensor, so the planner groups the
dense ``allreduce`` gradients into a few flat wire-dtype buffers of at most
``RunConfig.bucket_bytes`` each, keyed by (method, exchange dtype,
physical placement); each buffer rides ONE all-reduce, and the loss with
every scalar metric rides one more.

Buckets are assigned greedy first-fit over the *reversed* flatten order,
so bucket 0 holds the last-forward parameters, whose gradients the
backward produces first; the layouts match the reference's bucket for
bucket. With ``RunConfig.overlap`` (the default) each bucket's exchange
is issued from ``register_post_accumulate_grad_hook`` when its last
member gradient is ready, inside the rest of the backward (the reference
places it there with a ``custom_vjp`` tap): a ring bucket's all-reduce
without blocking, a two-level bucket's triple at once; with
``overlap=False`` every bucket is exchanged after the backward. The values
are the same either way: the exchange is an elementwise sum.

Applicability (``bucketable``): pure data-parallel meshes — every mesh
axis that is not a batch axis has size 1 and every dense parameter
exchanges by all-reduce. Elsewhere ``assign_buckets`` returns None and the
step exchanges tensor by tensor. Multi-host meshes with inter-tier
constants may give a bucket the two-level schedule (``_two_level_psum``).

Fused bucket-apply: where ``fused_apply_eligible`` holds, ``plan_buckets``
stamps ``Plan.fused_apply`` and the exchange hands back each bucket's
post-all-reduce flat buffer beside the per-leaf slices; the optimizer
(``optim/optimizer.py::update_fused``) applies straight from those
buffers against m/v/EMA laid out one flat buffer per bucket.

Magnitude census (``RunConfig.wire_dtype_auto``): each bucket's |g|inf and
rms over its flat f32 buffer before the wire cast (``gbucket{k}_gmax`` /
``_grms``), and each sparse table that keeps its own exchange its pushed
gradient's over the touched rows (``{table}_gmax`` / ``_grms``): this
replica's values, which the fused metrics all-reduce averages as it does
every scalar (no collective of their own). The replan loop reads them
(core/sparsity.py::wire_dtype_hints).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch

from repro_torch.core import collectives as coll
from repro_torch.core import cost_model
from repro_torch.core.plan import ParamPlan, Plan, entry_axes, plan_leaves
from repro_torch.utils.dtypes import dtype_name, torch_dtype


def _effective_pspec(pspec: tuple, mesh) -> tuple:
    """Placement with size-1 mesh axes dropped — the physical layout."""
    out = []
    for e in pspec:
        axes = tuple(a for a in entry_axes(e) if mesh.shape[a] > 1)
        out.append(axes[0] if len(axes) == 1 else (axes or None))
    return tuple(x for x in out if x is not None)


@dataclass(frozen=True)
class Bucket:
    key: tuple        # (method, wire dtype name, placement entries)
    idx: tuple        # leaf positions in flatten order, reverse-topological
    sizes: tuple      # element count per member
    nbytes: int       # fused buffer wire bytes
    schedule: str = "ring"     # ring | two_level (cost_model argmin)


@dataclass
class BucketPlan:
    buckets: list
    batch_axes: tuple      # the axes of the exchange
    replicas: int          # N: product of the batch axis sizes
    n_params: int          # bucketed gradient tensors
    wire_bytes: int        # sum of fused buffer bytes
    bucket_bytes: int      # the RunConfig knob that sized the buckets
    hw: Any = None         # the hardware record the planner priced against
    hosts: int = 1         # H: host groups among the replicas
    overlap: bool = True   # issue each bucket's all-reduce at readiness
    n_sparse_push: int = 0  # gatherv tables with their own row-buffer push

    @property
    def dims(self) -> cost_model.MeshDims:
        return cost_model.MeshDims(data=self.replicas, hosts=self.hosts)

    def stats(self, hw=None) -> dict:
        """Exchange accounting for runtime/monitor.py: the cost model's
        view of the dense push per step, each bucket priced at its
        schedule, beside one ring per member tensor unbucketed."""
        hw = hw or self.hw or cost_model.HW
        dims = self.dims
        ring = 2.0 * (self.replicas - 1) / max(self.replicas, 1)
        tier = cost_model.span_tier(dims, hw)
        est = 0.0
        for b in self.buckets:
            secs = cost_model.dense_schedule_seconds(b.nbytes, dims, hw)
            est += secs.get(b.schedule, secs["ring"])
        return {
            "n_buckets": len(self.buckets),
            "n_params_bucketed": self.n_params,
            "n_collectives_dense": len(self.buckets),
            "n_collectives_unbucketed": self.n_params,
            "n_two_level": sum(1 for b in self.buckets
                               if b.schedule == "two_level"),
            "hosts": self.hosts,
            "overlap": self.overlap,
            "n_overlapped_sparse": self.n_sparse_push if self.overlap else 0,
            "wire_bytes": self.wire_bytes,
            "bucket_bytes": self.bucket_bytes,
            "est_seconds": est,
            "est_seconds_unbucketed": cost_model.exchange_seconds(
                ring * self.wire_bytes, self.n_params, hw, tier=tier),
        }

    def expected_collectives(self, n_leaves: int = 0,
                             overlap: Optional[bool] = None) -> list:
        """The dense exchange's collective contract per bucket, as (kind,
        element count) pairs in issue order: a ring bucket is one
        all-reduce of ``sum(sizes)`` elements, a two-level bucket the
        reduce-scatter(E/L) -> all-reduce(E/L) -> all-gather(E) triple of
        ``_two_level_psum``, E padded to the L local replicas. The
        reference's signature; ``n_leaves`` and ``overlap`` change nothing
        here: the reference pins one element per gradient leaf onto every
        bucket when overlap is off, and the port has no pin (it orders its
        exchange itself), so the two modes differ only in when each
        collective is issued (ROADMAP Queue 3)."""
        out = []
        for k, b in enumerate(self.buckets):
            elems = sum(b.sizes)
            if b.schedule == "two_level":
                local = max(self.dims.local_replicas, 1)
                padded = elems + ((-elems) % local)
                colls = [("reduce-scatter", padded // local),
                         ("all-reduce", padded // local),
                         ("all-gather", padded)]
            else:
                colls = [("all-reduce", elems)]
            out.append({"bucket": k, "dtype": b.key[1],
                        "schedule": b.schedule, "collectives": colls})
        return out


def exchange_dtype(rt, p: Optional[ParamPlan] = None) -> torch.dtype:
    """The dtype a dense gradient rides the wire at (OPSW): f32 gradients
    drop to the parameter's planned wire dtype, others ship as they are."""
    d = rt.param_dtype
    if rt.run_cfg.opsw and d == torch.float32:
        return p.wire_dtype if p is not None else rt.wire_dtype
    return d


def bucketable(plan: Plan, rt) -> bool:
    """Can this plan's dense exchange run bucketed?"""
    if plan.mesh is None or rt.run_cfg.bucket_bytes <= 0:
        return False
    if rt.shape_cfg.kind != "train":
        return False
    ba = tuple(rt.batch_axes)
    if not ba or rt.replicas <= 1:
        return False
    for a in plan.mesh.axis_names:
        if a not in ba and plan.mesh.shape[a] != 1:
            return False
    if rt.model_cfg.n_experts > 0:
        return False
    for p in plan_leaves(plan):
        if not p.sparse and p.method != "allreduce":
            return False          # fsdp pull/push needs its own path
        if p.sparse and p.method not in ("allreduce", "mpi_gatherv", "dense"):
            return False
    return True


def assign_buckets(plan: Plan, rt) -> Optional[BucketPlan]:
    """Group the dense all-reduce parameters into fused buffers: greedy
    first-fit in reverse flatten order; a parameter joins the open bucket
    of its (method, exchange dtype, placement) group until the bucket
    reaches ``RunConfig.bucket_bytes``. Sparse tables whose argmin picked
    a sparse method keep their own exchange. A tied table on mpi_gatherv
    moves to the dense bucket (the reference's coherence rule)."""
    if not bucketable(plan, rt):
        return None
    if rt.model_cfg.tie_embeddings and plan.embed_method == "mpi_gatherv":
        for p in plan_leaves(plan):
            if p.sparse and p.method == "mpi_gatherv":
                p.method = "allreduce"
                plan.table_methods[p.name] = "allreduce"
        plan.embed_method = "allreduce"

    pitem = torch.empty((), dtype=rt.param_dtype).element_size()
    groups: dict = {}
    leaves = list(enumerate(plan_leaves(plan)))
    for i, p in reversed(leaves):
        if p.method != "allreduce":
            continue
        wdt = exchange_dtype(rt, p)
        itemsize = torch.empty((), dtype=wdt).element_size()
        cap = max(int(rt.run_cfg.bucket_bytes), itemsize)
        n = p.bytes // pitem
        key = (p.method, dtype_name(wdt),
               _effective_pspec(p.placement, plan.mesh))
        open_buckets = groups.setdefault(key, [[]])
        if open_buckets[-1] and \
                sum(s for _, s in open_buckets[-1]) * itemsize + \
                n * itemsize > cap:
            open_buckets.append([])
        open_buckets[-1].append((i, n))

    hw = cost_model.resolve_hw(rt.run_cfg)
    hosts = cost_model.mesh_hosts(plan.mesh)
    batch_axes = tuple(rt.batch_axes)
    dims = cost_model.MeshDims(data=rt.replicas, hosts=hosts)
    can_two_level = (hw.hierarchical and hosts > 1 and len(batch_axes) >= 2
                     and batch_axes[0] == "pod")
    buckets = []
    for key, bs in groups.items():
        itemsize = torch.empty((), dtype=torch_dtype(key[1])).element_size()
        for members in bs:
            if not members:
                continue
            idx = tuple(i for i, _ in members)
            sizes = tuple(s for _, s in members)
            nbytes = sum(sizes) * itemsize
            schedule = "ring"
            if can_two_level:
                schedule, _ = cost_model.choose_dense_schedule(
                    nbytes, dims, hw)
            buckets.append(Bucket(key=key, idx=idx, sizes=sizes,
                                  nbytes=nbytes, schedule=schedule))
    if not buckets:
        return None
    return BucketPlan(
        buckets=buckets, batch_axes=batch_axes,
        replicas=rt.replicas, n_params=sum(len(b.idx) for b in buckets),
        wire_bytes=sum(b.nbytes for b in buckets),
        bucket_bytes=int(rt.run_cfg.bucket_bytes),
        hw=hw, hosts=hosts, overlap=bool(rt.run_cfg.overlap),
        n_sparse_push=sum(1 for _, p in leaves
                          if p.sparse and p.method == "mpi_gatherv"))


def fused_apply_eligible(plan: Plan, rt) -> bool:
    """Can the optimizer apply bucket-natively (``update_fused``)? It
    needs the bucketed exchange (the flat post-all-reduce buffers exist),
    an optimizer with a fused path, optimizer state beside its parameter
    (zero_stage 0: a flat buffer has no per-leaf dimension to shard) and
    OPAU (the fused global norm is the partial-sum form)."""
    rc = rt.run_cfg
    return bool(plan.bucket_plan is not None and rc.fused_apply
                and rc.optimizer in ("adamw", "momentum")
                and rc.zero_stage == 0 and rc.opau)


def plan_buckets(plan: Plan, rt) -> None:
    """Planner hook: (re)compute the bucket assignment in place, after the
    memory escalation (an fsdp flip vetoes bucketing), and stamp the
    fused-apply eligibility: the optimizer-state layout is part of the
    plan."""
    plan.bucket_plan = assign_buckets(plan, rt)
    plan.fused_apply = fused_apply_eligible(plan, rt)


# ---------------------------------------------------------------------------
# the exchange
# ---------------------------------------------------------------------------

def _two_level_psum(buf: torch.Tensor, batch_axes: tuple, local: int,
                    mesh) -> torch.Tensor:
    """Two-level dense exchange of one flat buffer: intra-host
    reduce-scatter, inter-host all-reduce of the 1/L piece, intra-host
    all-gather. ``batch_axes[0]`` is the host tier ("pod"), the rest the L
    (= ``local``) intra-host replicas. Elementwise the one flat sum; only
    b/L bytes cross the slow tier."""
    inter, intra = batch_axes[0], tuple(batch_axes[1:])
    n = buf.shape[0]
    pad = (-n) % local
    if pad:
        buf = torch.cat([buf, buf.new_zeros((pad,))])
    piece = coll.reduce_scatter(buf, intra, mesh)
    piece = coll.all_reduce(piece, inter, mesh)
    out = coll.all_gather(piece, intra, mesh)
    return out[:n] if pad else out


def _flat32(grads: list, scale: float) -> torch.Tensor:
    """flatten -> x 1/N: one contiguous f32 buffer."""
    parts = [(g.float() * scale).reshape(-1) for g in grads]
    return torch.cat(parts) if len(parts) > 1 else parts[0]


def magnitude(buf32: torch.Tensor) -> tuple:
    """The magnitude census of one flat f32 buffer: (|g|inf, rms), taken
    on what rides the wire before the cast (``wire_dtype_auto``)."""
    return (torch.max(torch.abs(buf32)),
            torch.sqrt(torch.mean(torch.square(buf32))))


def row_magnitude(g32: torch.Tensor) -> tuple:
    """The magnitude census of a sparse table's exchanged gradient: |g|inf
    and the rms over the rows the push touched (zero rows excluded, so the
    rms is that of the pushed rows, not of the whole table)."""
    rows = torch.any(g32 != 0.0, dim=tuple(range(1, g32.dim())))
    width = g32.numel() // g32.shape[0]
    nnz = torch.clamp(rows.float().sum(), min=1.0)
    return (torch.max(torch.abs(g32)),
            torch.sqrt(torch.sum(torch.square(g32)) / (nnz * width)))


def _flat_wire(b: Bucket, grads: list, scale: float) -> torch.Tensor:
    """flatten -> x 1/N -> wire cast: one contiguous buffer."""
    return _flat32(grads, scale).to(torch_dtype(b.key[1]))


def _slice_back(b: Bucket, buf: torch.Tensor, like: list) -> list:
    out, off = [], 0
    for g, sz in zip(like, b.sizes):
        out.append(buf[off:off + sz].reshape(g.shape).to(g.dtype))
        off += sz
    return out


def _exchange_bucket(b: Bucket, grads: list, scale: float, bp: BucketPlan,
                     mesh, census: Optional[list] = None) -> tuple:
    """The fused exchange of ONE bucket: flatten -> x 1/N -> wire cast ->
    one all-reduce (ring or two-level) -> slice back to the members'
    shapes and dtypes. Returns (the members' gradients, the post-all-reduce
    flat wire buffer that the fused apply reads). ``census``: a list the
    bucket's ``magnitude`` pair is appended to (``wire_dtype_auto``)."""
    buf32 = _flat32(grads, scale)
    if census is not None:
        census.append(magnitude(buf32))
    wire = buf32.to(torch_dtype(b.key[1]))
    if b.schedule == "two_level":
        buf = _two_level_psum(wire, bp.batch_axes, bp.dims.local_replicas,
                              mesh)
    else:
        buf = coll.all_reduce(wire, bp.batch_axes, mesh)
    return _slice_back(b, buf, grads), buf


class OverlapExchange:
    """Issues each bucket's all-reduce from the gradient hooks of its
    members, when the last of them has accumulated (``overlap=True``).
    ``begin()`` arms it for one backward; ``finish()`` waits for every
    bucket and returns ({leaf index: exchanged gradient}, [each bucket's
    post-all-reduce flat buffer]). With ``census`` each bucket's
    ``magnitude`` pair is left in ``stats``, in bucket order. ``remove()``
    takes the hooks off the parameters (a replan builds a new exchange)."""

    def __init__(self, bp: BucketPlan, params: list, mesh,
                 census: bool = False):
        self.bp, self.mesh = bp, mesh
        self.params = params
        self.scale = 1.0 / bp.replicas
        self.census = census
        self.stats: list = []
        self.armed = False
        self._member = {}
        self._handles = []
        for k, b in enumerate(bp.buckets):
            for i in b.idx:
                self._member[i] = k
                self._handles.append(
                    params[i].register_post_accumulate_grad_hook(
                        self._hook(i)))

    def remove(self) -> None:
        for h in self._handles:
            h.remove()
        self._handles = []

    def _hook(self, i: int):
        def hook(p):
            if not self.armed:
                return
            k = self._member[i]
            self._ready[k].add(i)
            if len(self._ready[k]) == len(self.bp.buckets[k].idx):
                self._issue(k)
        return hook

    def _issue(self, k: int) -> None:
        """Issue bucket ``k``'s exchange: a ring bucket's all-reduce without
        blocking; a two-level bucket's triple, which blocks, at once."""
        b = self.bp.buckets[k]
        grads = [self.params[i].grad for i in b.idx]
        buf32 = _flat32(grads, self.scale)
        stats = magnitude(buf32) if self.census else None
        buf = buf32.to(torch_dtype(b.key[1]))
        if b.schedule == "two_level":
            buf, work = _two_level_psum(buf, self.bp.batch_axes,
                                        self.bp.dims.local_replicas,
                                        self.mesh), None
        else:
            work = coll.all_reduce_async(buf, self.bp.batch_axes, self.mesh)
        self._pending[k] = (buf, work, grads, stats)

    def begin(self) -> None:
        self._ready = [set() for _ in self.bp.buckets]
        self._pending = {}
        self.armed = True

    def finish(self) -> tuple:
        self.armed = False
        out, bufs, self.stats = {}, [], []
        for k, b in enumerate(self.bp.buckets):
            buf, work, grads, stats = self._pending.pop(k)
            if work is not None:
                work.wait()
            for i, g in zip(b.idx, _slice_back(b, buf, grads)):
                out[i] = g
            bufs.append(buf)
            if stats is not None:
                self.stats.append(stats)
        return out, bufs


def fused_metrics(loss: torch.Tensor, metrics: dict, axes: tuple, mesh,
                  replicas: int) -> tuple:
    """The loss and every scalar metric averaged over the replicas in ONE
    all-reduce (f32, sum / N). Returns (loss, metrics)."""
    if replicas <= 1:
        return loss, metrics
    keys = [k for k, v in metrics.items() if v.dim() == 0]
    vec = torch.stack([loss.float()] + [metrics[k].float() for k in keys])
    vec = coll.all_reduce(vec, axes, mesh) / replicas
    out = dict(metrics)
    for j, k in enumerate(keys):
        out[k] = vec[1 + j]
    return vec[0], out
