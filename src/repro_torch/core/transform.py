"""The Parallax API (the port of ``repro/core/transform.py``).

``estimate_census``  workload-model census (uniform/Zipf analytic α).
``choose_methods``   census -> Plan via the Table-3 cost model, with the
                     placements on a mesh, the memory escalation and the
                     bucket plan.
``analyze``          the composition of the two.
``make_train_step``  (state, batch) -> (state, metrics): loss, backward
                     through the PS pull/push, the exchange of every
                     gradient by its planned method (the OPSW wire cast
                     included), the optimizer (clipping after aggregation).
``build_step``       model + optimizer + plan -> (step, state).
``make_serve_prefill_step`` / ``make_serve_decode_step``
                     the serving engine's batched prefill and slot-paged
                     decode (runtime/server.py).
``get_runner``       the user-facing two-line API (paper Table 2):

    runner = get_runner(get_config("parallax-lm"), shape, RunConfig())
    metrics = runner.run(ds.batch(i))

Everything runs on ``device`` (default: the card, or the mesh's). On a
mesh (``launch/mesh.py::make_mesh``) every rank runs this step on its own
shards: ``Runner.run`` takes the global batch and feeds this replica its
contiguous rows, as ``P(batch_axes)`` shards them; each rank holds only
its shards of the parameters (``ParamPlan.held``: the model is built on the
meta device and ``place_params_`` allocates each shard, which the seeded
draw or the given weights fill), the attention and MLP blocks running
tensor-parallel over ``model``; an ``fsdp`` parameter
is all-gathered over its data axes before the forward and its gradient
reduce-scattered after the backward; the dense gradients are averaged over
the replicas at their wire dtype, in buckets where the plan has them; the
loss and every scalar metric ride one all-reduce. Under ZeRO-1 each rank
holds its block of a leaf's optimizer state (``ParamPlan.opt_held``) and
the optimizer all-gathers the parameter it writes; under the ``dp`` dense
strategy the model axis is a batch axis (no tensor parallelism, FSDP over
both axes). The correctness contract (paper §3.1): the step computes what
the single-device step computes at equal global batch.

Under ``RunConfig.max_staleness > 0`` the state carries a staleness
buffer for each table with its own sparse exchange
(``ensure_stale_buffers``), and the step rewrites those tables' gradients
between the exchange and the optimizer (``_make_staleness_rule``): a table
of ``Plan.stale_tables`` applies the previous step's aggregate. Under
``RunConfig.heartbeat`` a mesh step carries each replica's beat in the
one metrics all-reduce (runtime/trainer.py reads them).

``apply_replan`` / ``Runner.replan(census)`` hot-swap the step onto a plan
recomputed from a measured census (paper §5's profile -> re-optimize loop;
runtime/trainer.py drives it): the state stays where it is when the
placements hold, and travels whole between the two plans' placements
(``weights.gather_state`` / ``shard_state``) when they moved (the
optimizer state's too); a fused
optimizer layout is unfused with the old plan's buckets into copies and
re-fused with the new plan's.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Any, Callable, Optional

import torch
from torch import nn

from repro_torch.analysis.contract import (check_contract,
                                           verify_step_contract)
from repro_torch.configs.base import ModelConfig, RunConfig, ShapeConfig
from repro_torch.core import buckets, cost_model, sparsity
from repro_torch.core import collectives as coll
from repro_torch.core import embedding
from repro_torch.core.plan import (ParamPlan, Plan, add_fsdp, entry_axes,
                                   gate_groups, per_device_bytes, plan_diff)
from repro_torch.core.runtime import Runtime, check_ported, mesh_dims
from repro_torch.launch.mesh import DryMesh, Mesh, MeshShape
from repro_torch.models.layers import flatten_specs, init_std
from repro_torch.models.model import build_model
from repro_torch.optim.optimizer import (Optimizer, TrainState, fuse_state,
                                         is_fused, make_optimizer,
                                         unfuse_state)
from repro_torch.utils.dtypes import torch_dtype
from repro_torch.utils.spans import span
from repro_torch.utils.tree import named_parameters
from repro_torch.weights import (block_dims, block_of, gather_state,
                                 opt_dims, shard_shape, shard_state,
                                 shard_tensor)


# the methods whose table has a sparse exchange of its own, which a
# bounded-stale push can defer (a dense-routed table rides the buckets)
STALE_METHODS = ("ps", "ps_gather", "mpi_gatherv")


def estimate_census(model, rt: Runtime) -> sparsity.Census:
    """Stage 1: the build-time workload-model census (estimated α)."""
    return sparsity.run_census(model.specs(), rt.model_cfg, rt.shape_cfg,
                               rt.run_cfg, mesh_dims(rt.mesh).replicas)


def analyze(model, rt: Runtime,
            memory_budget: Optional[float] = None,
            census: Optional[sparsity.Census] = None,
            stale_tables: tuple = ()) -> Plan:
    """Census + cost model -> Plan (the paper's analysis phase). Pass
    ``census`` to plan from a measured census instead of the estimate;
    ``memory_budget`` (bytes per device) defaults to 90 % of the card's
    memory. ``stale_tables`` names the sparse tables that run the
    bounded-staleness push (the jitter fallback), stamped on the plan so
    the step builds the stale rule for exactly those."""
    if census is None:
        census = estimate_census(model, rt)
    return choose_methods(model, rt, census, memory_budget,
                          stale_tables=stale_tables)


def choose_methods(model, rt: Runtime, census: sparsity.Census,
                   memory_budget: Optional[float] = None,
                   stale_tables: tuple = ()) -> Plan:
    """Stage 2: pure census -> Plan (the Table-3 argmin per parameter, its
    placement on the mesh, the memory escalation and the bucket plan). A
    table of ``stale_tables`` is stamped stale where the machinery is on
    (``max_staleness > 0``) and the table has its own sparse exchange (a
    dense-routed table rides the synchronous buckets)."""
    check_ported(rt.run_cfg, rt.mesh)
    if memory_budget is None:
        memory_budget = 0.9 * cost_model.HW.hbm_bytes
    dims = mesh_dims(rt.mesh)
    hw = cost_model.resolve_hw(rt.run_cfg)
    mesh = rt.mesh
    can_shard_rows = rt.rules.axis_size("vocab") > 1
    strategy = rt.resolved_strategy
    pbytes = torch.empty((), dtype=rt.param_dtype).element_size()
    table_methods: dict = {}
    table_capacity: dict = {}
    table_wire: dict = {}
    table_alpha: dict = {}
    table_serve: dict = {}
    serving = rt.shape_cfg.kind == "decode"
    stale_requested = (set(stale_tables) if rt.run_cfg.max_staleness > 0
                       else set())
    stale_stamped: set = set()

    def wire_for(name: str):
        """OPSW wire dtype: the census's profiled hint when present (and
        OPSW is on), else the global knob."""
        hint = census.wire_dtypes.get(name)
        if hint is not None and rt.run_cfg.opsw:
            return torch_dtype(hint)
        return rt.wire_dtype

    specs = flatten_specs(model.specs())
    params = {}
    for name, spec in specs:
        b = math.prod(spec.shape) * pbytes
        alpha = census.alpha_for(name) if spec.sparse else census.alpha
        method, costs = cost_model.choose_method(
            b=b, sparse=spec.sparse, alpha=alpha, dims=dims,
            comm_mode=rt.run_cfg.comm_mode, can_shard_rows=can_shard_rows,
            hw=hw)
        pspec = rt.rules.pspec(spec.axes, spec.shape)
        capacity = 0
        wire = wire_for(name)
        if spec.sparse:
            capacity = census.capacity_for(name)
            if method in ("allreduce", "dense") and mesh is not None \
                    and rt.run_cfg.capacity_mode == "capped":
                # a dense-routed table dedupes the global batch: size it
                # exactly (it can never exceed the global tokens or rows)
                capacity = min(rt.shape_cfg.tokens, spec.shape[0])
            table_methods[name] = method if mesh is not None else "dense"
            table_capacity[name] = capacity
            table_wire[name] = wire
            table_alpha[name] = float(alpha)
            if serving:
                # the pull wire and per-token exchange seconds this table
                # costs the engine at decode batch shapes
                table_serve[name] = cost_model.serve_table_pricing(
                    b=b, alpha=float(alpha), method=table_methods[name],
                    dims=dims, batch_tokens=rt.shape_cfg.global_batch,
                    hw=hw)
            if method in ("mpi_gatherv", "allreduce"):
                # the table replicated (MPI baseline / dense-AR pick)
                pspec = (None,) * len(spec.shape)
        stale = bool(spec.sparse and name in stale_requested
                     and method in STALE_METHODS)
        if stale:
            stale_stamped.add(name)
        if method == "fsdp" and mesh is not None:
            pspec = add_fsdp(pspec, spec.shape, mesh, strategy)
        opt_pspec = pspec
        if rt.run_cfg.zero_stage >= 1 and mesh is not None \
                and not spec.sparse:
            opt_pspec = add_fsdp(pspec, spec.shape, mesh, strategy)
        params[name] = ParamPlan(
            name=name, method=method, placement=pspec,
            opt_placement=opt_pspec, wire_dtype=wire, sparse=spec.sparse,
            bytes=int(b), capacity=capacity, stale=stale, est_cost=costs)

    embed_method = table_methods.get(
        "embed", next(iter(table_methods.values()), "dense"))
    plan = Plan(model_cfg=rt.model_cfg, run_cfg=rt.run_cfg,
                shape_cfg=rt.shape_cfg, mesh=mesh, rules=rt.rules,
                params=params, alpha=census.alpha, capacity=census.capacity,
                zero_stage=rt.run_cfg.zero_stage, embed_method=embed_method,
                table_methods=table_methods, table_capacity=table_capacity,
                table_wire=table_wire, table_alpha=table_alpha,
                table_serve=table_serve,
                grown_tables=tuple(sorted(
                    n for n, t in census.tables.items() if t.grown)),
                stale_tables=tuple(sorted(stale_stamped)))

    if mesh is not None:
        # memory escalation: replicate -> ZeRO-1 -> ZeRO-3 (auto-PS)
        for stage in (rt.run_cfg.zero_stage, 1, 3):
            if per_device_bytes(specs, rt.rules,
                                list(plan.params.values())) <= memory_budget:
                break
            plan = _escalate(plan, specs, rt, stage if stage else 1)
        # bucket the dense exchange after the escalation (fsdp vetoes it)
        buckets.plan_buckets(plan, rt)
    _set_held(plan, specs)
    return plan


def _set_held(plan: Plan, specs: list) -> None:
    """Stamp each ParamPlan's ``held`` and ``opt_held``: the placements
    the port executes for the parameter and for its optimizer state, and
    the layout ``groups`` of its model-axis block. Every block runs on
    the plan's own placement; a leaf the fused apply reads from its
    bucket's flat buffer keeps its moments beside the parameter (the
    reference's ``state_shardings`` replicates the bucket buffers)."""
    fused = set()
    if plan.fused_apply:
        fused = {i for b in plan.bucket_plan.buckets for i in b.idx}
    for i, (name, spec) in enumerate(specs):
        p = plan.params[name]
        if plan.mesh is None:
            p.held = p.opt_held = p.groups = ()
            continue
        p.held = p.placement
        p.opt_held = p.held if i in fused else p.opt_placement
        p.groups = gate_groups(name, spec.axes, p.held)


def _escalate(plan: Plan, specs: list, rt: Runtime, stage: int) -> Plan:
    """Raise the ZeRO stage: shard optimizer state (1) then params (3)."""
    strategy = rt.resolved_strategy
    for name, spec in specs:
        p = plan.params[name]
        if spec.sparse:
            continue
        new = replace(p, opt_placement=add_fsdp(p.placement, spec.shape,
                                                rt.mesh, strategy))
        if stage >= 3 and p.method == "allreduce":
            full = add_fsdp(p.placement, spec.shape, rt.mesh, strategy)
            new = replace(new, method="fsdp", placement=full,
                          opt_placement=full)
        plan.params[name] = new
    plan.zero_stage = stage
    return plan


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------

def opsw_cast(grads: dict, plan: Plan) -> dict:
    """OPSW: f32 gradients ride each parameter's planned wire dtype before
    the optimizer — on one device too, as in the reference, where the cast
    changes the trajectory at f32 parameters."""
    if not plan.run_cfg.opsw:
        return grads
    return {n: g.to(plan.params[n].wire_dtype)
            if g.dtype == torch.float32 else g for n, g in grads.items()}


def _fsdp_dim(held: tuple, batch_axes: tuple, mesh) -> Optional[tuple]:
    """(dim, axes) of the dimension a held placement shards over batch
    axes (an fsdp parameter's: ``add_fsdp`` puts them on one), or None."""
    for d, e in enumerate(held):
        axes = tuple(a for a in entry_axes(e) if a in batch_axes)
        if mesh.axes_size(axes) > 1:
            return d, axes
    return None


def _mesh_value_and_grad(model, rt: Runtime, plan: Plan) -> Callable:
    """(state, batch) -> ((loss, metrics), grads, bufs) on a mesh: this
    rank's loss of its replica's rows, backward, then every gradient
    exchanged by its plan — the average over the replicas, at its wire
    dtype. ``bufs``: each bucket's post-all-reduce flat buffer (empty
    without a bucket plan), which the fused apply reads."""
    mesh, ba = rt.mesh, tuple(rt.batch_axes)
    n_rep = rt.replicas
    scale = 1.0 / n_rep
    names = list(plan.params)
    own = named_parameters(model)
    bp = plan.bucket_plan
    bucketed = {i for b in bp.buckets for i in b.idx} if bp else set()
    # the magnitude census rides the bucketed step only, as in the reference
    census = bp is not None and rt.run_cfg.wire_dtype_auto
    if rt.overlap is not None:
        rt.overlap.remove()       # the previous build's gradient hooks
    overlap = (buckets.OverlapExchange(bp, [own[n] for n in names], mesh,
                                       census=census)
               if bp is not None and bp.overlap else None)
    rt.overlap = overlap
    gathered = {}
    for n, p in plan.params.items():
        fd = _fsdp_dim(p.held, ba, mesh)
        if fd is not None:
            gathered[n] = fd

    def averaged(g: torch.Tensor, wire: torch.dtype) -> torch.Tensor:
        """(g · 1/N) at the wire dtype."""
        if n_rep == 1 and g.dtype == wire:
            return g
        g32 = g.float()
        if n_rep > 1:
            g32 = g32 * scale
        return g32.to(wire)

    def exchange(n: str, g: torch.Tensor, stats: dict):
        p = plan.params[n]
        if p.sparse and p.method in embedding.PUSHED:
            # pushed and replica-summed by the lookup: only the 1/N
            if census and g.dim() >= 2:
                stats[f"{n}_gmax"], stats[f"{n}_grms"] = \
                    buckets.row_magnitude(g.float() * scale)
            return (g.float() * scale).to(g.dtype) if n_rep > 1 else g
        wire = buckets.exchange_dtype(rt, p)
        buf = averaged(g, wire)
        if n in gathered:
            d, axes = gathered[n]
            buf = coll.reduce_scatter(buf, axes, mesh, dim=d)
            rest = tuple(a for a in ba if a not in axes)
            return coll.all_reduce(buf, rest, mesh) if rest else buf
        return coll.all_reduce(buf, ba, mesh)

    def value_and_grad(state: TrainState, batch: dict):
        for p in own.values():
            p.grad = None
        batch = dict(batch)
        hb = batch.pop("_heartbeat", None)
        full = {n: coll.all_gather(own[n].detach(), axes, mesh,
                                   dim=d).requires_grad_()
                for n, (d, axes) in gathered.items()}
        deferred = [] if bp is not None and not bp.overlap else None
        rt.deferred_pushes = deferred
        if overlap is not None:
            overlap.begin()
        try:
            with span("step.forward"):
                loss, metrics = model.loss_fn(batch, params=full)
            with span("step.backward"), coll.backward():
                loss.backward()
        finally:
            rt.deferred_pushes = None
        with span("step.exchange"):
            done, bufs = overlap.finish() if overlap is not None else ({}, [])
            local = {n: (full[n].grad if n in full else own[n].grad)
                     for n in names}
            for p in own.values():
                p.grad = None      # the step owns its gradients from here on
            for n, uids, d_rows, vs, ectx in deferred or ():
                # overlap=False: the gatherv pushes, after the backward
                local[n] = embedding.deferred_push(uids, d_rows, vs, ectx).to(
                    own[n].dtype)
            grads, stats = {}, {}
            mags = overlap.stats if overlap is not None else []
            if bp is not None and overlap is None:
                for b in bp.buckets:
                    ex, buf = buckets._exchange_bucket(
                        b, [local[names[i]] for i in b.idx], scale, bp, mesh,
                        census=mags if census else None)
                    done.update(zip(b.idx, ex))
                    bufs.append(buf)
            for k, (gmax, grms) in enumerate(mags):
                stats[f"gbucket{k}_gmax"] = gmax
                stats[f"gbucket{k}_grms"] = grms
            for i, n in enumerate(names):
                grads[n] = (done[i] if i in bucketed
                            else exchange(n, local[n], stats))
            if bp is None:
                # the reference's global-semantics step casts every f32
                # gradient to its wire dtype (the sparse ones too)
                grads = opsw_cast(grads, plan)
            if hb is not None:
                # straggler attribution: this replica's beat at N x in its own
                # slot, zero in the others, so the mean the fused all-reduce
                # takes decodes slot j as replica j's beat: D more scalars in
                # the one metrics all-reduce, no collective of their own. The
                # beat is the batch's, or (``rt.beat``) this rank's own work
                # in this step so far
                beat = hb[0] if rt.beat is None else torch.tensor(
                    rt.beat(), dtype=torch.float32, device=hb.device)
                slot = mesh.index(ba)
                for j in range(n_rep):
                    stats[f"heartbeat{j}"] = beat * (float(n_rep) if j == slot
                                                     else 0.0)
            loss, metrics = buckets.fused_metrics(
                loss.detach(), {**metrics, **stats}, ba, mesh, n_rep)
            return (loss, metrics), grads, bufs

    return value_and_grad


# ---------------------------------------------------------------------------
# bounded-staleness buffers (the jitter fallback's part of the state)
# ---------------------------------------------------------------------------

def stale_buffer_tables(plan: Plan, rt: Runtime) -> tuple:
    """The tables that carry a staleness buffer in the state: every sparse
    table with its own exchange, whenever the machinery is on
    (``max_staleness > 0``), flipped stale or not, so the state's layout
    does not change at a sync <-> stale flip."""
    if rt.run_cfg.max_staleness <= 0:
        return ()
    return tuple(sorted(p.name for p in plan.params.values()
                        if p.sparse and p.method in STALE_METHODS))


def ensure_stale_buffers(state: TrainState, plan: Plan,
                         rt: Runtime) -> TrainState:
    """Attach (or drop) the staleness buffers for ``plan``: a zero f32
    gradient buffer and an int32 age for every eligible table. A buffer
    whose shape still matches its table (this rank's shard) carries across
    (a replan or remesh inside a stale window keeps a buffered gradient);
    a changed shape or a newly eligible table starts from zero."""
    names = stale_buffer_tables(plan, rt)
    old = state.stale
    if not names:
        return replace(state, stale=None) if old is not None else state
    old = old or {}
    new = {}
    for n in names:
        p = state.params[n]
        o = old.get(n)
        if o is not None and tuple(o["g"].shape) == tuple(p.shape):
            new[n] = o
        else:
            new[n] = {"g": torch.zeros(p.shape, dtype=torch.float32,
                                       device=p.device),
                      "age": torch.zeros((), dtype=torch.int32,
                                         device=p.device)}
    return replace(state, stale=new)


def _make_staleness_rule(plan: Plan, rt: Runtime) -> Callable:
    """The per-table gradient rewrite between the exchange and the
    optimizer, op for op the reference's:

      stale table: apply the buffered (previous step's) exchanged gradient
                   and buffer the fresh one; the exchange itself still
                   runs every step, so every replica buffers the same
                   aggregate;
      sync table:  apply fresh + buffered and zero the buffer: an ordinary
                   step adds an exact zero, and the first step after a
                   stale -> sync flip drains the last buffered gradient.

    Emits ``staleness_age`` (the largest applied age over the stale
    tables) and ``staleness_violation`` (the sum of relu(age -
    max_staleness)). ``(stale, grads, metrics) -> (stale, grads,
    metrics)``. The buffers are updated in place (at a full-width table
    an f32 buffer is GBs a rank): the values are the reference's."""
    stale_set = frozenset(plan.stale_tables)
    smax = int(rt.run_cfg.max_staleness)

    @torch.no_grad()
    def apply_rule(stale, grads: dict, metrics: dict):
        if stale is None:
            return None, grads, metrics
        grads = dict(grads)
        ages = []
        for name, buf in stale.items():
            g = grads[name]
            age = buf["age"]
            buf["age"] = torch.zeros((), dtype=torch.int32, device=g.device)
            if name in stale_set:
                ages.append(age + 1)
                grads[name] = buf["g"].to(g.dtype, copy=True)
                buf["g"].copy_(g)
            else:
                # g is this step's own exchanged gradient: summed into
                grads[name] = g.float().add_(buf["g"]).to(g.dtype)
                buf["g"].zero_()
        if ages:
            age_max = ages[0]
            for a in ages[1:]:
                age_max = torch.maximum(age_max, a)
            metrics["staleness_age"] = age_max
            metrics["staleness_violation"] = sum(
                torch.clamp(a - smax, min=0) for a in ages)
        return stale, grads, metrics

    return apply_rule


def make_train_step(model, optimizer: Optimizer, rt: Runtime,
                    plan: Plan) -> Callable:
    """(state, batch) -> (state, metrics). ``batch`` holds tensors on the
    model's device (this replica's rows on a mesh). When the plan stamps
    ``fused_apply`` the optimizer applies bucket-natively from the
    exchange's flat buffers (``update_fused``, against the fused state
    that ``build_step`` lays out); an optimizer without a fused path
    (sgd) drops the stamp.

    ``RunConfig.verify_contract``: the first step of this build runs its
    loss, backward and exchange under ``collectives.record()`` and checks
    the record against the plan (``analysis/contract.py``) before the
    optimizer applies, so a step that breaks its plan raises
    ``ContractViolation`` and changes no state. The check reads the plan's
    bucket plan when it runs, the step the one it was built with.
    ``train_step.exchange(state, batch)`` runs the step that far under a
    record and applies nothing (``Runner.check_contract``).

    Between the exchange and the optimizer, the staleness rule rewrites
    the gradients of the tables with a staleness buffer
    (``RunConfig.max_staleness > 0``: ``_make_staleness_rule``). A
    ``_heartbeat`` batch entry (``RunConfig.heartbeat``: this replica's
    (1,) beat on a mesh) comes back as the metrics ``heartbeat{j}``
    (``_mesh_value_and_grad``; one device echoes each slot)."""
    if plan.fused_apply and optimizer.update_fused is None:
        plan.fused_apply = False
    stale_rule = _make_staleness_rule(plan, rt)

    def value_and_grad(state: TrainState, batch: dict):
        params = state.params
        for p in params.values():
            p.grad = None
        batch = dict(batch)
        hb = batch.pop("_heartbeat", None)
        with span("step.forward"):
            loss, metrics = model.loss_fn(batch)
        if hb is not None:
            metrics = dict(metrics)
            for j in range(hb.shape[0]):
                metrics[f"heartbeat{j}"] = hb[j]
        with span("step.backward"), coll.backward():
            loss.backward()
        grads = {n: p.grad for n, p in params.items()}
        for p in params.values():
            p.grad = None      # the step owns its gradients from here on
        with span("step.exchange"):
            grads = opsw_cast(grads, plan)
        return (loss.detach(), metrics), grads, []

    if rt.mesh is not None:
        value_and_grad = _mesh_value_and_grad(model, rt, plan)

    def exchange(state: TrainState, batch: dict) -> tuple:
        """The step up to its exchange under a record: -> (value_and_grad's
        result, the ``collectives.Record``)."""
        with coll.record() as rec:
            out = value_and_grad(state, batch)
        return out, rec

    gate = [bool(rt.run_cfg.verify_contract)]    # armed until a step passes

    def train_step(state: TrainState, batch: dict):
        if gate[0]:
            out, rec = exchange(state, batch)
            verify_step_contract(plan, rec)
            gate[0] = False
        else:
            out = value_and_grad(state, batch)
        (loss, metrics), grads, bufs = out
        metrics = dict(metrics)
        with span("step.update"):
            new_stale, grads, metrics = stale_rule(state.stale, grads,
                                                   metrics)
            if plan.fused_apply:
                state, opt_metrics = optimizer.update_fused(
                    state, grads, bufs, plan.bucket_plan)
            else:
                state, opt_metrics = optimizer.update(state, grads)
        state.stale = new_stale
        metrics.update(opt_metrics)
        metrics["loss"] = loss
        return state, metrics

    train_step.exchange = exchange
    return train_step


def load_params_(model, named: dict, plan: Optional[Plan] = None) -> None:
    """Copy ``named`` ({dotted_name: tensor}) into the model's parameters.
    ``plan`` (on a process mesh): a tensor of the parameter's whole shape
    is cut to this rank's shard first (``ParamPlan.held``)."""
    own = named_parameters(model)
    missing = sorted(set(own) - set(named))
    extra = sorted(set(named) - set(own))
    if missing or extra:
        raise ValueError(f"params mismatch: missing {missing}, "
                         f"unexpected {extra}")
    whole = dict(model.param_specs())
    with torch.no_grad():
        for n, p in own.items():
            src = named[n]
            if plan is not None and plan.mesh is not None and \
                    tuple(src.shape) == tuple(whole[n].shape):
                pp = plan.params[n]
                src = shard_tensor(src, pp.held, plan.mesh, pp.groups)
            if tuple(src.shape) != tuple(p.shape) or src.dtype != p.dtype:
                raise ValueError(
                    f"{n}: got {src.dtype} {tuple(src.shape)}, want "
                    f"{p.dtype} {tuple(p.shape)}")
            p.copy_(src)


# A leaf whose f32 draw would pass this many bytes is drawn one slice of
# its leading dimension at a time (a layer, then an expert), so that the
# init never holds more than this in scratch. At full width only the moe
# family's expert leaves are that large (grok-1's stacked w_gate at 4
# layers is a 25.8 GB draw); every other leaf is drawn whole.
INIT_DRAW_BYTES = 16 << 30


def _draw_blocks(gen: torch.Generator, shape: tuple, std: float,
                 budget: int, device, prefix: tuple = ()):
    """The draw of an N(0, std) leaf of ``shape``, in f32, as (index
    prefix, block) pairs in draw order: the whole leaf, or past ``budget``
    bytes of f32 one slice along the first dimension at a time."""
    if math.prod(shape) * 4 > budget and len(shape) > 1:
        for i in range(shape[0]):
            yield from _draw_blocks(gen, shape[1:], std, budget, device,
                                    prefix + (i,))
        return
    yield prefix, torch.randn(shape, generator=gen, dtype=torch.float32,
                              device=device).mul_(std)


def _draw_all_(model, seed: int, targets: dict,
               plan: Optional[Plan] = None) -> None:
    """Fresh parameters from ``seed`` into ``targets`` ({name: tensor}),
    one leaf at a time: one torch.Generator on the model's device drawing
    each parameter whole, in flatten order. ``plan`` (on a process mesh):
    a target holds this rank's shard (``ParamPlan.held`` and ``groups``),
    so every rank gets its block of the one-device draw without holding
    the whole model."""
    gen = torch.Generator(device=model.rt.device)
    gen.manual_seed(seed)
    with torch.no_grad():
        for n, spec in model.param_specs():
            out = targets[n]
            if spec.init == "zeros":
                out.zero_()
            elif spec.init == "ones":
                out.fill_(1)
            else:
                dims = None
                if plan is not None and tuple(out.shape) != tuple(spec.shape):
                    pp = plan.params[n]
                    dims = block_dims(pp.held, plan.mesh, pp.groups)
                for idx, blk in _draw_blocks(gen, spec.shape, init_std(spec),
                                             INIT_DRAW_BYTES, out.device):
                    if dims is None:
                        out[idx].copy_(blk)
                    else:
                        _copy_block_(out, idx, blk, dims, plan.mesh)
                    # freed before the next block is drawn: one block of
                    # scratch at a time
                    del blk


def _copy_block_(out: torch.Tensor, idx: tuple, blk: torch.Tensor,
                 dims: list, mesh) -> None:
    """Copy the part of draw block ``blk`` (the leaf at index prefix
    ``idx``) that lies in this rank's block (``dims``: [(dim, axes,
    groups)] of the whole leaf) into its shard ``out``. A leading
    (indexed) dimension is never grouped: the draw splits the leading
    dimensions of a stacked leaf, and a grouped one is the last."""
    pos, rest = list(idx), []
    for d, axes, g in dims:
        if d >= len(idx):
            rest.append((d - len(idx), axes, g))
            continue
        lo = mesh.index(axes) * out.shape[d]
        if not lo <= idx[d] < lo + out.shape[d]:
            return
        pos[d] -= lo
    out[tuple(pos)].copy_(block_of(blk, rest, mesh))


def _draw_params(model, seed: int) -> dict:
    """Fresh whole parameters from ``seed`` as new tensors (the values
    ``init_params_`` draws)."""
    dev, dtype = model.rt.device, model.rt.param_dtype
    out = {n: torch.empty(spec.shape, dtype=spec.dtype or dtype, device=dev)
           for n, spec in model.param_specs()}
    _draw_all_(model, seed, out)
    return out


def init_params_(model, seed: int, plan: Optional[Plan] = None) -> None:
    """Fresh init from ``seed``, drawn straight into the model's
    parameters (no second copy of the model); ``plan`` on a process mesh:
    into this rank's shards."""
    _draw_all_(model, seed, named_parameters(model), plan)


def place_params_(model, plan: Plan, mesh) -> None:
    """Give each parameter the model holds on the meta device (a model
    built on a process mesh, ``Runtime.param_device``) an uninitialized
    tensor of this rank's shard's shape (``ParamPlan.held``) on the
    runtime's device; the seeded draw, the given weights or a state fill
    it. No rank ever holds a whole sharded leaf."""
    dev = model.rt.device
    for n, p in named_parameters(model).items():
        if p.device.type != "meta":
            continue
        shape = shard_shape(tuple(p.shape), plan.params[n].held, mesh)
        *path, attr = n.split(".")
        setattr(model.get_submodule(".".join(path)), attr, nn.Parameter(
            torch.empty(shape, dtype=p.dtype, device=dev)))


def _set_param(model, name: str, t: torch.Tensor) -> None:
    """A new parameter holding a copy of ``t`` in place of ``name``."""
    *path, attr = name.split(".")
    setattr(model.get_submodule(".".join(path)), attr,
            nn.Parameter(t.detach().clone()))


def _install_params_(model, named: dict) -> None:
    """Make ``named`` (this rank's tensors) the model's parameters: a
    parameter that already is the tensor stays; one of the same shape gets
    the values copied in; where the shape changed (a placement moved) a
    new parameter takes its place."""
    own = named_parameters(model)
    if set(own) != set(named):
        raise ValueError(f"state names {sorted(named)} vs the model's "
                         f"{sorted(own)}")
    with torch.no_grad():
        for n, p in own.items():
            src = named[n]
            if src is p:
                continue
            if src.dtype != p.dtype:
                raise ValueError(f"{n}: got {src.dtype}, want {p.dtype}")
            if tuple(src.shape) == tuple(p.shape):
                p.copy_(src)
            else:
                _set_param(model, n, src)


def moment_shapes(own: dict, plan: Plan) -> dict:
    """{name: the shape of this rank's optimizer state for the parameter
    ``own[name]``}: the parameter's own shape, cut along the dimensions
    ZeRO-1 shards its moments over (``ParamPlan.opt_held``)."""
    out = {}
    for n, p in own.items():
        shape = list(p.shape)
        if plan.mesh is not None:
            pp = plan.params[n]
            for d, axes, _ in opt_dims(pp.held, pp.opt_held, plan.mesh):
                shape[d] //= plan.mesh.axes_size(axes)
        out[n] = tuple(shape)
    return out


def load_state(model, rt: Runtime, plan: Plan,
               state: TrainState) -> TrainState:
    """A canonical per-parameter state (each leaf whole, or already this
    rank's shard under ``plan``) -> this rank's shards, the parameters
    installed as the model's own. The step is untouched."""
    if is_fused(state):
        raise ValueError("load_state takes the canonical per-parameter "
                         "state: unfuse it with its plan's buckets")
    whole = {n: spec.shape for n, spec in model.param_specs()}
    state = shard_state(state, plan, rt.mesh, whole)
    _install_params_(model, state.params)
    return replace(state, params=named_parameters(model))


def build_step(model, optimizer: Optimizer, rt: Runtime, plan: Plan,
               params: Optional[dict] = None, *, seed: int = 0,
               state: Optional[TrainState] = None) -> tuple:
    """-> (train step, state). The state starts from ``state``, a
    canonical per-parameter TrainState whose leaves are each whole or
    already this rank's shard under ``plan`` (replan, restore and retry
    start here, with no throwaway init); else from ``params``
    ({dotted_name: whole tensor}, e.g. weights.load_reference_params);
    else from a fresh init drawn from ``seed``. On a mesh each rank keeps
    its shards. When the plan stamps ``fused_apply`` the optimizer memory
    is laid out per bucket here (``Runner.state`` hands it out per
    parameter)."""
    check_ported(rt.run_cfg, rt.mesh)
    if rt.mesh is not None:
        place_params_(model, plan, rt.mesh)
    mesh_plan = plan if rt.mesh is not None else None
    if state is None:
        if params is None:
            init_params_(model, seed, mesh_plan)
        else:
            load_params_(model, params, mesh_plan)
        own = named_parameters(model)
        state = optimizer.init(own, shapes=moment_shapes(own, plan))
    else:
        state = load_state(model, rt, plan, state)
    if rt.run_cfg.kernel_autotune:
        # the scatter's measured tile per table (on the card; the CPU's
        # plain version has none)
        from repro_torch.kernels import autotune
        autotune.ensure_for_plan(plan, rt, model)
    step = make_train_step(model, optimizer, rt, plan)
    # the staleness buffers live on the canonical state: attached, carried
    # or dropped for this plan before any fused re-layout
    state = ensure_stale_buffers(state, plan, rt)
    if plan.fused_apply:
        state = fuse_state(state, plan.bucket_plan)
    return step, state


def apply_replan(model, optimizer: Optimizer, rt: Runtime, new_plan: Plan,
                 state: TrainState, diff: dict) -> tuple:
    """Hot-swap to ``new_plan``: rebuild the step and move the state.
    The one swap sequence under ``Runner.replan`` and the trainer. A fused
    layout is unfused with the OLD plan's buckets into copies (no view of
    a buffer that is about to go survives) and re-fused with the new
    plan's in ``build_step``; when the placements moved every leaf is
    gathered whole on the old plan and cut again on the new one. Marks
    ``diff['rebuilt']``. An ``opt_placement`` change (``plan_diff``'s
    ``pspecs_changed``) moves the moments too, and so does a change of
    what the port executes (``held`` / ``opt_held``: a leaf entering or
    leaving a fused bucket). -> (train step, state)."""
    old_plan = rt.plan
    if is_fused(state):
        state = unfuse_state(state, old_plan.bucket_plan, copy=True)
    moved = diff["pspecs_changed"] or any(
        (p.held, p.opt_held) != (old_plan.params[n].held,
                                 old_plan.params[n].opt_held)
        for n, p in new_plan.params.items())
    if moved and new_plan.mesh is not None:
        state = gather_state(state, old_plan, old_plan.mesh)
    rt.plan = new_plan           # the model's lookups read the live plan
    step, state = build_step(model, optimizer, rt, new_plan, state=state)
    diff["rebuilt"] = True
    return step, state


def local_batch(rt: Runtime, batch: dict) -> dict:
    """The global batch -> this replica's contiguous rows (as
    ``P(batch_axes)`` shards them) as tensors on the runtime's device."""
    if rt.mesh is not None and rt.replicas > 1:
        r, n = rt.mesh.index(rt.batch_axes), rt.replicas
        batch = {k: v[len(v) // n * r:len(v) // n * (r + 1)]
                 for k, v in batch.items()}
    return {k: torch.as_tensor(v).to(rt.device) for k, v in batch.items()}


def _abstract_batch(model, rt: Runtime) -> dict:
    """The global batch as empty meta tensors of the shapes and dtypes
    ``model.input_specs()`` gives (the reference's ShapeDtypeStructs for
    lowering a step without data; ``local_batch`` cuts this replica's
    rows from it), with the (replicas,) heartbeat under
    ``RunConfig.heartbeat``."""
    out = {k: torch.empty(shape, dtype=dtype, device="meta")
           for k, (shape, dtype) in model.input_specs().items()}
    if rt.run_cfg.heartbeat:
        out["_heartbeat"] = torch.empty((rt.replicas,), dtype=torch.float32,
                                        device="meta")
    return out


def fresh_state(model, optimizer: Optimizer, seed: int) -> TrainState:
    """A fresh whole state drawn from ``seed`` (the values ``build_step``
    draws into the model), without touching the model's parameters: what
    a failed step re-initializes from when nothing is committed."""
    return optimizer.init(_draw_params(model, seed))


@dataclass
class Runner:
    model: Any
    optimizer: Optimizer
    plan: Plan
    rt: Runtime
    train_step: Callable
    live_state: TrainState      # the layout the step runs (fused or not)

    @property
    def state(self) -> TrainState:
        """The canonical per-param state: a fused layout's moments and
        shadows as per-parameter views of its flat buffers."""
        return unfuse_state(self.live_state, self.plan.bucket_plan)

    def run(self, batch: dict) -> dict:
        """One training step on the global batch (numpy arrays or
        tensors); on a mesh this replica's contiguous rows go in. Returns
        the step's metrics as detached tensors."""
        self.live_state, metrics = self.train_step(
            self.live_state, local_batch(self.rt, batch))
        return metrics

    def replan(self, census: sparsity.Census, *, force: bool = False,
               capacity_drift: float = 1.5) -> dict:
        """Hot-swap the plan and step from a (typically observed) census.
        The plan is recomputed through the same stages as at build time;
        if nothing material changed (``plan_diff``) the live step is kept
        unless ``force``. Returns the plan diff (``rebuilt`` marks a
        swap)."""
        new_plan = analyze(self.model, self.rt, census=census)
        diff = plan_diff(self.plan, new_plan, capacity_drift)
        if not (diff["changed"] or force):
            return diff
        self.plan = new_plan
        self.train_step, self.live_state = apply_replan(
            self.model, self.optimizer, self.rt, new_plan, self.live_state,
            diff)
        return diff

    def check_contract(self, batch: dict, *, strict_dtype: bool = False
                       ) -> list:
        """The plan-contract check of the live step (analysis/contract.py):
        one step on ``batch`` (the global batch, as ``run``) as far as its
        exchange, recorded, and nothing applied: the state is unchanged.
        Returns the findings (empty: the step carries out the plan). The
        reference's ``Runner.check_contract`` takes no batch: it reads the
        collectives from the compiled step's text; the port has no
        compiled text, so it records a step."""
        _, rec = self.train_step.exchange(self.live_state,
                                          local_batch(self.rt, batch))
        return check_contract(self.plan, rec, strict_dtype=strict_dtype)


def get_runner(model_cfg: ModelConfig, shape_cfg: ShapeConfig,
               run_cfg: RunConfig = RunConfig(), mesh: Any = None,
               seed: int = 0, *, device=None,
               params: Optional[dict] = None) -> Runner:
    """Transform a single-device model into a runner on ``device``
    (default: the card; on a mesh, the mesh's device). ``mesh``: a
    ``launch/mesh.py::make_mesh`` mesh over the initialised process group;
    every rank calls this with the same arguments. ``params`` (whole
    tensors) overrides the seeded init."""
    if isinstance(mesh, MeshShape) and not isinstance(mesh, Mesh):
        raise ValueError(f"{mesh!r} holds no process groups: a MeshShape "
                         "plans (analyze) but runs nothing; build the mesh "
                         "with launch/mesh.py::make_mesh")
    if isinstance(mesh, DryMesh):
        raise ValueError(f"{mesh!r} is record-only: it computes nothing and "
                         "only launch/dryrun.py builds on it")
    rt = Runtime(model_cfg, run_cfg, shape_cfg, mesh=mesh, device=device)
    model = build_model(model_cfg, rt)
    plan = analyze(model, rt)
    rt.plan = plan
    optimizer = make_optimizer(rt)
    step, state = build_step(model, optimizer, rt, plan, params, seed=seed)
    return Runner(model=model, optimizer=optimizer, plan=plan, rt=rt,
                  train_step=step, live_state=state)


# ---------------------------------------------------------------------------
# serving steps (runtime/server.py): batched prefill + slot-paged decode.
# Where the reference donates the cache, ``lens`` and ``tok`` to its jitted
# steps (donate_argnums), these steps update the same tensors in place.
# ---------------------------------------------------------------------------

def make_decode_step(model, rt: Runtime, plan: Plan) -> Callable:
    """(cache, tokens (B, 1), cache_len) -> (logits, cache)."""
    def decode_step(cache, tokens, cache_len):
        return model.decode_fn(cache, tokens, cache_len)
    return decode_step


def make_prefill_step(model, rt: Runtime, plan: Plan) -> Callable:
    """(batch) -> (logits, cache)."""
    def prefill_step(batch):
        logits, cache, _ = model.prefill_fn(batch)
        return logits, cache
    return prefill_step


def sample_tokens(logits: torch.Tensor, *, greedy: bool, temperature: float,
                  generator: Optional[torch.Generator] = None,
                  rt: Optional[Runtime] = None) -> torch.Tensor:
    """Device-side sampling: (B, V) logits -> (B,) int32 token ids. Greedy
    argmax (the first maximum on ties, as ``jnp.argmax``), or a draw from
    softmax(logits / temperature) on ``generator``: a different stream from
    ``jax.random``'s by construction, so only greedy tokens compare.

    ``rt`` with a vocab-sharded head (a serve mesh): ``logits`` are this
    rank's (B, V/M) block. The padded vocab rows are masked; greedy takes
    each rank's first maximum and then, over ``model``, the first rank
    holding the largest (the lowest global index, as one device's argmax);
    a draw gathers the whole row on every rank, whose generators share a
    seed, so every rank draws the same token."""
    if rt is not None and rt.vocab_shards > 1:
        mesh, vs = rt.mesh, logits.shape[-1]
        off = rt.model_index * vs
        gidx = off + torch.arange(vs, device=logits.device)
        logits = logits.float().masked_fill(
            gidx >= rt.model_cfg.vocab_size, float("-inf"))
        if greedy:
            arg = logits.argmax(dim=-1)
            best = torch.stack([logits.gather(1, arg[:, None])[:, 0].double(),
                                (arg + off).double()], dim=-1)
            both = coll.all_gather(best[:, None], "model", mesh, dim=1)
            pick = both[..., 0].argmax(dim=1, keepdim=True)  # (B, 1)
            return both[..., 1].gather(1, pick)[:, 0].to(torch.int32)
        logits = coll.all_gather(logits, "model", mesh, dim=-1)
    if greedy:
        return logits.argmax(dim=-1).to(torch.int32)
    t = max(float(temperature), 1e-4)
    probs = torch.softmax(logits.float() / t, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
        torch.int32)


def make_serve_prefill_step(model, rt: Runtime, plan: Plan, *,
                            greedy: bool = True, temperature: float = 1.0
                            ) -> Callable:
    """Batched prefill for one admitted request:

      1. the full forward over the (bucket-padded) prompt, collecting every
         layer's K/V (``model.prefill_cache_fn``);
      2. those rows go into the live decode cache at the request's slot
         (rows past the true length carry pad K/V, masked out of every later
         attention by the slot's length);
      3. the first generated token is sampled from the last prompt position;
      4. the slot's length and pending token are set.

    ``prefill_step(cache, lens, tok, tokens (1, Lb), length, slot,
    generator=None) -> (cache, lens, tok, first (1,))``; cache, lens and tok
    are updated in place and returned. On a serve mesh ``slot`` is this
    rank's slot (of its B/D) and each rank inserts the rows of its block
    of the cache's positions."""
    if model.prefill_cache_fn is None:
        raise ValueError(
            f"family {model.cfg.family!r} has no positional KV cache; "
            "batched prefill is undefined under padding (use the decode "
            "loop for recurrent families)")

    @torch.no_grad()
    def prefill_step(cache, lens, tok, tokens, length: int, slot: int,
                     generator=None):
        logits, kv = model.prefill_cache_fn(tokens)
        last = logits[:1, int(length) - 1, :]                  # (1, Vp)
        nxt = sample_tokens(last, greedy=greedy, temperature=temperature,
                            generator=generator, rt=rt)        # (1,)
        # this rank's block of the positions (all of them off a mesh)
        lb = tokens.shape[1]
        s_loc = cache[0].shape[2]
        off = (rt.mesh.index(rt.cache_seq_axes) * s_loc
               if rt.cache_seq_axes else 0)
        n = max(0, min(lb - off, s_loc))
        for c, p in zip(cache, kv):
            c[:, slot, :n] = p[:, 0, off:off + n].to(c.dtype)
        lens[slot] = int(length)
        tok[slot, 0] = nxt[0]
        return cache, lens, tok, nxt

    return prefill_step


def make_serve_decode_step(model, rt: Runtime, plan: Plan, *, max_seq: int,
                           greedy: bool = True, temperature: float = 1.0
                           ) -> Callable:
    """One slot-paged decode step over the whole batch.

    ``lens`` (B,) is each slot's position (per-row KV write and per-slot
    attention mask), ``tok`` (B, 1) each slot's pending token (the previous
    step's device-side sample). ``active`` is the host's (B,) occupancy
    mask: inactive slots neither advance their length nor replace their
    token. ``decode_step(cache, lens, tok, active, generator=None) ->
    (cache, lens, tok, out (B,))``, with inactive slots as -1 in ``out``;
    cache, lens and tok are updated in place."""

    @torch.no_grad()
    def decode_step(cache, lens, tok, active, generator=None):
        logits, cache = model.decode_fn(cache, tok, lens)
        nxt = sample_tokens(logits[:, -1, :], greedy=greedy,
                            temperature=temperature, generator=generator,
                            rt=rt)
        act = active & (lens > 0)
        tok.copy_(torch.where(act[:, None], nxt[:, None], tok))
        lens.copy_(torch.where(act, torch.clamp(lens + 1, max=max_seq),
                               lens))
        out_tok = torch.where(act, nxt, torch.full_like(nxt, -1))
        return cache, lens, tok, out_tok

    return decode_step
