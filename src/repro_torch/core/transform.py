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
its shards of the parameters (``ParamPlan.held``); an ``fsdp`` parameter
is all-gathered over its data axes before the forward and its gradient
reduce-scattered after the backward; the dense gradients are averaged over
the replicas at their wire dtype, in buckets where the plan has them; the
loss and every scalar metric ride one all-reduce. The correctness
contract (paper §3.1): the step computes what the single-device step
computes at equal global batch. ``Runner.replan`` and the replan loop come
with ROADMAP slice 3.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Any, Callable, Optional

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig, RunConfig, ShapeConfig
from repro_torch.core import buckets, cost_model, sparsity
from repro_torch.core import collectives as coll
from repro_torch.core import embedding
from repro_torch.core.plan import (ParamPlan, Plan, add_fsdp, entry_axes,
                                   held_placement, per_device_bytes)
from repro_torch.core.runtime import Runtime, check_ported, mesh_dims
from repro_torch.launch.mesh import Mesh, MeshShape
from repro_torch.models.layers import flatten_specs, init_param
from repro_torch.models.model import build_model
from repro_torch.optim.optimizer import Optimizer, TrainState, make_optimizer
from repro_torch.utils.dtypes import torch_dtype
from repro_torch.utils.tree import named_parameters
from repro_torch.weights import shard_params


def estimate_census(model, rt: Runtime) -> sparsity.Census:
    """Stage 1: the build-time workload-model census (estimated α)."""
    return sparsity.run_census(model.specs(), rt.model_cfg, rt.shape_cfg,
                               rt.run_cfg, mesh_dims(rt.mesh).replicas)


def analyze(model, rt: Runtime,
            memory_budget: Optional[float] = None,
            census: Optional[sparsity.Census] = None) -> Plan:
    """Census + cost model -> Plan (the paper's analysis phase). Pass
    ``census`` to plan from a measured census instead of the estimate;
    ``memory_budget`` (bytes per device) defaults to 90 % of the card's
    memory."""
    if census is None:
        census = estimate_census(model, rt)
    return choose_methods(model, rt, census, memory_budget)


def choose_methods(model, rt: Runtime, census: sparsity.Census,
                   memory_budget: Optional[float] = None) -> Plan:
    """Stage 2: pure census -> Plan (the Table-3 argmin per parameter, its
    placement on the mesh, the memory escalation and the bucket plan). No
    stale table here: the staleness machinery is refused by
    check_ported."""
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
        if method == "fsdp" and mesh is not None:
            pspec = add_fsdp(pspec, spec.shape, mesh, strategy)
        opt_pspec = pspec
        if rt.run_cfg.zero_stage >= 1 and mesh is not None \
                and not spec.sparse:
            opt_pspec = add_fsdp(pspec, spec.shape, mesh, strategy)
        params[name] = ParamPlan(
            name=name, method=method, placement=pspec,
            opt_placement=opt_pspec, wire_dtype=wire, sparse=spec.sparse,
            bytes=int(b), capacity=capacity, est_cost=costs)

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
                    n for n, t in census.tables.items() if t.grown)))

    if mesh is not None:
        # memory escalation: replicate -> ZeRO-1 -> ZeRO-3 (auto-PS)
        for stage in (rt.run_cfg.zero_stage, 1, 3):
            if per_device_bytes(specs, rt.rules,
                                list(plan.params.values())) <= memory_budget:
                break
            plan = _escalate(plan, specs, rt, stage if stage else 1)
        # bucket the dense exchange after the escalation (fsdp vetoes it)
        buckets.plan_buckets(plan, rt)
    for name, spec in specs:
        p = plan.params[name]
        p.held = (held_placement(p.placement, spec.axes,
                                 tuple(rt.batch_axes))
                  if mesh is not None else ())
    return plan


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
    """(state, batch) -> ((loss, metrics), grads) on a mesh: this rank's
    loss of its replica's rows, backward, then every gradient exchanged by
    its plan — the average over the replicas, at its wire dtype."""
    mesh, ba = rt.mesh, tuple(rt.batch_axes)
    n_rep = rt.replicas
    scale = 1.0 / n_rep
    names = list(plan.params)
    own = named_parameters(model)
    bp = plan.bucket_plan
    bucketed = {i for b in bp.buckets for i in b.idx} if bp else set()
    overlap = (buckets.OverlapExchange(bp, [own[n] for n in names], mesh)
               if bp is not None and bp.overlap else None)
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

    def exchange(n: str, g: torch.Tensor):
        p = plan.params[n]
        if p.sparse and p.method in ("ps", "ps_gather", "mpi_gatherv"):
            # pushed and replica-summed by the lookup: only the 1/N
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
        full = {n: coll.all_gather(own[n].detach(), axes, mesh,
                                   dim=d).requires_grad_()
                for n, (d, axes) in gathered.items()}
        deferred = [] if bp is not None and not bp.overlap else None
        rt.deferred_pushes = deferred
        if overlap is not None:
            overlap.begin()
        try:
            loss, metrics = model.loss_fn(batch, params=full)
            loss.backward()
        finally:
            rt.deferred_pushes = None
        done = overlap.finish() if overlap is not None else {}
        local = {n: (full[n].grad if n in full else own[n].grad)
                 for n in names}
        for p in own.values():
            p.grad = None      # the step owns its gradients from here on
        for n, uids, d_rows, vs, ectx in deferred or ():
            # overlap=False: the gatherv pushes, after the backward
            local[n] = embedding.deferred_push(uids, d_rows, vs, ectx).to(
                own[n].dtype)
        grads = {}
        if bp is not None and overlap is None:
            for b in bp.buckets:
                ex = buckets._exchange_bucket(
                    b, [local[names[i]] for i in b.idx], scale, bp, mesh)
                done.update(zip(b.idx, ex))
        for i, n in enumerate(names):
            grads[n] = done[i] if i in bucketed else exchange(n, local[n])
        if bp is None:
            # the reference's global-semantics step casts every f32
            # gradient to its wire dtype (the sparse ones too)
            grads = opsw_cast(grads, plan)
        loss, metrics = buckets.fused_metrics(loss.detach(), metrics, ba,
                                              mesh, n_rep)
        return (loss, metrics), grads

    return value_and_grad


def make_train_step(model, optimizer: Optimizer, rt: Runtime,
                    plan: Plan) -> Callable:
    """(state, batch) -> (state, metrics). ``batch`` holds tensors on the
    model's device (this replica's rows on a mesh)."""

    def value_and_grad(state: TrainState, batch: dict):
        params = state.params
        for p in params.values():
            p.grad = None
        loss, metrics = model.loss_fn(batch)
        loss.backward()
        grads = {n: p.grad for n, p in params.items()}
        for p in params.values():
            p.grad = None      # the step owns its gradients from here on
        return (loss.detach(), metrics), opsw_cast(grads, plan)

    if rt.mesh is not None:
        value_and_grad = _mesh_value_and_grad(model, rt, plan)

    def train_step(state: TrainState, batch: dict):
        (loss, metrics), grads = value_and_grad(state, batch)
        metrics = dict(metrics)
        state, opt_metrics = optimizer.update(state, grads)
        metrics.update(opt_metrics)
        metrics["loss"] = loss
        return state, metrics

    return train_step


def load_params_(model, named: dict) -> None:
    own = named_parameters(model)
    missing = sorted(set(own) - set(named))
    extra = sorted(set(named) - set(own))
    if missing or extra:
        raise ValueError(f"params mismatch: missing {missing}, "
                         f"unexpected {extra}")
    with torch.no_grad():
        for n, p in own.items():
            src = named[n]
            if tuple(src.shape) != tuple(p.shape) or src.dtype != p.dtype:
                raise ValueError(
                    f"{n}: got {src.dtype} {tuple(src.shape)}, want "
                    f"{p.dtype} {tuple(p.shape)}")
            p.copy_(src)


def init_params_(model, seed: int) -> None:
    """Fresh init from ``seed``: one torch.Generator on the model's device,
    drawing each parameter in flatten order (every rank of a mesh draws
    the same whole parameters, then keeps its shards)."""
    gen = torch.Generator(device=model.rt.device)
    gen.manual_seed(seed)
    own = named_parameters(model)
    with torch.no_grad():
        for n, spec in model.param_specs():
            own[n].copy_(init_param(gen, spec, model.rt.param_dtype))


def place_params_(model, plan: Plan, mesh) -> None:
    """Replace each whole parameter of ``model`` by this rank's shard of
    it (``ParamPlan.held``)."""
    whole = {n: p.detach() for n, p in named_parameters(model).items()}
    for n, shard in shard_params(whole, plan, mesh).items():
        if shard.shape == whole[n].shape:
            continue
        *path, attr = n.split(".")
        mod = model.get_submodule(".".join(path))
        setattr(mod, attr, nn.Parameter(shard.clone()))


def build_step(model, optimizer: Optimizer, rt: Runtime, plan: Plan,
               params: Optional[dict] = None, *, seed: int = 0
               ) -> tuple:
    """-> (train step, state). ``params``: {dotted_name: whole tensor} to
    start from (e.g. weights.load_reference_params); None draws a fresh
    init from ``seed``. On a mesh each rank keeps its shards."""
    check_ported(rt.run_cfg, rt.mesh)
    if params is None:
        init_params_(model, seed)
    else:
        load_params_(model, params)
    if rt.mesh is not None:
        for p in plan.params.values():
            if p.opt_placement != p.placement:
                raise NotImplementedError(
                    f"{p.name}: optimizer state sharded apart from its "
                    f"parameter (ZeRO-1, zero_stage {plan.zero_stage}) is "
                    "not ported yet: ROADMAP Queue 1")
        place_params_(model, plan, rt.mesh)
    state = optimizer.init(named_parameters(model))
    return make_train_step(model, optimizer, rt, plan), state


@dataclass
class Runner:
    model: Any
    optimizer: Optimizer
    plan: Plan
    rt: Runtime
    train_step: Callable
    state: TrainState

    def run(self, batch: dict) -> dict:
        """One training step on the global batch (numpy arrays or
        tensors); on a mesh this replica's contiguous rows go in. Returns
        the step's metrics as detached tensors."""
        rt = self.rt
        if rt.mesh is not None and rt.replicas > 1:
            r, n = rt.mesh.index(rt.batch_axes), rt.replicas
            batch = {k: v[len(v) // n * r:len(v) // n * (r + 1)]
                     for k, v in batch.items()}
        batch = {k: torch.as_tensor(v).to(rt.device)
                 for k, v in batch.items()}
        self.state, metrics = self.train_step(self.state, batch)
        return metrics


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
    rt = Runtime(model_cfg, run_cfg, shape_cfg, mesh=mesh, device=device)
    model = build_model(model_cfg, rt)
    plan = analyze(model, rt)
    rt.plan = plan
    optimizer = make_optimizer(rt)
    step, state = build_step(model, optimizer, rt, plan, params, seed=seed)
    return Runner(model=model, optimizer=optimizer, plan=plan, rt=rt,
                  train_step=step, state=state)


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
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Device-side sampling: (B, V) logits -> (B,) int32 token ids. Greedy
    argmax (the first maximum on ties, as ``jnp.argmax``), or a draw from
    softmax(logits / temperature) on ``generator``: a different stream from
    ``jax.random``'s by construction, so only greedy tokens compare."""
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
    are updated in place and returned."""
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
                            generator=generator)               # (1,)
        lb = tokens.shape[1]
        for c, p in zip(cache, kv):
            c[:, slot, :lb] = p[:, 0].to(c.dtype)
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
                            temperature=temperature, generator=generator)
        act = active & (lens > 0)
        tok.copy_(torch.where(act[:, None], nxt[:, None], tok))
        lens.copy_(torch.where(act, torch.clamp(lens + 1, max=max_seq),
                               lens))
        out_tok = torch.where(act, nxt, torch.full_like(nxt, -1))
        return cache, lens, tok, out_tok

    return decode_step
