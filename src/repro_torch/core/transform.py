"""The Parallax API, single device (the port of ``repro/core/transform.py``).

``estimate_census``  workload-model census (uniform/Zipf analytic α).
``choose_methods``   census -> Plan via the Table-3 cost model.
``analyze``          the composition of the two.
``make_train_step``  (state, batch) -> (state, metrics): loss, backward
                     through the PS pull/push, the OPSW wire cast, the
                     optimizer (clipping after aggregation).
``build_step``       model + optimizer + plan -> (step, state).
``make_serve_prefill_step`` / ``make_serve_decode_step``
                     the serving engine's batched prefill and slot-paged
                     decode (runtime/server.py).
``get_runner``       the user-facing two-line API (paper Table 2):

    runner = get_runner(get_config("parallax-lm"), shape, RunConfig())
    metrics = runner.run(ds.batch(i))

Everything runs on ``device`` (default: the card). Over a mesh
(``mesh is not None``) the exchange and the bucketed all-reduce come with
ROADMAP slice 2; ``Runner.replan`` and the replan loop with slice 3.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch

from repro_torch.configs.base import ModelConfig, RunConfig, ShapeConfig
from repro_torch.core import cost_model, sparsity
from repro_torch.core.plan import ParamPlan, Plan
from repro_torch.core.runtime import Runtime, check_ported
from repro_torch.models.layers import flatten_specs, init_param
from repro_torch.models.model import build_model
from repro_torch.optim.optimizer import Optimizer, TrainState, make_optimizer
from repro_torch.utils.dtypes import torch_dtype
from repro_torch.utils.tree import named_parameters


def _mesh_dims(rt: Runtime) -> cost_model.MeshDims:
    return cost_model.MeshDims()        # one device: every count is 1


def estimate_census(model, rt: Runtime) -> sparsity.Census:
    """Stage 1: the build-time workload-model census (estimated α)."""
    return sparsity.run_census(model.specs(), rt.model_cfg, rt.shape_cfg,
                               rt.run_cfg, _mesh_dims(rt).replicas)


def analyze(model, rt: Runtime,
            census: Optional[sparsity.Census] = None) -> Plan:
    """Census + cost model -> Plan (the paper's analysis phase). Pass
    ``census`` to plan from a measured census instead of the estimate."""
    if census is None:
        census = estimate_census(model, rt)
    return choose_methods(model, rt, census)


def choose_methods(model, rt: Runtime, census: sparsity.Census) -> Plan:
    """Stage 2: pure census -> Plan (the Table-3 argmin per parameter).
    On one device there is no memory escalation (ZeRO), no bucket plan and
    no stale table (the staleness machinery is refused by check_ported)."""
    check_ported(rt.run_cfg, rt.mesh)
    dims = _mesh_dims(rt)
    hw = cost_model.resolve_hw(rt.run_cfg)
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

    params = {}
    for name, spec in flatten_specs(model.specs()):
        b = math.prod(spec.shape) * pbytes
        alpha = census.alpha_for(name) if spec.sparse else census.alpha
        method, costs = cost_model.choose_method(
            b=b, sparse=spec.sparse, alpha=alpha, dims=dims,
            comm_mode=rt.run_cfg.comm_mode, can_shard_rows=False, hw=hw)
        capacity = 0
        wire = wire_for(name)
        if spec.sparse:
            capacity = census.capacity_for(name)
            table_methods[name] = "dense"       # one device: no exchange
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
        params[name] = ParamPlan(
            name=name, method=method, placement=None,
            wire_dtype=wire, sparse=spec.sparse, bytes=int(b),
            capacity=capacity, est_cost=costs)

    embed_method = table_methods.get(
        "embed", next(iter(table_methods.values()), "dense"))
    return Plan(model_cfg=rt.model_cfg, run_cfg=rt.run_cfg,
                shape_cfg=rt.shape_cfg, params=params,
                alpha=census.alpha, capacity=census.capacity,
                embed_method=embed_method,
                table_methods=table_methods, table_capacity=table_capacity,
                table_wire=table_wire, table_alpha=table_alpha,
                table_serve=table_serve,
                grown_tables=tuple(sorted(
                    n for n, t in census.tables.items() if t.grown)))


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


def make_train_step(model, optimizer: Optimizer, rt: Runtime,
                    plan: Plan) -> Callable:
    """(state, batch) -> (state, metrics). ``batch`` holds tensors on the
    model's device."""

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
    drawing each parameter in flatten order."""
    gen = torch.Generator(device=model.rt.device)
    gen.manual_seed(seed)
    own = named_parameters(model)
    with torch.no_grad():
        for n, spec in model.param_specs():
            own[n].copy_(init_param(gen, spec, model.rt.param_dtype))


def build_step(model, optimizer: Optimizer, rt: Runtime, plan: Plan,
               params: Optional[dict] = None, *, seed: int = 0
               ) -> tuple:
    """-> (train step, state). ``params``: {dotted_name: tensor} to start
    from (e.g. weights.load_reference_params); None draws a fresh init
    from ``seed``."""
    check_ported(rt.run_cfg, rt.mesh)
    if params is None:
        init_params_(model, seed)
    else:
        load_params_(model, params)
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
        """One training step on a batch of numpy arrays (or tensors);
        returns the step's metrics as detached tensors."""
        dev = self.rt.device
        batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        self.state, metrics = self.train_step(self.state, batch)
        return metrics


def get_runner(model_cfg: ModelConfig, shape_cfg: ShapeConfig,
               run_cfg: RunConfig = RunConfig(), mesh: Any = None,
               seed: int = 0, *, device=None,
               params: Optional[dict] = None) -> Runner:
    """Transform a single-device model into a runner on ``device`` (default:
    the card). ``params`` overrides the seeded init."""
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
