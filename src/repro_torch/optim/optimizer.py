"""Optimizers with Parallax placement discipline (the port of the
per-parameter paths of ``repro/optim/optimizer.py``).

  * Gradient clipping happens AFTER aggregation: the gradients handed to
    ``update`` are already the aggregated ones (this rank's shards), and
    the global norm sums per-parameter partial ‖g‖² in JAX's flatten order
    (the order of the ``params`` dict) — another order changes the last
    bits. On a mesh a sharded leaf's partial is first summed over its
    shards (OPAU: only scalars cross ranks).
  * Moments and EMA shadows live beside their parameter.

Updates run in place under ``torch.no_grad()``: the reference returns new
arrays, the port overwrites the parameters, moments and shadows it is given
(the same values; at the paper's LM width a second copy of the tables and
moments would cost several GB). The fused bucket-apply path
(``update_fused``) comes with ROADMAP slice 2 item 8.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch

from repro_torch.core import collectives as coll
from repro_torch.core.plan import entry_axes
from repro_torch.weights import gather_tensor


@dataclass
class TrainState:
    step: int
    params: dict                # name -> parameter, in flatten order
    m: Optional[dict]           # first moment / momentum (None for sgd)
    v: Optional[dict]           # second moment (None for sgd/momentum)
    ema: Optional[dict]         # EMA shadow params (None if disabled)
    stale: Any = None           # bounded-staleness buffers (slice 7)


@dataclass(frozen=True)
class Optimizer:
    name: str
    init: Callable[[dict], TrainState]
    update: Callable[[TrainState, dict], tuple]


def _f32_scalar(x: torch.Tensor) -> float:
    """A 0-d f32 result as a Python float (exactly the f32 value)."""
    return float(x.to(torch.float32).item())


def _held_axes(held: tuple, mesh) -> tuple:
    """The mesh axes (of size > 1) a held placement shards over."""
    return tuple(a for a in mesh.axis_names
                 if mesh.shape[a] > 1
                 and any(a in entry_axes(e) for e in held))


def global_norm(grads: dict, rt=None) -> torch.Tensor:
    """sqrt of the per-parameter ‖g‖² partial sums, in dict order.

    On a mesh (OPAU) each sharded leaf's partial is summed over the axes
    it is sharded on — one all-reduce per group of leaves sharing those
    axes, only scalars on the wire — and a replicated leaf counts once.
    With ``opau=False`` the sharded gradients are gathered whole first,
    the naive placement the reference forces with a replicated
    constraint."""
    mesh = rt.mesh if rt is not None else None
    held = ({n: p.held for n, p in rt.plan.params.items()}
            if mesh is not None else {})
    axes = {n: _held_axes(held[n], mesh) if n in held else ()
            for n in grads}
    if mesh is not None and not rt.run_cfg.opau:
        grads = {n: gather_tensor(g, held[n], mesh) if axes[n] else g
                 for n, g in grads.items()}
        axes = {n: () for n in grads}
    parts = {n: torch.sum(torch.square(g.float())) for n, g in grads.items()}
    groups: dict = {}
    for n, a in axes.items():
        if a:
            groups.setdefault(a, []).append(n)
    for a, names in groups.items():
        summed = coll.all_reduce(torch.stack([parts[n] for n in names]), a, mesh)
        for j, n in enumerate(names):
            parts[n] = summed[j]
    total = 0
    for p in parts.values():
        total = total + p
    return torch.sqrt(total)


def clip_by_global_norm(grads: dict, max_norm: float, rt=None) -> tuple:
    norm = global_norm(grads, rt)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return ({n: (g.float() * scale).to(g.dtype) for n, g in grads.items()},
            norm)


def _ema_update_(ema: Optional[dict], params: dict, decay: float) -> None:
    if ema is None:
        return
    for n, e in ema.items():
        e.copy_((e.float() * decay
                 + params[n].float() * (1 - decay)).to(e.dtype))


def _ema_init(params: dict, ema_decay: float) -> Optional[dict]:
    if ema_decay <= 0:
        return None
    return {n: p.detach().to(torch.float32, copy=True)
            for n, p in params.items()}


def adamw(lr: float | Callable = 1e-3, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.0,
          clip_norm: Optional[float] = 1.0, ema_decay: float = 0.0,
          wd_mask: Optional[dict] = None, rt=None) -> Optimizer:
    """``wd_mask``: optional {name: float} multiplying ``weight_decay``
    per parameter (0.0 = no decay for that parameter)."""
    lr_fn = lr if callable(lr) else (lambda step: lr)

    def init(params: dict) -> TrainState:
        zeros = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                 for n, p in params.items()}
        return TrainState(
            step=0, params=params, m=zeros,
            v={n: torch.zeros_like(z) for n, z in zeros.items()},
            ema=_ema_init(params, ema_decay))

    @torch.no_grad()
    def update(state: TrainState, grads: dict) -> tuple:
        metrics = {}
        if clip_norm is not None:
            grads, gnorm = clip_by_global_norm(grads, clip_norm, rt)
            metrics["grad_norm"] = gnorm
        step = state.step + 1
        # bias corrections in f32, as the reference computes them
        t = torch.tensor(step, dtype=torch.float32)
        f32 = lambda x: torch.tensor(x, dtype=torch.float32)
        bc1 = _f32_scalar(1.0 - f32(b1) ** t)
        bc2 = _f32_scalar(1.0 - f32(b2) ** t)
        lr_t = lr_fn(step)
        for n, p in state.params.items():
            g32 = grads[n].float()
            m, v = state.m[n], state.v[n]
            m.mul_(b1).add_(g32 * (1 - b1))
            v.mul_(b2).add_(torch.square(g32) * (1 - b2))
            upd32 = (m / bc1) / (torch.sqrt(v / bc2) + eps)
            if weight_decay:
                wdm = 1.0 if wd_mask is None else float(wd_mask[n])
                upd32 = upd32 + (weight_decay * wdm) * p.float()
            p.copy_((p.float() - lr_t * upd32).to(p.dtype))
        _ema_update_(state.ema, state.params, ema_decay)
        state.step = step
        return state, metrics

    return Optimizer("adamw", init, update)


def momentum(lr: float | Callable = 1e-2, mu: float = 0.9,
             clip_norm: Optional[float] = None,
             ema_decay: float = 0.0, rt=None) -> Optimizer:
    lr_fn = lr if callable(lr) else (lambda step: lr)

    def init(params: dict) -> TrainState:
        return TrainState(
            step=0, params=params,
            m={n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for n, p in params.items()},
            v=None, ema=_ema_init(params, ema_decay))

    @torch.no_grad()
    def update(state: TrainState, grads: dict) -> tuple:
        metrics = {}
        if clip_norm is not None:
            grads, gnorm = clip_by_global_norm(grads, clip_norm, rt)
            metrics["grad_norm"] = gnorm
        step = state.step + 1
        lr_t = lr_fn(step)
        for n, p in state.params.items():
            m = state.m[n]
            m.mul_(mu).add_(grads[n].float())
            p.copy_((p.float() - lr_t * m).to(p.dtype))
        _ema_update_(state.ema, state.params, ema_decay)
        state.step = step
        return state, metrics

    return Optimizer("momentum", init, update)


def sgd(lr: float | Callable = 1e-2,
        clip_norm: Optional[float] = None, rt=None) -> Optimizer:
    lr_fn = lr if callable(lr) else (lambda step: lr)

    def init(params: dict) -> TrainState:
        return TrainState(step=0, params=params, m=None, v=None, ema=None)

    @torch.no_grad()
    def update(state: TrainState, grads: dict) -> tuple:
        metrics = {}
        if clip_norm is not None:
            grads, gnorm = clip_by_global_norm(grads, clip_norm, rt)
            metrics["grad_norm"] = gnorm
        step = state.step + 1
        lr_t = lr_fn(step)
        for n, p in state.params.items():
            p.copy_((p.float() - lr_t * grads[n].float()).to(p.dtype))
        state.step = step
        return state, metrics

    return Optimizer("sgd", init, update)


def make_optimizer(rt) -> Optimizer:
    rc = rt.run_cfg
    if rc.optimizer == "adamw":
        return adamw(rc.learning_rate, weight_decay=rc.weight_decay,
                     clip_norm=rc.clip_norm, ema_decay=rc.ema_decay, rt=rt)
    if rc.optimizer == "momentum":
        return momentum(rc.learning_rate, clip_norm=rc.clip_norm,
                        ema_decay=rc.ema_decay, rt=rt)
    if rc.optimizer == "sgd":
        return sgd(rc.learning_rate, clip_norm=rc.clip_norm, rt=rt)
    raise ValueError(f"unknown optimizer {rc.optimizer!r}")
