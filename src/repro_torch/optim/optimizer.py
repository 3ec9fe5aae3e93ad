"""Optimizers with Parallax placement discipline (the port of
``repro/optim/optimizer.py``).

  * Gradient clipping happens AFTER aggregation: the gradients handed to
    ``update`` are already the aggregated ones (this rank's shards), and
    the global norm sums per-parameter partial ‖g‖² in JAX's flatten order
    (the order of the ``params`` dict) — another order changes the last
    bits. On a mesh a sharded leaf's partial is first summed over its
    shards (OPAU: only scalars cross ranks).
  * EMA shadows live beside their parameter, and so do the moments unless
    the plan shards them apart from it (ZeRO-1: ``ParamPlan.opt_held``
    shards one more dimension over the FSDP axes than ``held``). Then the
    update takes this rank's block of the aggregated (and clipped)
    gradient and of the parameter, advances the moments' block, writes the
    parameter's block and all-gathers the parameter over the moments'
    axes (``weights.block_of`` / ``gather_blocks``). Every operation is
    elementwise, so the result is bit-equal to the unsharded update.

Updates run in place under ``torch.no_grad()``: the reference returns new
arrays, the port overwrites the parameters, moments and shadows it is given
(the same values; at the paper's LM width a second copy of the tables and
moments would cost several GB).

Fused bucket-apply: under the bucketed exchange the all-reduced gradient
already exists as one flat buffer per bucket. ``fuse_state`` /
``unfuse_state`` re-lay m/v/EMA as one flat f32 buffer per bucket
(``{"bucket": [buffers], "leaf": {name: tensor, None where bucketed}}``;
the parameters stay per leaf, the model needs them), and
``Optimizer.update_fused`` reads each post-all-reduce buffer against that
layout: one elementwise chain per bucket for the moments, one per leaf
only for the parameter write. It replays ``update`` op for op (the wire ->
parameter dtype -> f32 casts, the norm's partial sums per leaf in the
leaf's own shape and in flatten order, the moments, bias corrections,
weight decay, the parameter write and the EMA), so the two are
bit-identical. ``sgd`` has no fused path.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch

from repro_torch.core import collectives as coll
from repro_torch.core.plan import entry_axes
from repro_torch.weights import (block_of, gather_blocks, gather_tensor,
                                 opt_dims)


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
    # (params, shapes=None) -> TrainState; ``shapes``: {name: moment
    # shape} where the moments are a block of their parameter (ZeRO-1)
    init: Callable[..., TrainState]
    update: Callable[[TrainState, dict], tuple]
    # bucket-native apply: (state, grads, flat post-all-reduce bucket
    # buffers, BucketPlan) -> (state, metrics); None = per-param only
    update_fused: Optional[Callable] = None


# ---------------------------------------------------------------------------
# the fused bucket-apply state layout
# ---------------------------------------------------------------------------

def _is_fused_tree(tree) -> bool:
    return isinstance(tree, dict) and set(tree) == {"bucket", "leaf"}


def is_fused(state: Optional[TrainState]) -> bool:
    """Is this state's optimizer memory in the bucket-fused layout?"""
    return state is not None and _is_fused_tree(state.m)


def bucket_segments(bp) -> dict:
    """leaf index -> (bucket k, offset, size) over the bucketed leaves."""
    out = {}
    for k, b in enumerate(bp.buckets):
        off = 0
        for i, sz in zip(b.idx, b.sizes):
            out[i] = (k, off, sz)
            off += sz
    return out


def fuse_state(state: Optional[TrainState], bp) -> Optional[TrainState]:
    """Per-param -> bucket-fused layout: m/v/EMA become one flat f32
    buffer per bucket, the concatenation of the members' values in bucket
    order; the per-leaf dict keeps the unbucketed leaves and ``None`` at
    the bucketed ones. Exact."""
    if state is None or bp is None or is_fused(state):
        return state
    names = list(state.params)

    def fuse(tree):
        if tree is None:
            return None
        bufs = [torch.cat([tree[names[i]].float().reshape(-1)
                           for i in b.idx]) for b in bp.buckets]
        leaf = dict(tree)
        for b in bp.buckets:
            for i in b.idx:
                leaf[names[i]] = None
        return {"bucket": bufs, "leaf": leaf}

    state.m, state.v, state.ema = (fuse(state.m), fuse(state.v),
                                   fuse(state.ema))
    return state


def unfuse_state(state: Optional[TrainState], bp, *,
                 copy: bool = False) -> Optional[TrainState]:
    """Bucket-fused -> the canonical per-param layout, the exact inverse of
    ``fuse_state`` for the same bucket plan. A new TrainState whose
    bucketed entries are views of the flat buffers (the live memory: an
    in-place write through either layout shows in both), or, with
    ``copy``, tensors of their own: what a replan or a checkpoint carries
    past the flat buffers' lifetime."""
    if state is None or bp is None or not is_fused(state):
        return state
    names = list(state.params)

    def unfuse(tree):
        if not _is_fused_tree(tree):
            return tree
        leaf = dict(tree["leaf"])
        for i, (k, off, sz) in bucket_segments(bp).items():
            n = names[i]
            t = tree["bucket"][k][off:off + sz].view(state.params[n].shape)
            leaf[n] = t.clone() if copy else t
        return leaf

    return TrainState(step=state.step, params=state.params,
                      m=unfuse(state.m), v=unfuse(state.v),
                      ema=unfuse(state.ema), stale=state.stale)


def _wd_segment(b, names: list, weight_decay: float,
                wd_mask: Optional[dict], device=None):
    """Per-bucket weight-decay factor: the per-parameter mask expanded
    over the bucket's member extents (the scalar when there is no mask)."""
    if not wd_mask:
        return weight_decay
    return torch.cat([
        torch.full((sz,), float(weight_decay) * float(wd_mask[names[i]]),
                   dtype=torch.float32, device=device)
        for i, sz in zip(b.idx, b.sizes)])


def _fused_grads(state: TrainState, grads: dict, bufs: list, bp,
                 clip_norm: Optional[float], rt) -> tuple:
    """The per-param path's gradient chain on the flat buffers: each
    buffer cast wire -> parameter dtype -> f32 (the slice-back and the
    update's casts), then clipped. The norm's partials are taken per leaf
    in the leaf's own shape and in flatten order, as ``global_norm`` takes
    them (a flat reduction associates differently), from views of the
    wire buffers: their cast to f32 there is the same (bf16 and f32 only
    widen). -> (``g32(k)``: bucket k's clipped f32 gradient, made when
    asked, so that one bucket's copies live at a time; the unbucketed
    gradients, clipped; metrics)."""
    names = list(state.params)
    seg = bucket_segments(bp)
    pdt = [state.params[names[b.idx[0]]].dtype for b in bp.buckets]
    rest = {n: g for i, (n, g) in enumerate(grads.items()) if i not in seg}
    metrics, scale = {}, None
    if clip_norm is not None:
        leaves = {}
        for i, n in enumerate(names):
            if i in seg:
                k, off, sz = seg[i]
                leaves[n] = bufs[k][off:off + sz].view(state.params[n].shape)
            else:
                leaves[n] = grads[n]
        gnorm = global_norm(leaves, rt)
        scale = _clip_scale(gnorm, clip_norm)
        rest = {n: _clipped(g, scale) for n, g in rest.items()}
        metrics["grad_norm"] = gnorm

    def g32(k: int) -> torch.Tensor:
        g = bufs[k].to(pdt[k]).float()
        return g if scale is None else (g * scale).to(pdt[k]).float()

    return g32, rest, metrics


def _bucket_members(bp, k: int, names: list, params: dict):
    """(name, parameter, offset, size) of bucket k's members."""
    off = 0
    for i, sz in zip(bp.buckets[k].idx, bp.buckets[k].sizes):
        yield names[i], params[names[i]], off, sz
        off += sz


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


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def _clipped(g: torch.Tensor, scale: Optional[torch.Tensor]
             ) -> torch.Tensor:
    return g if scale is None else (g.float() * scale).to(g.dtype)


def clip_by_global_norm(grads: dict, max_norm: float, rt=None) -> tuple:
    norm = global_norm(grads, rt)
    scale = _clip_scale(norm, max_norm)
    return {n: _clipped(g, scale) for n, g in grads.items()}, norm


def _clip(grads: dict, max_norm: Optional[float], rt) -> tuple:
    """-> (the global-norm clip factor, None without clipping; metrics).
    The update scales each gradient as it reaches it (``_clipped``), so
    one leaf's clipped copy lives at a time, not the whole set's."""
    if max_norm is None:
        return None, {}
    norm = global_norm(grads, rt)
    return _clip_scale(norm, max_norm), {"grad_norm": norm}


def _ema_update_(ema: Optional[dict], params: dict, decay: float) -> None:
    if ema is None:
        return
    for n, e in ema.items():
        e.copy_((e.float() * decay
                 + params[n].float() * (1 - decay)).to(e.dtype))


def _ema_fused_(state: TrainState, bp, names: list, decay: float) -> None:
    """``_ema_update_`` on the fused layout: the bucketed shadows are
    slices of one flat buffer per bucket."""
    if state.ema is None:
        return
    for k, buf in enumerate(state.ema["bucket"]):
        for n, p, off, sz in _bucket_members(bp, k, names, state.params):
            e = buf[off:off + sz].view(p.shape)
            e.copy_((e.float() * decay + p.float() * (1 - decay)).to(
                e.dtype))
    _ema_update_({n: e for n, e in state.ema["leaf"].items()
                  if e is not None}, state.params, decay)


def _zeros(params: dict, shapes: Optional[dict]) -> dict:
    """f32 zeros for each parameter's optimizer state: its own shape, or
    ``shapes[name]`` (this rank's block under ZeRO-1)."""
    shapes = shapes or {}
    return {n: torch.zeros(shapes.get(n, p.shape), dtype=torch.float32,
                           device=p.device) for n, p in params.items()}


def _opt_dims(rt) -> dict:
    """{name: ``weights.opt_dims``} of the leaves whose optimizer state is
    a block of their parameter under the live plan (empty off a mesh)."""
    if rt is None or rt.mesh is None or rt.plan is None:
        return {}
    out = {}
    for n, p in rt.plan.params.items():
        dims = opt_dims(p.held, p.opt_held, rt.mesh)
        if dims:
            out[n] = dims
    return out


def _apply_leaf_(p: torch.Tensor, g: torch.Tensor, dims: Optional[list],
                 mesh, fn: Callable) -> None:
    """``fn(param, grad)`` writes the parameter in place from its
    gradient and its (already block-shaped) optimizer state. Under ZeRO-1
    (``dims``) it runs on this rank's block of both, and the written
    blocks are all-gathered back into the whole parameter."""
    if not dims:
        fn(p, g)
        return
    blk = block_of(p, dims, mesh).clone()
    fn(blk, block_of(g, dims, mesh))
    p.copy_(gather_blocks(blk, dims, mesh))


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

    def init(params: dict, shapes: Optional[dict] = None) -> TrainState:
        zeros = _zeros(params, shapes)
        return TrainState(
            step=0, params=params, m=zeros,
            v={n: torch.zeros_like(z) for n, z in zeros.items()},
            ema=_ema_init(params, ema_decay))

    def corrections(step: int) -> tuple:
        # bias corrections in f32, as the reference computes them
        t = torch.tensor(step, dtype=torch.float32)
        f32 = lambda x: torch.tensor(x, dtype=torch.float32)
        return (_f32_scalar(1.0 - f32(b1) ** t),
                _f32_scalar(1.0 - f32(b2) ** t))

    def moments_(m: torch.Tensor, v: torch.Tensor, g32: torch.Tensor,
                 bc1: float, bc2: float) -> torch.Tensor:
        """m, v advanced in place; -> the Adam direction."""
        m.mul_(b1).add_(g32 * (1 - b1))
        v.mul_(b2).add_(torch.square(g32).mul_(1 - b2))
        # the reference's (m / bc1) / (sqrt(v / bc2) + eps), its
        # temporaries reused
        return (m / bc1).div_(torch.sqrt(v / bc2).add_(eps))

    def write_(p: torch.Tensor, upd32: torch.Tensor, lr_t, wd) -> None:
        if weight_decay:
            upd32 = upd32 + wd * p.float()
        p.copy_((p.float() - lr_t * upd32).to(p.dtype))

    def wd_of(n: str) -> float:
        return weight_decay * (1.0 if wd_mask is None else float(wd_mask[n]))

    @torch.no_grad()
    def update(state: TrainState, grads: dict) -> tuple:
        scale, metrics = _clip(grads, clip_norm, rt)
        step = state.step + 1
        bc1, bc2 = corrections(step)
        lr_t = lr_fn(step)
        zero = _opt_dims(rt)
        for n, p in state.params.items():
            leaf_(n, p, _clipped(grads[n], scale), state.m[n], state.v[n],
                  bc1, bc2, lr_t, zero.get(n))
        _ema_update_(state.ema, state.params, ema_decay)
        state.step = step
        return state, metrics

    def leaf_(n, p, g, m, v, bc1, bc2, lr_t, dims) -> None:
        """One leaf's moments and parameter (a block of them under
        ZeRO-1)."""
        def fn(pt, gt):
            write_(pt, moments_(m, v, gt.float(), bc1, bc2), lr_t, wd_of(n))
        _apply_leaf_(p, g, dims, rt.mesh if dims else None, fn)

    @torch.no_grad()
    def update_fused(state: TrainState, grads: dict, bufs: list,
                     bp) -> tuple:
        """Bucket-native adamw: each all-reduced flat buffer drives one
        moment chain against the fused m/v buffers; the unbucketed leaves
        (the sparse tables' pushed gradients) walk the per-leaf path."""
        names = list(state.params)
        g32, rest, metrics = _fused_grads(state, grads, bufs, bp,
                                          clip_norm, rt)
        step = state.step + 1
        bc1, bc2 = corrections(step)
        lr_t = lr_fn(step)
        # bucket by bucket: one bucket's f32 gradient and update at a time
        for k, b in enumerate(bp.buckets):
            upd = moments_(state.m["bucket"][k], state.v["bucket"][k],
                           g32(k), bc1, bc2)
            wd_seg = _wd_segment(b, names, weight_decay, wd_mask,
                                 upd.device) if weight_decay else 0.0
            for n, p, off, sz in _bucket_members(bp, k, names,
                                                 state.params):
                wd = wd_seg
                if isinstance(wd, torch.Tensor):
                    wd = wd[off:off + sz].view(p.shape)
                write_(p, upd[off:off + sz].view(p.shape), lr_t, wd)
            del upd
        zero = _opt_dims(rt)
        for n, g in rest.items():
            leaf_(n, state.params[n], g, state.m["leaf"][n],
                  state.v["leaf"][n], bc1, bc2, lr_t, zero.get(n))
        _ema_fused_(state, bp, names, ema_decay)
        state.step = step
        return state, metrics

    return Optimizer("adamw", init, update, update_fused)


def momentum(lr: float | Callable = 1e-2, mu: float = 0.9,
             clip_norm: Optional[float] = None,
             ema_decay: float = 0.0, rt=None) -> Optimizer:
    lr_fn = lr if callable(lr) else (lambda step: lr)

    def init(params: dict, shapes: Optional[dict] = None) -> TrainState:
        return TrainState(step=0, params=params, m=_zeros(params, shapes),
                          v=None, ema=_ema_init(params, ema_decay))

    def write_(p: torch.Tensor, m: torch.Tensor, lr_t) -> None:
        p.copy_((p.float() - lr_t * m).to(p.dtype))

    def leaf_(p, g, m, lr_t, dims) -> None:
        """One leaf's buffer and parameter (a block of them under
        ZeRO-1)."""
        def fn(pt, gt):
            m.mul_(mu).add_(gt.float())
            write_(pt, m, lr_t)
        _apply_leaf_(p, g, dims, rt.mesh if dims else None, fn)

    @torch.no_grad()
    def update(state: TrainState, grads: dict) -> tuple:
        scale, metrics = _clip(grads, clip_norm, rt)
        step = state.step + 1
        lr_t = lr_fn(step)
        zero = _opt_dims(rt)
        for n, p in state.params.items():
            leaf_(p, _clipped(grads[n], scale), state.m[n], lr_t,
                  zero.get(n))
        _ema_update_(state.ema, state.params, ema_decay)
        state.step = step
        return state, metrics

    @torch.no_grad()
    def update_fused(state: TrainState, grads: dict, bufs: list,
                     bp) -> tuple:
        names = list(state.params)
        g32, rest, metrics = _fused_grads(state, grads, bufs, bp,
                                          clip_norm, rt)
        step = state.step + 1
        lr_t = lr_fn(step)
        for k, m in enumerate(state.m["bucket"]):
            m.mul_(mu).add_(g32(k))
            for n, p, off, sz in _bucket_members(bp, k, names,
                                                 state.params):
                write_(p, m[off:off + sz].view(p.shape), lr_t)
        zero = _opt_dims(rt)
        for n, g in rest.items():
            leaf_(state.params[n], g, state.m["leaf"][n], lr_t, zero.get(n))
        _ema_fused_(state, bp, names, ema_decay)
        state.step = step
        return state, metrics

    return Optimizer("momentum", init, update, update_fused)


def sgd(lr: float | Callable = 1e-2,
        clip_norm: Optional[float] = None, rt=None) -> Optimizer:
    lr_fn = lr if callable(lr) else (lambda step: lr)

    def init(params: dict, shapes: Optional[dict] = None) -> TrainState:
        return TrainState(step=0, params=params, m=None, v=None, ema=None)

    @torch.no_grad()
    def update(state: TrainState, grads: dict) -> tuple:
        scale, metrics = _clip(grads, clip_norm, rt)
        step = state.step + 1
        lr_t = lr_fn(step)
        for n, p in state.params.items():
            g = _clipped(grads[n], scale)
            p.copy_((p.float() - lr_t * g.float()).to(p.dtype))
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
