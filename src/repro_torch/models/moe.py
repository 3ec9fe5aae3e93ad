"""Mixture-of-Experts with sort-based capacity dispatch (the port of
``repro/models/moe.py``).

Expert FFNs are sparse parameters in the Parallax sense: each token touches
k of E experts (α = k/E). Two executions, as in the reference:

  ep  experts sharded over ``model`` (E/M on each rank); the dispatched
      tokens travel to their experts' owners and back by ``all_to_all``
      (core/collectives.py), the PS push/pull pattern applied to
      activations. Picked when the model axis divides the expert count.
  tp  every expert on every rank, its d_ff sharded over ``model``
      ((E, D, F/M) and (E, F/M, D) a rank): every model rank routes the
      same tokens (dispatch and capacity computed identically), runs its
      d_ff block of every expert, and the expert outputs are summed over
      ``model`` before the gates combine them, as the reference's
      ``psum(ys, model)``. ``moe_aux`` and ``moe_dropped`` are each model
      rank's own, equal on all of them, so they are not summed over
      ``model``. Under ``dp`` (the rules leave d_ff whole) the experts
      are whole. The shared expert runs tensor-parallel over ``model`` as
      the dense MLP does.

Dispatch is sort-based (a stable argsort by expert id, then each slot's
position within its expert against the capacity), bit for bit the
reference's, so ``moe_dropped`` is the same integer. Top-k breaks ties
toward the lower expert index, as ``jax.lax.top_k`` does (``torch.topk``
does not). Tokens run in groups of ``group_tokens``, the reference's
``lax.map``.

The reference runs ``moe_ffn`` on a mesh as a ``shard_map``; the port runs
it per rank, each rank holding its replica's whole activation (the
residual stream is whole on every model rank), with the autograd pairing
that gives each rank the gradient of its replica:

  * ep with the sequence divisible by M: each model rank routes its own
    s/M slice of the sequence (the capacity is that slice's), and the
    output is gathered back over ``model`` (``gather_from``: the backward
    takes this rank's slice). The router saw only this rank's slice, so
    its gradient is summed over ``model`` (``copy_to``), as is the input's.
  * ep otherwise: every model rank routes the same tokens and each owner
    runs M copies of them; its experts' gradients come back M times and
    are scaled by 1/M.
  * aux is averaged and dropped summed over the token axes inside
    ``moe_ffn``, so the step's averaging of metrics over the replicas
    leaves them equal to the reference's.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import collectives as coll
from repro_torch.models.layers import ParamSpec, swiglu


def moe_specs(cfg, exec_mode: str) -> dict:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    if exec_mode == "ep":
        axes_in = ("experts", None, None)
        axes_out = ("experts", None, None)
    else:
        axes_in = (None, None, "mlp")
        axes_out = (None, "mlp", None)
    specs = {
        "router": ParamSpec((d, e), (None, None), scale=0.02),
        "w_gate": ParamSpec((e, d, f), axes_in, fan_in_axes=(1,)),
        "w_up": ParamSpec((e, d, f), axes_in, fan_in_axes=(1,)),
        "w_down": ParamSpec((e, f, d), axes_out, fan_in_axes=(1,)),
    }
    if cfg.shared_expert:
        specs["shared_gate"] = ParamSpec((d, f), (None, "mlp"),
                                         fan_in_axes=(0,))
        specs["shared_up"] = ParamSpec((d, f), (None, "mlp"),
                                       fan_in_axes=(0,))
        specs["shared_down"] = ParamSpec((f, d), ("mlp", None),
                                         fan_in_axes=(0,))
    return specs


def top_k(probs: torch.Tensor, k: int) -> tuple:
    """(values, indices) of the k largest entries of each row, ties to the
    lower index (``jax.lax.top_k``'s order): a stable descending sort."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _dispatch_indices(eids: torch.Tensor, n_experts: int,
                      capacity: int) -> tuple:
    """Sort-based dispatch. eids: (T, k).

    Returns (slot_dest (T, k): a flat index into an E*C+1 buffer, E*C for
    a dropped slot; the number of dropped slots)."""
    t, k = eids.shape
    flat_e = eids.reshape(-1)                                  # (T*k,)
    sorted_e, order = torch.sort(flat_e, stable=True)
    # position of each routed slot within its expert
    experts = torch.arange(n_experts, device=eids.device,
                           dtype=sorted_e.dtype)
    start = torch.searchsorted(sorted_e, experts, side="left")
    pos = torch.arange(t * k, device=eids.device) - start[sorted_e]
    keep = pos < capacity
    dest_sorted = torch.where(keep, sorted_e * capacity + pos,
                              torch.full_like(pos, n_experts * capacity))
    # scatter back to slot order
    dest = torch.empty_like(dest_sorted)
    dest[order] = dest_sorted
    return dest.reshape(t, k), (~keep).sum()


def _expert_ffn(xs: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
                w_down: torch.Tensor, compute_dtype) -> torch.Tensor:
    """xs: (E, C, D); w: (E, D, F) / (E, F, D)."""
    xs = xs.to(compute_dtype)
    h = F.silu(torch.bmm(xs, w_gate.to(compute_dtype)))
    h = h * torch.bmm(xs, w_up.to(compute_dtype))
    return torch.bmm(h, w_down.to(compute_dtype))


def _moe_group(flat: torch.Tensor, router_w, w_gate, w_up, w_down, *, e: int,
               k: int, cf: float, exec_mode: str, mesh, m: int,
               compute_dtype, tp: bool = False) -> tuple:
    """One token group on this rank. flat: (T, D). ``tp``: the experts
    are this rank's d_ff block; the dispatched tokens reach them through
    ``copy_to`` and their partial outputs are summed over ``model``
    before the gates combine them (the reference's ``psum(ys)``)."""
    t, d = flat.shape
    cap = max(int(t * k * cf / e) + 1, 4)
    logits = (flat @ router_w.to(flat.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    gates, eids = top_k(probs, k)                              # (T, k)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    dest, dropped = _dispatch_indices(eids, e, cap)

    # the kept destinations are unique: each kept row receives one slot;
    # the dropped ones all land on the last row, which is cut off
    buf = flat.new_zeros((e * cap + 1, d))
    src = flat if not tp else coll.copy_to(flat, "model", mesh)
    xs = buf.index_add(0, dest.reshape(-1),
                       src.repeat_interleave(k, dim=0))[:-1]
    xs = xs.reshape(e, cap, d)

    if exec_mode == "ep" and m > 1:
        e_loc = e // m
        xs = coll.all_to_all(xs.reshape(m, e_loc, cap, d), "model", mesh)
        # (M, E_loc, C, D): peer i's tokens for this rank's experts
        xs = xs.transpose(0, 1).reshape(e_loc, m * cap, d)
        ys = _expert_ffn(xs, w_gate, w_up, w_down, compute_dtype)
        ys = ys.reshape(e_loc, m, cap, d).transpose(0, 1)
        ys = coll.all_to_all(ys, "model", mesh)
        ys = ys.reshape(e, cap, d)
    else:
        ys = _expert_ffn(xs, w_gate, w_up, w_down, compute_dtype)
        if tp:
            ys = coll.reduce_from(ys, "model", mesh)

    ys_pad = torch.cat([ys.reshape(e * cap, d), ys.new_zeros((1, d))], 0)
    picked = ys_pad[dest.reshape(-1)].reshape(t, k, d)
    out = torch.sum(picked * gates[..., None].to(picked.dtype), dim=1)

    # GShard load-balance aux (top-1 fraction x mean prob)
    top1 = eids[:, :1] == torch.arange(e, device=eids.device)
    frac = top1.float().mean(dim=0)
    aux = e * torch.sum(frac * probs.mean(dim=0))
    return out.to(flat.dtype), aux, dropped


class _ScaleGrad(torch.autograd.Function):
    """Identity forward; the gradient times ``scale``."""

    @staticmethod
    def forward(fctx, x, scale):
        fctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(fctx, g):
        return g * fctx.scale, None


class _TokenMean(torch.autograd.Function):
    """The sum over the token axes divided by their size (the reference's
    ``psum(aux) / n``). The backward hands this rank's term ``1 / share``
    of the gradient: its part of its replica's mean (``share`` is the
    number of model ranks that split the replica's tokens)."""

    @staticmethod
    def forward(fctx, x, axes, mesh, n, share):
        fctx.share = share
        return coll.all_reduce(x, axes, mesh) / n

    @staticmethod
    def backward(fctx, g):
        return g / fctx.share, None, None, None, None


def moe_ffn(params: dict, x: torch.Tensor, *, cfg, rt, exec_mode: str,
            group_tokens: int = 8192) -> tuple:
    """x: (B, S, D) -> (B, S, D), metrics {moe_aux, moe_dropped}."""
    b, s, d = x.shape
    e, k, cf = cfg.n_experts, cfg.experts_per_token, cfg.moe_capacity_factor
    mesh = rt.mesh
    model_axis = "model" if (mesh is not None
                             and "model" in mesh.axis_names) else None
    m = mesh.shape[model_axis] if model_axis else 1
    if exec_mode == "ep" and (m <= 1 or e % m != 0
                              or model_axis in rt.batch_axes):
        # under dp the model axis carries batch: the experts are whole
        exec_mode = "tp"
    seq_shardable = exec_mode == "ep" and s % m == 0
    # tensor-parallel where this rank holds a block of the experts' d_ff
    tp = exec_mode == "tp" and params["w_gate"].shape[-1] < cfg.d_ff

    router = params["router"]
    experts = [params["w_gate"], params["w_up"], params["w_down"]]
    x_loc = x
    if seq_shardable:
        # this rank's slice of the sequence; the router and the input
        # see only it, so their gradients are summed over the model axis
        sl, r = s // m, mesh.index(model_axis)
        x_loc = coll.copy_to(x, model_axis, mesh)[:, r * sl:(r + 1) * sl]
        router = coll.copy_to(router, model_axis, mesh)
    elif exec_mode == "ep":
        # each owner runs the same tokens once for every model rank
        experts = [_ScaleGrad.apply(w, 1.0 / m) for w in experts]

    flat = x_loc.reshape(-1, d)
    t = flat.shape[0]
    g = max(min(group_tokens, t), 1)
    n_groups = (t + g - 1) // g
    if t % g != 0:
        flat = F.pad(flat, (0, 0, 0, n_groups * g - t))
    runs = [_moe_group(flat[i * g:(i + 1) * g], router, *experts, e=e, k=k,
                       cf=cf, exec_mode=exec_mode, mesh=mesh, m=m,
                       compute_dtype=rt.dtype, tp=tp)
            for i in range(n_groups)]
    if n_groups == 1:
        out, aux, dropped = runs[0]
    else:
        out = torch.cat([r[0] for r in runs], 0)
        aux = torch.stack([r[1] for r in runs]).mean()
        dropped = torch.stack([r[2] for r in runs]).sum()
    out = out[:t].reshape(x_loc.shape)
    if mesh is not None and rt.shape_cfg.kind != "decode":
        # (a serve mesh's prefill runs on one replica: its metrics stay
        # that replica's)
        token_axes = tuple(rt.batch_axes) + \
            ((model_axis,) if seq_shardable else ())
        if token_axes:
            aux = _TokenMean.apply(aux, token_axes, mesh,
                                   mesh.axes_size(token_axes),
                                   m if seq_shardable else 1)
            dropped = coll.all_reduce(dropped, token_axes, mesh)
    if seq_shardable:
        out = coll.gather_from(out, model_axis, mesh, dim=1)

    metrics = {"moe_aux": aux, "moe_dropped": dropped}
    if cfg.shared_expert:
        # beside the routed experts, on every token (the whole activation
        # on every rank: its gradient is whole too), tensor-parallel over
        # model where the plan shards its d_ff
        tp = params["shared_gate"].shape[-1] < cfg.d_ff
        shared = swiglu(x, params["shared_gate"], params["shared_up"],
                        params["shared_down"], mesh=mesh if tp else None)
        out = out + shared.to(out.dtype)
    return out, metrics


def pick_exec_mode(cfg, rt) -> str:
    if rt.run_cfg.moe_exec in ("ep", "tp"):
        return rt.run_cfg.moe_exec
    m = rt.rules.axis_size("experts")
    if m > 1 and cfg.n_experts % m == 0:
        return "ep"
    return "tp"
