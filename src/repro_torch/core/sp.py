"""Explicit sequence-parallel block collectives (the port of
``repro/core/sp.py``, ``RunConfig.explicit_sp``).

Between the blocks the residual stream is sequence-sharded over ``model``
(B, S/M, D) on each rank; inside a block the projections run
tensor-parallel (Megatron-SP):

  proj_in    all-gather the sequence-sharded activation once per block
             half (at the wire dtype), then local matmuls against every
             weight (column-sharded or replicated); the backward
             reduce-scatters d_x.
  proj_out   local matmul against a row-sharded weight, then
             reduce-scatter the partial outputs back to the sequence
             shards; the backward all-gathers d_out.
  local_proj for replicated weights (GQA's K/V): a sequence-local matmul,
             then an all-gather of the (small) output, in place of the
             m-fold redundant full-sequence matmul.

``proj_in`` and ``local_proj`` are ``torch.autograd.Function``s with the
reference's manual transposes (the transpose of the all-gather is the
reduce-scatter, and the reverse; the backward recomputes the gather rather
than keep the gathered activation). ``proj_out`` is the local matmul under
``collectives.reduce_scatter_ag``, whose autograd transpose is the
reference's. Two departures, both for the port's per-rank autograd:

  * The reference sums each weight gradient over the batch axes inside the
    backward (the dense exchange, ``psum(d_w, batch_axes)``). The port's
    step already exchanges every gradient over the batch axes
    (core/transform.py, core/buckets.py), so nothing here sums over them.
  * The cotangent reaching ``local_proj`` is each rank's partial sum (the
    attention reads K/V only through this rank's q heads), so its
    reduce-scatter is the whole cotangent's block, and the weight gradient
    is summed over ``model``. The reference hands ``local_proj`` the whole
    cotangent on every shard and reduce-scatters m copies of it (ROADMAP
    Queue 3). ``proj_in``'s replicated outputs get their whole cotangent
    (the attention block's ``copy_to``), as the reference's do, so it
    keeps the reference's 1/m.

Activations ride ``rt.wire_dtype`` on the wire, as in the reference.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from repro_torch.core import collectives as coll
from repro_torch.utils.roofline import HW


@dataclass(frozen=True)
class SpCtx:
    mesh: Any
    batch_axes: tuple
    model_axis: str
    wire_dtype: Any
    n_out_sharded: tuple        # per weight: True if its out dim is sharded

    @property
    def m(self) -> int:
        return self.mesh.shape[self.model_axis]


def _ctx(rt, out_sharded) -> SpCtx:
    return SpCtx(mesh=rt.mesh, batch_axes=tuple(rt.batch_axes),
                 model_axis="model", wire_dtype=rt.wire_dtype,
                 n_out_sharded=tuple(out_sharded))


def _gather_seq(ctx: SpCtx, x: torch.Tensor) -> torch.Tensor:
    return coll.all_gather(x.to(ctx.wire_dtype), ctx.model_axis, ctx.mesh,
                           dim=1).to(x.dtype)


def _scatter_seq(ctx: SpCtx, x: torch.Tensor, dtype) -> torch.Tensor:
    return coll.reduce_scatter(x.to(ctx.wire_dtype), ctx.model_axis,
                               ctx.mesh, dim=1).to(dtype)


class _ProjIn(torch.autograd.Function):
    """AG(x over seq) once, then one local matmul per weight."""

    @staticmethod
    def forward(fctx, ctx: SpCtx, x, *ws):
        fctx.ctx = ctx
        fctx.save_for_backward(x, *ws)
        xf = _gather_seq(ctx, x)
        return tuple(xf @ w for w in ws)

    @staticmethod
    def backward(fctx, *d_ys):
        ctx = fctx.ctx
        x, *ws = fctx.saved_tensors
        xf = _gather_seq(ctx, x)
        d_xf, d_ws = None, []
        for w, d_y, sharded in zip(ws, d_ys, ctx.n_out_sharded):
            # a replicated output's cotangent is whole on every shard: its
            # d_x contribution counts once across the reduce-scatter
            contrib = d_y @ w.t()
            if not sharded and ctx.m > 1:
                contrib = contrib / ctx.m
            d_xf = contrib if d_xf is None else d_xf + contrib
            d_ws.append(torch.einsum("bsd,bsf->df", xf, d_y).to(w.dtype))
        return (None, _scatter_seq(ctx, d_xf, x.dtype), *d_ws)


class _LocalProj(torch.autograd.Function):
    """A sequence-local matmul per (replicated) weight, each output
    all-gathered over the sequence."""

    @staticmethod
    def forward(fctx, ctx: SpCtx, x, *ws):
        fctx.ctx = ctx
        fctx.save_for_backward(x, *ws)
        return tuple(_gather_seq(ctx, x @ w) for w in ws)

    @staticmethod
    def backward(fctx, *d_ys):
        ctx = fctx.ctx
        x, *ws = fctx.saved_tensors
        d_x, d_ws = None, []
        for w, d_y in zip(ws, d_ys):
            d_yloc = _scatter_seq(ctx, d_y, x.dtype)
            contrib = d_yloc @ w.t()
            d_x = contrib if d_x is None else d_x + contrib
            d_w = torch.einsum("bsd,bsf->df", x, d_yloc)
            d_w = coll.all_reduce(d_w.to(ctx.wire_dtype), ctx.model_axis,
                                  ctx.mesh)
            d_ws.append(d_w.to(w.dtype))
        return (None, d_x, *d_ws)


# ---------------------------------------------------------------------------
# public API (this rank's shards)
# ---------------------------------------------------------------------------

def proj_in(rt, x: torch.Tensor, ws: list, out_sharded: list) -> tuple:
    """x: (B, S/M, D) this rank's sequence block; ws: weights (D, F_i),
    column-sharded where ``out_sharded``. -> each (B, S, F_i)."""
    return _ProjIn.apply(_ctx(rt, out_sharded), x, *ws)


def proj_out(rt, h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """h: (B, S, F/M) column-sharded; w: (F/M, D) row-sharded -> (B, S/M,
    D), this rank's sequence block of the sum."""
    return coll.reduce_scatter_ag(h @ w, "model", rt.mesh, dim=1,
                                  wire=rt.wire_dtype)


def local_proj(rt, x: torch.Tensor, ws: list) -> tuple:
    """Sequence-local projection and output all-gather (replicated
    weights only). -> each (B, S, F_i)."""
    return _LocalProj.apply(_ctx(rt, [False] * len(ws)), x, *ws)


def kv_local_favorable(rt, cfg) -> bool:
    """Cost model: sequence-local K/V (and its output all-gather) against
    K/V on the gathered activation, priced on ``utils/roofline.HW`` (the
    H100 record; the reference prices its TPU's, so the two may choose
    differently: on the H100 d_model > ~3,300 favours the local branch).

    saved compute/chip ~ 4 passes * 2*T*D*KVdim*(m-1)/m / peak
    added wire/chip    ~ 3 units * 2*T*KVdim*wire_bytes*(m-1)/m / link_bw
    """
    m = rt.mesh.shape["model"]
    d, kvdim = cfg.d_model, cfg.kv_dim
    saved = 4 * 2 * d * kvdim * (m - 1) / m / HW.peak_flops
    added = 3 * 2 * kvdim * (m - 1) / m / HW.link_bw
    # wire seconds weigh ~2x compute seconds near the collective roof (the
    # reference's factor)
    return saved > 2.0 * added


def sp_active(rt, x: torch.Tensor) -> bool:
    """Does this block run the explicit sequence-parallel schedule?"""
    rc = rt.run_cfg
    if not rc.explicit_sp or rt.mesh is None:
        return False
    if "model" not in rt.mesh.axis_names:
        return False
    if "model" in (rt.batch_axes or ()):
        return False    # dp strategy: the model axis carries batch, no TP
    m = rt.mesh.shape["model"]
    return (m > 1 and x.dim() == 3 and x.shape[1] % m == 0
            and rt.shape_cfg.kind != "decode")
