"""Every collective of the port, by mesh axis name — the one module that
calls ``torch.distributed`` (the JAX package writes ``jax.lax.psum`` and
friends inline; the port names the same operations here).

``all_reduce`` / ``all_reduce_max``  sum / max over the named axes (the
                          reference's ``psum`` / ``pmax``; the JAX
                          package's lint reserves the name ``psum`` for its
                          manual-region modules and scans this tree too);
``all_gather``            tiled concatenation along ``dim`` in the group's
                          row-major order (``P(axes)``'s shard order);
``reduce_scatter``        sum, then keep this rank's block along ``dim``;
``all_reduce_async``      the bucketed exchange's non-blocking all-reduce;
``copy_to`` / ``reduce_from``  the model-axis pair as autograd functions:
                          identity forward / all-reduce backward, and its
                          mirror.

A collective over a group of one rank (``Mesh.group`` is None) is the
identity and returns its input untouched.

Under gloo, a collective that gloo has no CUDA path for is staged through
host memory: gloo lists only broadcast and all-reduce for CUDA tensors, so
``all_gather`` and ``reduce_scatter`` of a CUDA tensor copy it to the host,
run there and copy the result back. That staging exists in this module
only; compute never moves to the CPU. Several ranks on one card run over
gloo (NCCL takes one card per rank), so this is what the card's multi-rank
runs exchange through.
"""
from __future__ import annotations

import warnings

import torch
import torch.distributed as dist


def _gloo(mesh) -> bool:
    return mesh.backend == "gloo"


def _staged(mesh, x: torch.Tensor) -> bool:
    return _gloo(mesh) and x.device.type != "cpu"


def all_reduce(x: torch.Tensor, axes, mesh) -> torch.Tensor:
    """Sum over the ranks of ``axes``; a new tensor (x itself over a group
    of one)."""
    g = mesh.group(axes)
    if g is None:
        return x
    out = x.contiguous().clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=g)
    return out


def all_reduce_max(x: torch.Tensor, axes, mesh) -> torch.Tensor:
    g = mesh.group(axes)
    if g is None:
        return x
    out = x.contiguous().clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=g)
    return out


def all_reduce_async(buf: torch.Tensor, axes, mesh):
    """Sum ``buf`` (contiguous) in place over ``axes`` without blocking;
    returns the work handle to ``wait()`` on, or None over a group of
    one."""
    g = mesh.group(axes)
    if g is None:
        return None
    return dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=g,
                           async_op=True)


def all_gather(x: torch.Tensor, axes, mesh, dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` of ``axes``, concatenated along ``dim`` in the
    group's row-major order."""
    g = mesh.group(axes)
    if g is None:
        return x
    n = dist.get_world_size(g)
    src = x.movedim(dim, 0).contiguous()
    home = src.device
    if _staged(mesh, src):
        src = src.cpu()
    if _gloo(mesh):
        parts = [torch.empty_like(src) for _ in range(n)]
        dist.all_gather(parts, src, group=g)
        out = torch.cat(parts, 0)
    else:
        out = src.new_empty((n * src.shape[0],) + tuple(src.shape[1:]))
        dist.all_gather_into_tensor(out, src, group=g)
    return out.to(home).movedim(0, dim)


def reduce_scatter(x: torch.Tensor, axes, mesh, dim: int = 0
                   ) -> torch.Tensor:
    """The sum over ``axes`` of ``x``, cut along ``dim`` into one block per
    rank (row-major order); this rank's block."""
    g = mesh.group(axes)
    if g is None:
        return x
    n = dist.get_world_size(g)
    src = x.movedim(dim, 0).contiguous()
    if src.shape[0] % n:
        raise ValueError(f"reduce_scatter: dim of {src.shape[0]} over "
                         f"{n} ranks")
    home = src.device
    if _staged(mesh, src):
        src = src.cpu()
    out = src.new_empty((src.shape[0] // n,) + tuple(src.shape[1:]))
    with warnings.catch_warnings():
        # renamed reduce_scatter_single in newer torch; this name is in
        # every version the port runs on
        warnings.simplefilter("ignore", FutureWarning)
        dist.reduce_scatter_tensor(out, src, op=dist.ReduceOp.SUM, group=g)
    return out.to(home).movedim(0, dim)


class _CopyTo(torch.autograd.Function):
    """Identity forward, all-reduce backward: the activation every rank of
    ``axes`` uses whole feeds a product sharded over ``axes``, so each
    rank's gradient is a partial sum."""

    @staticmethod
    def forward(fctx, x, axes, mesh):
        fctx.axes, fctx.mesh = axes, mesh
        return x.view_as(x)

    @staticmethod
    def backward(fctx, g):
        return all_reduce(g, fctx.axes, fctx.mesh), None, None


class _ReduceFrom(torch.autograd.Function):
    """All-reduce forward, identity backward: the mirror of ``_CopyTo``."""

    @staticmethod
    def forward(fctx, x, axes, mesh):
        return all_reduce(x, axes, mesh)

    @staticmethod
    def backward(fctx, g):
        return g, None, None


def copy_to(x: torch.Tensor, axes, mesh) -> torch.Tensor:
    return _CopyTo.apply(x, axes, mesh)


def reduce_from(x: torch.Tensor, axes, mesh) -> torch.Tensor:
    return _ReduceFrom.apply(x, axes, mesh)
