"""The sparse embedding lookup — the paper's PS pull and push (the port of
``repro/core/embedding.py``), run per rank.

  local aggregation (C2): the ids are deduped (one stable argsort) before
      any row moves; the backward segment-sums cotangent rows into the same
      deduped buffer.
  pull (forward): the embed_gather kernel fetches the owned deduped rows.
      Under ``ps`` / ``ps_gather`` the table is row-sharded over ``model``:
      model shard m holds rows [m·Vs, (m + 1)·Vs) and gathers at
      ``row_offset = m·Vs`` (zeros for rows it does not own); the row
      buffer is then summed over ``model`` at the wire dtype (~2αb).
  push (backward), by the plan's method:
      ``ps``          the owner's scatter of the deduped buffer (the
                      one-pass embed_scatter_add kernel: its ids are unique
                      among owned rows), then the (Vs, E) shard all-reduced
                      over the batch axes at the wire dtype (2·b/M);
      ``ps_gather``   the (ids, rows) buffers all-gathered over the batch
                      axes, then the owner's scatter, which accumulates
                      repeats (D·αb);
      ``mpi_gatherv`` the table replicated; the buffers all-gathered over
                      every replica, scattered with repeats (2(N-1)αb);
      ``allreduce``   (a table the planner sends to the dense exchange) a
      / ``dense``     local scatter; the step all-reduces the gradient.
  Scatters of repeated ids take the plain accumulating version, as the
  reference takes its jnp oracle there.

Each replica's gradient is that of its own mean loss; the step scales by
1/N (core/buckets.py), so a pushed gradient arrives replica-summed here.
The census ``{name}_unique`` is this replica's count; the step's fused
metrics all-reduce averages it over the replicas, which is the
reference's ``psum(uniq, batch_axes) / replicas``. A table on the dense
exchange outside a bucketed step dedupes the global batch, as the
reference's global-semantics path does: its ids are all-gathered first.

Static-shape buffer: the dedupe buffer has ``capacity`` rows; ``exact``
capacity (the local token count) never drops, ``capped`` may, and overflow
is counted in the ``{name}_dropped`` metric. The reference's
``overlap_gate`` and ``pin_after`` order XLA's scheduler and have no
counterpart: autograd issues the push where the gradient is ready.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Any, Optional

import torch

from repro_torch.core import collectives as coll
from repro_torch.kernels import ops, ref
from repro_torch.utils.spans import span


# the push methods whose table gradient the lookup's backward delivers
# already summed over the replicas: the step only scales it by 1/N, and
# a tied head's part of the same table is summed to match
PUSHED = ("ps", "ps_gather", "mpi_gatherv")


@dataclass(frozen=True)
class EmbedCtx:
    """Static context of one lookup."""
    method: str                 # ps | ps_gather | mpi_gatherv | allreduce
                                # | dense (one device)
    vocab_padded: int
    wire_dtype: Any             # torch dtype the pushed rows ride (OPSW)
    local_agg: bool             # C2: dedupe before exchange
    exact: bool = True          # exact capacity: size buffer per call-site
    census: bool = True         # observed-census metric ({name}_unique)
    mesh: Any = None            # launch/mesh.py Mesh (None: one device)
    batch_axes: tuple = ()      # mesh axes the batch is sharded over
    model_axis: str = ""        # mesh axis of the row shards
    bucketed: bool = False      # the step's dense exchange is bucketed:
                                # a dense-routed table dedupes per replica
    deferred: Optional[list] = field(default=None, compare=False)
                                # overlap=False: the push's (ids, rows) go
                                # here and the step exchanges them after
                                # the backward (``deferred_push``)
    scatter_block: int = 0      # the one-pass scatter's rows per block
                                # (Plan.table_tiles; 0: the kernel's own)

    @property
    def model_shards(self) -> int:
        if self.mesh is None or not self.model_axis or \
                self.method in ("dense", "allreduce", "mpi_gatherv"):
            return 1
        return self.mesh.shape[self.model_axis]

    @property
    def replicas(self) -> int:
        if self.mesh is None:
            return 1
        return self.mesh.axes_size(self.batch_axes)

    @property
    def global_dedupe(self) -> bool:
        """A dense-routed table outside a bucketed step dedupes the global
        batch (the reference's global-semantics lookup)."""
        return (self.method == "allreduce" and not self.bucketed
                and self.replicas > 1)


def _dedupe(ids_flat: torch.Tensor, capacity: int, vocab_padded: int,
            local_agg: bool) -> tuple:
    """-> (uids[capacity], inv[T], dropped, n_unique), all int32.

    One argsort gives everything: the sorted order gives first-occurrence
    flags, their cumsum is each id's unique rank ("slot"), and scattering
    first occurrences by slot builds the ascending unique buffer, padded
    with the sentinel ``vocab_padded``. Positions whose slot overflowed the
    capacity point at slot ``capacity`` (read as a zero row). ``n_unique``
    is counted before the capacity cut (the observed census)."""
    t = ids_flat.shape[0]
    dev = ids_flat.device
    if not local_agg:
        # no dedupe: the row buffer is the raw token stream
        return (ids_flat.to(torch.int32),
                torch.arange(t, dtype=torch.int32, device=dev),
                torch.zeros((), dtype=torch.int32, device=dev),
                torch.tensor(t, dtype=torch.int32, device=dev))
    capacity = min(capacity, t)
    order = torch.argsort(ids_flat, stable=True)          # the one sort
    sorted_ids = ids_flat[order].to(torch.int32)
    first = torch.ones(t, dtype=torch.bool, device=dev)
    first[1:] = sorted_ids[1:] != sorted_ids[:-1]
    n_unique = first.sum().to(torch.int32)
    slot = (torch.cumsum(first, 0) - 1).to(torch.int32)   # unique rank
    dropped = torch.clamp(n_unique - capacity, min=0)
    # ascending unique ids; slots past capacity land on a discard entry
    uids = torch.full((capacity + 1,), vocab_padded, dtype=torch.int32,
                      device=dev)
    dest = torch.where(first & (slot < capacity), slot,
                       torch.full_like(slot, capacity))
    uids[dest.long()] = sorted_ids
    uids = uids[:capacity]
    # inverse: original position -> slot (capacity == overflowed)
    inv = torch.empty(t, dtype=torch.int32, device=dev)
    inv[order] = torch.clamp(slot, max=capacity)
    return uids, inv, dropped, n_unique


def dedupe(ids_flat: torch.Tensor, capacity: int, vocab_padded: int,
           local_agg: bool) -> tuple:
    """(unique_ids[capacity], inverse[T], n_dropped). Sentinel =
    vocab_padded."""
    uids, inv, dropped, _ = _dedupe(ids_flat, capacity, vocab_padded,
                                    local_agg)
    return uids, inv, dropped


def _scatter_rows(local_ids: torch.Tensor, rows: torch.Tensor, vs: int,
                  ctx: EmbedCtx) -> torch.Tensor:
    """Owner-local push into the (Vs, E) f32 gradient; unowned ids
    (negative or >= Vs) are dropped. The kernel takes ids unique among
    owned rows: a replica's dedupe buffer (``ctx.local_agg``). Repeated
    ids — the raw token stream of local_agg=False, the gathered buffers of
    ps_gather and mpi_gatherv (passed with local_agg off) — take the
    accumulating plain scatter on every device, as the reference takes its
    jnp oracle there (``repro/core/embedding.py::_scatter_rows``); on the
    card its index_add_ adds repeats with atomics, in an order that varies
    from run to run."""
    if ctx.local_agg:
        return ops.embed_scatter_add(local_ids, rows, vs,
                                     block=ctx.scatter_block)
    return ref.embed_scatter_add_ref(local_ids, rows, vs)


def _model_index(ctx: EmbedCtx) -> int:
    return ctx.mesh.coords[ctx.model_axis] if ctx.model_shards > 1 else 0


def _fwd_local(table: torch.Tensor, ids: torch.Tensor, ctx: EmbedCtx,
               capacity: int) -> tuple:
    """-> out (B,S,E), uids (cap,), inv (B*S,) local positions, dropped,
    uniq (f32)."""
    b, s = ids.shape
    flat = ids.reshape(-1).to(torch.int32)
    t = flat.shape[0]
    if ctx.global_dedupe:
        flat = coll.all_gather(flat, ctx.batch_axes, ctx.mesh)
    uids, inv, dropped, n_unique = _dedupe(flat, capacity, ctx.vocab_padded,
                                           ctx.local_agg)
    if ctx.global_dedupe:
        r = ctx.mesh.index(ctx.batch_axes)
        inv = inv[r * t:(r + 1) * t]
    uniq = n_unique.to(torch.float32)
    if not ctx.census:
        uniq = torch.zeros_like(uniq)
    if ctx.model_shards > 1:
        vs = table.shape[0]
        rows = ops.embed_gather(table, uids, _model_index(ctx) * vs)
        rows = coll.all_reduce(rows.to(ctx.wire_dtype), ctx.model_axis, ctx.mesh)
        rows = rows.to(table.dtype)     # pull: ~2αb over model
    else:
        rows = ops.embed_gather(table, uids, 0)
    rows_pad = torch.cat([rows, rows.new_zeros((1, rows.shape[1]))], 0)
    out = rows_pad.index_select(0, inv.long()).reshape(b, s, -1)
    return out, uids, inv, dropped, uniq


def _gathered_push(uids: torch.Tensor, d_rows: torch.Tensor, vs: int,
                   offset: int, ctx: EmbedCtx) -> torch.Tensor:
    """The gather pushes (ps_gather, mpi_gatherv): every replica's (ids,
    rows) buffers, scattered with their repeats."""
    uids_all = coll.all_gather(uids, ctx.batch_axes, ctx.mesh)
    rows_all = coll.all_gather(d_rows, ctx.batch_axes, ctx.mesh)
    return _scatter_rows(uids_all - offset, rows_all, vs,
                         replace(ctx, local_agg=False))


def _bwd_local(uids: torch.Tensor, inv: torch.Tensor, d_out: torch.Tensor,
               vs: int, ctx: EmbedCtx) -> torch.Tensor:
    """-> the (Vs, E) f32 table gradient: segment-sum in f32 into the
    deduped buffer, wire cast (OPSW), then the push exchange of
    ``ctx.method``; the wire rows alone when the push is deferred past
    the backward (``EmbedCtx.deferred``)."""
    cap = uids.shape[0]
    e = d_out.shape[-1]
    d_flat = d_out.reshape(-1, e)
    d_rows = torch.zeros((cap + 1, e), dtype=torch.float32,
                         device=d_out.device)
    d_rows.index_add_(0, inv.long(), d_flat.float())
    d_rows = d_rows[:cap].to(ctx.wire_dtype)
    if ctx.method == "mpi_gatherv":
        if ctx.deferred is not None:
            return d_rows
        return _gathered_push(uids, d_rows, vs, 0, ctx)
    offset = _model_index(ctx) * vs
    if ctx.method == "ps_gather":
        return _gathered_push(uids, d_rows, vs, offset, ctx)
    d = _scatter_rows(uids - offset if offset else uids, d_rows, vs, ctx)
    if ctx.method == "ps" and ctx.replicas > 1:
        # the owner's shard summed over the replicas at the wire dtype
        d = coll.all_reduce(d.to(ctx.wire_dtype), ctx.batch_axes,
                      ctx.mesh).float()
    return d


def deferred_push(uids: torch.Tensor, d_rows: torch.Tensor, vs: int,
                  ctx: EmbedCtx) -> torch.Tensor:
    """The gatherv push a deferred lookup left (``EmbedCtx.deferred``),
    run after the backward: the same exchange as in the backward."""
    with span("embed.push"):
        return _gathered_push(uids, d_rows, vs, 0, ctx)


class _Lookup(torch.autograd.Function):
    """The lookup with a hand-written backward: the forward's pull and the
    backward's push are the two kernels and their exchanges; nothing is
    auto-differentiated through the dedupe."""

    @staticmethod
    def forward(fctx, table, ids, ectx: EmbedCtx, capacity: int, name: str):
        with span("embed.pull"):
            out, uids, inv, dropped, uniq = _fwd_local(table, ids, ectx,
                                                       capacity)
        fctx.save_for_backward(uids, inv)
        fctx.ectx, fctx.name = ectx, name
        fctx.table_dtype = table.dtype
        fctx.vs = table.shape[0]
        fctx.mark_non_differentiable(dropped, uniq)
        return out, dropped, uniq

    @staticmethod
    def backward(fctx, d_out, _d_dropped, _d_uniq):
        uids, inv = fctx.saved_tensors
        ectx = fctx.ectx
        with span("embed.push"):
            d_table = _bwd_local(uids, inv, d_out, fctx.vs, ectx)
            if ectx.deferred is not None:
                # the push runs after the backward (core/transform.py)
                ectx.deferred.append((fctx.name, uids, d_table, fctx.vs,
                                      ectx))
                return None, None, None, None, None
            return d_table.to(fctx.table_dtype), None, None, None, None


def lookup(table: torch.Tensor, ids: torch.Tensor, *, ctx: EmbedCtx,
           capacity: int, name: str = "embed") -> tuple:
    """Embedding lookup through the PS pull/push. ``table``: this rank's
    shard (the whole table when replicated); ids: (B, S) global ids of
    this replica's rows. Returns (rows (B, S, E) in the table dtype,
    metrics) with the ``{name}_rows`` / ``{name}_dropped`` /
    ``{name}_unique`` census."""
    if ctx.mesh is None and ctx.method != "dense":
        raise ValueError(f"embedding method {ctx.method!r} exchanges over a "
                         "mesh; this lookup has none (method 'dense')")
    local_tokens = max(ids.numel(), 1)
    if ctx.global_dedupe:
        local_tokens *= ctx.replicas     # the global batch's tokens
    if ctx.exact:
        # exact mode never drops: buffer sized to this call's local tokens
        capacity = min(local_tokens, ctx.vocab_padded)
    else:
        capacity = min(capacity, local_tokens, ctx.vocab_padded)
    out, dropped, uniq = _Lookup.apply(table, ids, ctx, capacity, name)
    nrows = capacity if ctx.local_agg else local_tokens
    metrics = {f"{name}_rows": torch.tensor(nrows, dtype=torch.int32,
                                            device=ids.device),
               f"{name}_dropped": dropped.detach(),
               f"{name}_unique": uniq.detach()}
    return out, metrics
