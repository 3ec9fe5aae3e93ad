"""The sparse embedding lookup — the paper's PS pull and push, single
device (the port of ``repro/core/embedding.py``, its ``mesh=None`` path).

  local aggregation (C2): the ids are deduped (one stable argsort) before
      any row moves; the backward segment-sums cotangent rows into the same
      deduped buffer.
  pull (forward): the embed_gather kernel fetches the deduped rows, then a
      take through the inverse map expands them to tokens.
  push (backward): the embed_scatter_add kernel writes the aggregated rows
      into the (Vs, E) f32 table gradient; without local aggregation the
      repeated ids take the plain accumulating scatter.

Static-shape buffer: the dedupe buffer has ``capacity`` rows; ``exact``
capacity (the local token count) never drops, ``capped`` may, and overflow
is counted in the ``{name}_dropped`` metric. The exchanges over a mesh
(ps / ps_gather / mpi_gatherv) come with ROADMAP slice 2.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from repro_torch.kernels import ops, ref


@dataclass(frozen=True)
class EmbedCtx:
    """Static context of one lookup (single device: method ``dense``)."""
    method: str                 # dense (ps | ps_gather | mpi_gatherv: slice 2)
    vocab_padded: int
    wire_dtype: Any             # torch dtype the pushed rows ride (OPSW)
    local_agg: bool             # C2: dedupe before exchange
    exact: bool = True          # exact capacity: size buffer per call-site
    census: bool = True         # observed-census metric ({name}_unique)


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
    """Owner-local push into the (Vs, E) f32 gradient. The kernel takes
    unique ids only (the dedupe buffer). The raw token stream of
    local_agg=False repeats ids, so on every device it takes the
    accumulating plain scatter, as the reference takes its jnp oracle there
    (``repro/core/embedding.py::_scatter_rows``); on the card its index_add_
    adds repeats with atomics, in an order that varies from run to run."""
    if ctx.local_agg:
        return ops.embed_scatter_add(local_ids, rows, vs)
    return ref.embed_scatter_add_ref(local_ids, rows, vs)


def _fwd_local(table: torch.Tensor, ids: torch.Tensor, ctx: EmbedCtx,
               capacity: int) -> tuple:
    """-> out (B,S,E), uids (cap,), inv (B*S,), dropped, uniq (f32)."""
    b, s = ids.shape
    flat = ids.reshape(-1).to(torch.int32)
    uids, inv, dropped, n_unique = _dedupe(flat, capacity, ctx.vocab_padded,
                                           ctx.local_agg)
    uniq = n_unique.to(torch.float32)
    if not ctx.census:
        uniq = torch.zeros_like(uniq)
    rows = ops.embed_gather(table, uids, 0)
    rows_pad = torch.cat([rows, rows.new_zeros((1, rows.shape[1]))], 0)
    out = rows_pad.index_select(0, inv.long()).reshape(b, s, -1)
    return out, uids, inv, dropped, uniq


def _bwd_local(uids: torch.Tensor, inv: torch.Tensor, d_out: torch.Tensor,
               vs: int, ctx: EmbedCtx) -> torch.Tensor:
    """-> (Vs, E) f32 table gradient: segment-sum in f32 into the deduped
    buffer, wire cast (OPSW), push."""
    cap = uids.shape[0]
    e = d_out.shape[-1]
    d_flat = d_out.reshape(-1, e)
    d_rows = torch.zeros((cap + 1, e), dtype=torch.float32,
                         device=d_out.device)
    d_rows.index_add_(0, inv.long(), d_flat.float())
    d_rows = d_rows[:cap].to(ctx.wire_dtype)
    return _scatter_rows(uids, d_rows, vs, ctx)


class _Lookup(torch.autograd.Function):
    """The lookup with a hand-written backward: the forward's pull and the
    backward's push are the two kernels; nothing is auto-differentiated
    through the dedupe."""

    @staticmethod
    def forward(fctx, table, ids, ectx: EmbedCtx, capacity: int):
        out, uids, inv, dropped, uniq = _fwd_local(table, ids, ectx, capacity)
        fctx.save_for_backward(uids, inv)
        fctx.ectx = ectx
        fctx.table_dtype = table.dtype
        fctx.mark_non_differentiable(dropped, uniq)
        return out, dropped, uniq

    @staticmethod
    def backward(fctx, d_out, _d_dropped, _d_uniq):
        uids, inv = fctx.saved_tensors
        ectx = fctx.ectx
        d_table = _bwd_local(uids, inv, d_out, ectx.vocab_padded, ectx)
        return d_table.to(fctx.table_dtype), None, None, None


def lookup(table: torch.Tensor, ids: torch.Tensor, *, ctx: EmbedCtx,
           capacity: int, name: str = "embed") -> tuple:
    """Embedding lookup through the PS pull/push. ids: (B, S) global ids.
    Returns (rows (B, S, E) in the table dtype, metrics) with the
    ``{name}_rows`` / ``{name}_dropped`` / ``{name}_unique`` census."""
    if ctx.method != "dense":
        raise NotImplementedError(
            f"embedding method {ctx.method!r} exchanges over a mesh: "
            "ROADMAP slice 2")
    local_tokens = max(ids.numel(), 1)
    if ctx.exact:
        # exact mode never drops: buffer sized to this call's local tokens
        capacity = min(local_tokens, ctx.vocab_padded)
    else:
        capacity = min(capacity, local_tokens, ctx.vocab_padded)
    out, dropped, uniq = _Lookup.apply(table, ids, ctx, capacity)
    nrows = capacity if ctx.local_agg else local_tokens
    metrics = {f"{name}_rows": torch.tensor(nrows, dtype=torch.int32,
                                            device=ids.device),
               f"{name}_dropped": dropped.detach(),
               f"{name}_unique": uniq.detach()}
    return out, metrics
