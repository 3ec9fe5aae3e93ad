"""Plain PyTorch versions of the kernels (the port of
``repro/kernels/ref.py``).

They are the CPU path of ``kernels/ops.py`` and the yardstick the CUDA
kernels are held against on the card (chip_smoke.py): the embedding kernels
bit for bit, flash attention within the reference's tolerances.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True) -> torch.Tensor:
    """q: (B, Sq, H, D); k/v: (B, Sk, H, D) (KV pre-expanded). f32 inside,
    the output in q's dtype. Causal positions count from 0 on both sides."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale, k.float())
    if causal:
        sq, sk = q.shape[1], k.shape[1]
        mask = (torch.arange(sq, device=q.device)[:, None]
                >= torch.arange(sk, device=q.device)[None, :])
        s = torch.where(mask, s, torch.full((), NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return out.to(q.dtype)


def embed_gather_ref(table_shard: torch.Tensor, ids: torch.Tensor,
                     row_offset: int) -> torch.Tensor:
    """Server-side pull: rows of global ``ids`` owned by this shard, zeros
    elsewhere. table_shard: (Vs, E); ids: (N,) -> (N, E) in the table
    dtype."""
    vs = table_shard.shape[0]
    local = ids.long() - row_offset
    owned = (local >= 0) & (local < vs)
    rows = table_shard.index_select(0, local.clamp(0, vs - 1))
    return torch.where(owned[:, None], rows, torch.zeros((), dtype=rows.dtype,
                                                         device=rows.device))


def embed_scatter_add_ref(ids: torch.Tensor, rows: torch.Tensor,
                          vs: int) -> torch.Tensor:
    """Server-side push: scatter-add cotangent ``rows`` onto the owned
    slice of the gradient table. ids: (N,) local-space; rows: (N, E) ->
    (Vs, E) f32. Unowned ids (negative or >= Vs) land on a dump row Vs that
    is dropped. Repeated ids accumulate (in index order on the CPU)."""
    ids = ids.long()
    idx = torch.where((ids >= 0) & (ids < vs), ids, vs)
    d = torch.zeros((vs + 1, rows.shape[-1]), dtype=torch.float32,
                    device=rows.device)
    return d.index_add_(0, idx, rows.float())[:vs]
