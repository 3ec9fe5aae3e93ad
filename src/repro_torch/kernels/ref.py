"""Plain PyTorch versions of the kernels (the port of
``repro/kernels/ref.py``).

They are the CPU path of ``kernels/ops.py`` and the yardstick the CUDA
kernels are held against on the card (chip_smoke.py): the embedding kernels
bit for bit, flash attention and WKV within the reference's tolerances.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30
# fp32 holds e^87; clamping at 80 keeps the factored WKV pieces finite
# (exact while chunk * |log-decay| <= 80), as in repro/kernels/wkv.py
CLAMP = 80.0


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


def wkv_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            lw: torch.Tensor, bonus: torch.Tensor,
            state: torch.Tensor) -> tuple:
    """RWKV6 WKV, sequential oracle.

    r/k/v/lw: (B, S, H, E); bonus: (H, E); state: (B, H, E, E) [key x
    value]. out[t] = r_t (state + u * k_t v_t^T); state = diag(exp(lw_t))
    state + k_t v_t^T. f32 inside; out in r's dtype, state f32."""
    st = state.float()
    u = bonus.float()[None, :, :, None]
    outs = []
    for t in range(r.shape[1]):
        rt, kt, vt = r[:, t].float(), k[:, t].float(), v[:, t].float()
        kv = torch.einsum("bhk,bhv->bhkv", kt, vt)
        outs.append(torch.einsum("bhk,bhkv->bhv", rt, st + u * kv))
        st = st * torch.exp(lw[:, t].float())[..., None] + kv
    return torch.stack(outs, dim=1).to(r.dtype), st


def wkv_chunked_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    lw: torch.Tensor, bonus: torch.Tensor, state: torch.Tensor,
                    *, chunk: int = 32) -> tuple:
    """RWKV6 WKV in the factored chunk form of the TPU kernel
    (``repro/kernels/wkv.py``): chunks of ``min(chunk, S)`` tokens in order,
    the tail padded with decay e^0 and zero r/k/v, the (E x E) f32 state
    carried between chunks; inside a chunk cum = cumsum(lw), cin = cum - lw,
    qf = r exp(clip(cin, -80, 0)), kf = k exp(clip(-cum, 0, 80)), the
    strictly lower qf kf^T times v, the diagonal bonus and qf state, then
    state <- state exp(clip(tot, -80, 0)) + (k exp(clip(tot - cum, -80,
    80)))^T v. Where chunk * |lw| > 80 the clamps make this differ from the
    sequential recurrence, exactly as the reference kernel does. f32
    inside; out in r's dtype, state f32."""
    b, s, h, e = r.shape
    chunk = min(chunk, s)
    pad = (-s) % chunk
    # (B, S, H, E) -> (B, H, S + pad, E) in f32, zero-padded (lw 0: e^0)
    rt, kt, vt, lwt = (torch.nn.functional.pad(
        a.float().permute(0, 2, 1, 3), (0, 0, 0, pad)) for a in (r, k, v, lw))
    u = bonus.float()[None, :, None, :]
    lower = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                  device=r.device), diagonal=-1)
    st = state.float()
    outs = []
    for c0 in range(0, s + pad, chunk):
        rj, kj, vj, lwj = (a[:, :, c0:c0 + chunk] for a in (rt, kt, vt, lwt))
        cum = torch.cumsum(lwj, dim=2)                       # inclusive
        cin = cum - lwj                                      # exclusive
        qf = rj * torch.exp(torch.clamp(cin, -CLAMP, 0.0))
        kf = kj * torch.exp(torch.clamp(-cum, 0.0, CLAMP))
        s_tt = torch.where(lower, qf @ kf.transpose(-1, -2), 0.0)
        out = s_tt @ vj
        out = out + torch.sum(rj * u * kj, dim=-1, keepdim=True) * vj
        out = out + qf @ st
        outs.append(out)
        tot = cum[:, :, -1:, :]                              # (B, H, 1, E)
        kdec = kj * torch.exp(torch.clamp(tot - cum, -CLAMP, CLAMP))
        st = st * torch.exp(torch.clamp(tot, -CLAMP, 0.0)).transpose(-1, -2) \
            + kdec.transpose(-1, -2) @ vj
    out = torch.cat(outs, dim=2).permute(0, 2, 1, 3)[:, :s]
    return out.to(r.dtype), st
