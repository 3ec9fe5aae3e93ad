"""GQA attention with RoPE (the port of ``repro/models/attention.py``).

Implementations, chosen by ``RunConfig.attention_impl``:
  naive    full (Sq, Sk) score materialization.
  chunked  online softmax over KV chunks (the flash algorithm in plain
           torch ops); memory O(Sq * chunk).
  pallas   the reference's dispatch to its Pallas kernel; here it goes to
           the hand-written CUDA kernel (kernels/ops.py::flash_attention),
           or to its plain version for CPU tensors.

Layouts are the reference's: q (B, Sq, H, D), k/v (B, Sk, KV, D). On a
process mesh each rank holds a contiguous block of the padded q heads
(``make_qmap``'s ``lo`` / ``count`` map that block to its global KV heads)
and, in serving, a block of the decode cache's positions:
``decode_attention`` then computes the partial softmax of every q head over
its positions and merges the partials over ``model`` (flash-decoding's
combine: the running maxima's max, then one sum of the rescaled sums and
outputs). A rank with no valid position contributes exact zeros: masked
scores are -1e30, the kernels' convention, never -inf.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import collectives as coll
from repro_torch.kernels import ops

NEG_INF = -1e30


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, H, D). positions: (B, S) or (S,)."""
    d = x.shape[-1]
    half = d // 2
    freqs = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                          device=x.device) / half))
    if positions.dim() == 1:
        positions = positions[None, :]
    ang = positions[..., None].float() * freqs                 # (B, S, half)
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def make_qmap(n_heads: int, n_kv: int, padded_heads: int, device=None,
              lo: int = 0, count: Optional[int] = None
              ) -> Optional[torch.Tensor]:
    """q-head -> kv-head index map (int64) of the padded q heads
    ``lo .. lo + count`` (default: all of them; a rank's block on a mesh);
    padded q heads point at kv 0. None when the map is the identity (MHA,
    no padding, the whole set)."""
    q_per_kv = max(n_heads // max(n_kv, 1), 1)
    count = padded_heads - lo if count is None else count
    idx = [min(i // q_per_kv, n_kv - 1) if i < n_heads else 0
           for i in range(lo, lo + count)]
    if idx == list(range(count)) and count == n_kv:
        return None
    return torch.tensor(idx, dtype=torch.int64, device=device)


def _expand_kv(k: torch.Tensor, qmap: Optional[torch.Tensor]) -> torch.Tensor:
    """(B, S, KV, D) -> (B, S, H, D) via the q->kv map. The reference's
    one-hot einsum multiplies by exact ones and adds exact zeros; an index
    copy gives the same bits without the product."""
    if qmap is None:
        return k
    return k.index_select(2, qmap.to(k.device))


def _causal_mask(sq: int, sk: int, q_offset: int, device) -> torch.Tensor:
    qpos = q_offset + torch.arange(sq, device=device)[:, None]
    return qpos >= torch.arange(sk, device=device)[None, :]


def naive_attention(q, k, v, *, causal: bool = True, q_offset: int = 0,
                    qmap=None) -> torch.Tensor:
    """q: (B, Sq, H, D), k/v: (B, Sk, KV, D). Returns (B, Sq, H, D)."""
    kq = _expand_kv(k, qmap)
    vq = _expand_kv(v, qmap)
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale, kq.float())
    if causal:
        mask = _causal_mask(q.shape[1], k.shape[1], q_offset, q.device)
        scores = torch.where(mask, scores,
                             torch.full((), NEG_INF, device=q.device))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, vq.float())
    return out.to(q.dtype)


def chunked_attention(q, k, v, *, causal: bool = True, chunk: int = 1024,
                      q_offset: int = 0, qmap=None) -> torch.Tensor:
    """Online-softmax attention, looped over KV chunks (flash algorithm).
    Never materializes more than (B, H, Sq, chunk) of scores."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    chunk = min(chunk, sk)
    n_chunks = -(-sk // chunk)
    scale = d ** -0.5
    dev = q.device
    qpos = q_offset + torch.arange(sq, device=dev)[:, None]
    qf = q.float() * scale
    neg = torch.full((), NEG_INF, device=dev)

    m = torch.full((b, h, sq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, h, sq, d), dtype=torch.float32, device=dev)
    for j in range(n_chunks):
        lo = j * chunk
        kj = k[:, lo:lo + chunk]
        vj = v[:, lo:lo + chunk]
        pad = chunk - kj.shape[1]
        if pad:                       # the reference pads KV to a multiple
            kj = torch.nn.functional.pad(kj, (0, 0, 0, 0, 0, pad))
            vj = torch.nn.functional.pad(vj, (0, 0, 0, 0, 0, pad))
        kj = _expand_kv(kj, qmap).float()
        vj = _expand_kv(vj, qmap).float()
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kj)
        kpos = lo + torch.arange(chunk, device=dev)[None, :]
        mask = kpos <= (sk - 1)
        if causal:
            mask = mask & (qpos >= kpos)
        s = torch.where(mask[None, None], s, neg)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, vj)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)


def decode_attention(q, k_cache, v_cache, cache_len, *, qmap=None,
                     mesh=None, axes="model", kv_offset: int = 0
                     ) -> torch.Tensor:
    """One-step attention against a KV cache. q: (B, 1, H, D); caches
    (B, S, KV, D). ``cache_len`` is a scalar (homogeneous batch) or a
    per-slot (B,) tensor (the serving engine's slot-paged decode: each slot
    masks exactly its own valid prefix).

    ``mesh``: the caches hold this rank's block of the positions, from
    ``kv_offset``; every q head's partial attention over them is merged
    over ``axes`` (the cache's sequence axes)."""
    kq = _expand_kv(k_cache, qmap).float()
    vq = _expand_kv(v_cache, qmap).float()
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale, kq)
    kpos = kv_offset + torch.arange(k_cache.shape[1], device=q.device)
    kpos = kpos[None, None, None, :]
    cl = torch.as_tensor(cache_len, device=q.device)
    if cl.dim() == 1:
        cl = cl[:, None, None, None]
    s = torch.where(kpos < cl, s, torch.full((), NEG_INF, device=q.device))
    if mesh is None or mesh.group(axes) is None:
        probs = torch.softmax(s, dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", probs, vq)
        return out.to(q.dtype)
    m = s.amax(dim=-1)                                      # (B, H, 1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    o = torch.einsum("bhqk,bkhd->bhqd", p, vq)
    m_all = coll.all_reduce_max(m, axes, mesh)
    w = torch.exp(m - m_all)         # 0 where this rank held no position
    part = torch.cat([o * w[..., None], (l * w)[..., None]], dim=-1)
    part = coll.all_reduce(part, axes, mesh)
    out = part[..., :-1] / part[..., -1:]
    return out.transpose(1, 2).to(q.dtype)


def attention(q, k, v, *, impl: str = "chunked", causal: bool = True,
              chunk: int = 1024, q_offset: int = 0, qmap=None) -> torch.Tensor:
    if impl == "naive":
        return naive_attention(q, k, v, causal=causal, q_offset=q_offset,
                               qmap=qmap)
    if impl == "chunked":
        return chunked_attention(q, k, v, causal=causal, chunk=chunk,
                                 q_offset=q_offset, qmap=qmap)
    if impl == "pallas":
        # as in the reference, this branch drops q_offset and chunk
        return ops.flash_attention(q, _expand_kv(k, qmap),
                                   _expand_kv(v, qmap), causal=causal)
    raise ValueError(f"unknown attention impl {impl!r}")
