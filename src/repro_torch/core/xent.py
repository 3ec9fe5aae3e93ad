"""Vocab-sharded softmax cross-entropy (the port of ``repro/core/xent.py``:
``_xent_local`` and ``sharded_xent``).

The logits live sharded over the ``model`` axis (the head is row-sharded
like the PS table): model shard m holds columns [m·Vloc, (m + 1)·Vloc).
Only scalars per token cross shards — the max of the max, the sum of the
exp-sum and the sum of the owned target logit — so no (B, S, V) tensor is
ever gathered; the reference's OPAU discipline applied to the loss.

Logits are cast to f32 and the padded-vocab columns masked to -inf, as in
the reference. At the paper's LM width the logits are (tokens, 800,000):
each f32 copy of them is 8 GB at 2,560 tokens. So the loss is one
``autograd.Function`` that keeps only the logits themselves (they exist
anyway) plus two scalars per token, and recomputes the softmax in the
backward; autograd through the plain expression would keep several f32
copies alive until the backward. The gradient is the one JAX
differentiates: (g / se) * exp(l - mx), minus g at the owned label —
(softmax_local − onehot_local)·g, local to each shard.
"""
from __future__ import annotations

import torch

from repro_torch.core import collectives as coll


def _masked_f32(logits: torch.Tensor, vocab: int, col0: int) -> torch.Tensor:
    """A fresh f32 copy with the columns at or past ``vocab`` (global
    column = col0 + local column) at -inf."""
    lf = logits.to(torch.float32, copy=True)
    first_pad = vocab - col0
    if lf.shape[-1] > first_pad:
        lf[..., max(first_pad, 0):] = float("-inf")
    return lf


class _Xent(torch.autograd.Function):
    @staticmethod
    def forward(fctx, logits, labels, vocab: int, shards: int, m: int,
                model_axis: str, mesh):
        vloc = logits.shape[-1]
        col0 = m * vloc
        lf = _masked_f32(logits, vocab, col0)
        mx = lf.amax(dim=-1)
        if shards > 1:
            mx = coll.all_reduce_max(mx, model_axis, mesh)
        lf.sub_(mx[..., None]).exp_()
        se = lf.sum(dim=-1)
        del lf
        if shards > 1:
            se = coll.all_reduce(se, model_axis, mesh)
        lse = torch.log(se) + mx
        lab = labels.long()[..., None]
        if shards > 1:
            local = lab - col0
            owned = (local >= 0) & (local < vloc)
            lab = torch.where(owned, local, torch.full_like(local, -1))
            tgt = torch.gather(logits, -1, local.clamp(0, vloc - 1))
            tgt = torch.where(owned, tgt.float(),
                              torch.zeros((), device=tgt.device))[..., 0]
            tgt = coll.all_reduce(tgt, model_axis, mesh)
        else:
            tgt = torch.gather(logits, -1, lab)[..., 0].float()
        fctx.save_for_backward(logits, lab, mx, se)
        fctx.vocab, fctx.col0, fctx.sharded = vocab, col0, shards > 1
        return lse - tgt

    @staticmethod
    def backward(fctx, g):
        logits, lab, mx, se = fctx.saved_tensors
        p = _masked_f32(logits, fctx.vocab, fctx.col0)
        p.sub_(mx[..., None]).exp_().mul_((g / se)[..., None])
        if fctx.sharded:
            # a shard subtracts g only at the labels it owns
            owned = lab >= 0
            p.scatter_add_(-1, lab.clamp(min=0),
                           torch.where(owned, -g[..., None],
                                       torch.zeros_like(g[..., None])))
        else:
            p.scatter_add_(-1, lab, (-g)[..., None])
        return p.to(logits.dtype), None, None, None, None, None, None


def xent(logits: torch.Tensor, labels: torch.Tensor, *,
         vocab: int) -> torch.Tensor:
    """Per-token loss (B, S) in f32. logits (B, S, Vp); labels (B, S)."""
    return _Xent.apply(logits, labels, vocab, 1, 0, "", None)


def sharded_xent(logits: torch.Tensor, labels: torch.Tensor, *, mesh,
                 model_axis: str, batch_axes: tuple,
                 vocab: int) -> torch.Tensor:
    """Per-token loss (B, S) in f32. logits (B, S, Vp / M): this rank's
    vocab shard over ``model_axis``; labels (B, S) global ids."""
    if mesh is None or model_axis not in mesh.axis_names \
            or mesh.shape[model_axis] == 1 or model_axis in (batch_axes or ()):
        # vocab not sharded (dp strategy: the model axis carries batch)
        return xent(logits, labels, vocab=vocab)
    return _Xent.apply(logits, labels, vocab, mesh.shape[model_axis],
                       mesh.coords[model_axis], model_axis, mesh)
