"""Softmax cross-entropy over the vocab (the port of ``repro/core/xent.py``,
its unsharded path ``_xent_local`` with one shard).

Logits are cast to f32 and the padded-vocab columns masked to -inf, as in
the reference. At the paper's LM width the logits are (tokens, 800,000):
each f32 copy of them is 8 GB at 2,560 tokens. So the loss is one
``autograd.Function`` that keeps only the logits themselves (they exist
anyway) plus two scalars per token, and recomputes the softmax in the
backward; autograd through the plain expression would keep several f32
copies alive until the backward. The gradient is the same expression JAX
differentiates: (g / se) * exp(l - mx), minus g at the label.
The vocab-sharded version comes with ROADMAP slice 2.
"""
from __future__ import annotations

import torch


def _masked_f32(logits: torch.Tensor, vocab: int) -> torch.Tensor:
    """A fresh f32 copy with padded-vocab columns at -inf."""
    lf = logits.to(torch.float32, copy=True)
    if lf.shape[-1] > vocab:
        lf[..., vocab:] = float("-inf")
    return lf


class _Xent(torch.autograd.Function):
    @staticmethod
    def forward(fctx, logits, labels, vocab: int):
        lf = _masked_f32(logits, vocab)
        mx = lf.amax(dim=-1)
        lf.sub_(mx[..., None]).exp_()
        se = lf.sum(dim=-1)
        del lf
        lse = torch.log(se) + mx
        lab = labels.long()[..., None]
        tgt = torch.gather(logits, -1, lab)[..., 0].float()
        fctx.save_for_backward(logits, lab, mx, se)
        fctx.vocab = vocab
        return lse - tgt

    @staticmethod
    def backward(fctx, g):
        logits, lab, mx, se = fctx.saved_tensors
        p = _masked_f32(logits, fctx.vocab)
        p.sub_(mx[..., None]).exp_().mul_((g / se)[..., None])
        p.scatter_add_(-1, lab, (-g)[..., None])
        return p.to(logits.dtype), None, None


def xent(logits: torch.Tensor, labels: torch.Tensor, *,
         vocab: int) -> torch.Tensor:
    """Per-token loss (B, S) in f32. logits (B, S, Vp); labels (B, S)."""
    return _Xent.apply(logits, labels, vocab)
