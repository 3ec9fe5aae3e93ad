"""The paper's LM (Jozefowicz BIGLSTM, 800k vocab) — the port of
``repro/models/lstm.py``, decoder-only (``parallax-lm``).

LSTM-with-projection cell, a Python loop over time. The embedding table
goes through the PS pull/push (core/embedding.py, the two CUDA kernels on
the card); the gate, projection and logit products are plain
``torch.matmul``, as the reference leaves them to XLA. The encoder-decoder
branch (``parallax-nmt``) comes with ROADMAP slice 2.

Dtypes follow the reference step for step: the lookup returns rows in the
table dtype, cast to the compute dtype; gates are summed in the compute
dtype and cast to f32; the cell state ``c`` stays f32 and ``h`` is cast to
the compute dtype before the projection; the head product runs in the
compute dtype and the loss casts to f32.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.core import embedding as emb
from repro_torch.core.xent import xent
from repro_torch.models.layers import (ParamSpec, ParamTree, flatten_specs,
                                       stack_tree)


def lstm_cell_specs(d_in: int, hidden: int, proj: int) -> dict:
    return {
        "w_x": ParamSpec((d_in, 4 * hidden), (None, "lstm_hidden"), fan_in_axes=(0,)),
        "w_h": ParamSpec((proj, 4 * hidden), (None, "lstm_hidden"), fan_in_axes=(0,)),
        "bias": ParamSpec((4 * hidden,), ("lstm_hidden",), init="zeros"),
        "w_proj": ParamSpec((hidden, proj), ("lstm_hidden", None), fan_in_axes=(0,)),
    }


def model_specs(cfg, rt) -> dict:
    if cfg.is_encdec:
        raise NotImplementedError(
            "the LSTM encoder-decoder (parallax-nmt) is ROADMAP slice 2")
    d, hidden = cfg.d_model, cfg.d_ff
    vp = rt.padded_vocab
    return {
        "embed": ParamSpec((vp, d), ("vocab", "embed"), init="embed", sparse=True),
        "layers": stack_tree(lstm_cell_specs(d, hidden, d), cfg.n_layers),
        "head": ParamSpec((vp, d), ("vocab", "embed"), scale=0.02),
    }


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b under JAX's dtype promotion (bf16 @ f32 runs in f32)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.matmul(a.to(dt), b.to(dt))


def _lstm_layer(p: dict, xs: torch.Tensor, state: tuple) -> tuple:
    """xs: (B,S,Din); state: (c (B,H) f32, h (B,P)). Loops over time."""
    w_x, w_h, bias, w_proj = p["w_x"], p["w_h"], p["bias"], p["w_proj"]
    gx = _mm(xs, w_x)                                  # (B,S,4H) hoisted
    c, h = state
    ys = []
    for t in range(gx.shape[1]):
        gates = gx[:, t] + _mm(h, w_h) + bias
        i, f, g, o = gates.float().chunk(4, dim=-1)
        c = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
        h = _mm((torch.sigmoid(o) * torch.tanh(c)).to(xs.dtype), w_proj)
        ys.append(h)
    return torch.stack(ys, dim=1), (c, h)


def _init_state(cfg, batch: int, n_layers: int, dtype: torch.dtype,
                device) -> tuple:
    # c stays f32 (the accumulator); h matches the activation dtype
    return (torch.zeros((n_layers, batch, cfg.d_ff), dtype=torch.float32,
                        device=device),
            torch.zeros((n_layers, batch, cfg.d_model), dtype=dtype,
                        device=device))


def _run_stack(layers_p: dict, x: torch.Tensor, states: tuple) -> tuple:
    n = next(iter(layers_p.values())).shape[0]
    cs, hs = states
    new_c, new_h = [], []
    for i in range(n):       # few layers; unrolled for per-layer residuals
        p_i = {k: v[i] for k, v in layers_p.items()}
        y, (c, h) = _lstm_layer(p_i, x, (cs[i], hs[i]))
        x = x + y if y.shape == x.shape else y
        new_c.append(c)
        new_h.append(h)
    return x, (torch.stack(new_c), torch.stack(new_h))


class LSTMLM(nn.Module):
    """``parallax-lm``: its ``named_parameters()`` carry the reference's
    dotted names (embed, head, layers.bias, layers.w_h, layers.w_proj,
    layers.w_x). Parameters are allocated uninitialized; ``init_`` or
    ``load_`` fills them (core/transform.py::build_step)."""

    def __init__(self, cfg, rt):
        super().__init__()
        self.cfg, self.rt = cfg, rt
        specs = model_specs(cfg, rt)
        dev, pdt = rt.device, rt.param_dtype
        for name in ("embed", "head"):
            s = specs[name]
            self.register_parameter(name, nn.Parameter(torch.empty(
                s.shape, dtype=s.dtype or pdt, device=dev)))
        self.layers = ParamTree(specs["layers"], pdt, dev)

    def specs(self) -> dict:
        return model_specs(self.cfg, self.rt)

    def param_specs(self) -> list:
        """[(dotted_name, ParamSpec)] in JAX's flatten order."""
        return flatten_specs(self.specs())

    def input_specs(self, shape=None) -> dict:
        """{name: (shape, dtype)} of one training batch."""
        shape = shape or self.rt.shape_cfg
        b, s = shape.global_batch, shape.seq_len
        return {"tokens": ((b, s), torch.int32),
                "labels": ((b, s), torch.int32)}

    def forward(self, batch: dict, state=None) -> tuple:
        """-> (logits (B,S,Vp) in the compute dtype, new state, metrics)."""
        rt = self.rt
        tokens = batch["tokens"]
        b, _ = tokens.shape
        x, metrics = emb.lookup(self.embed, tokens, ctx=rt.embed_ctx(),
                                capacity=rt.embed_capacity_for("embed"))
        x = x.to(rt.dtype)
        if state is None:
            state = _init_state(self.cfg, b, self.cfg.n_layers, rt.dtype,
                                tokens.device)
        layers = dict(self.layers.named_parameters())
        x, new_state = _run_stack(layers, x, state)
        logits = torch.matmul(x, self.head.to(x.dtype).t())
        return logits, new_state, metrics

    # the recurrent carry cannot be bucket-prefilled exactly under padding:
    # serving runs it through ToyServer's decode loop
    prefill_cache_fn = None

    @torch.no_grad()
    def decode_fn(self, state: tuple, tokens: torch.Tensor,
                  cache_len=None) -> tuple:
        """One step of the serving loop: tokens (B, 1) -> (logits, state)."""
        return self({"tokens": tokens}, state=state)[:2]

    def init_cache(self, batch: int, cache_seq: int) -> tuple:
        return _init_state(self.cfg, batch, self.cfg.n_layers, self.rt.dtype,
                           self.rt.device)

    def loss_fn(self, batch: dict) -> tuple:
        logits, _, metrics = self(batch)
        per_tok = xent(logits, batch["labels"], vocab=self.cfg.vocab_size)
        loss = per_tok.mean()
        metrics["xent"] = loss.detach()
        return loss, metrics
