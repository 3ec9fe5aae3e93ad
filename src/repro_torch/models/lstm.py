"""The paper's own models — the port of ``repro/models/lstm.py``: the LM
(Jozefowicz BIGLSTM, 800k vocab; ``parallax-lm``) and the NMT (GNMT-style
LSTM encoder-decoder; ``parallax-nmt``).

LSTM-with-projection cell, a Python loop over time. Each embedding table
goes through the PS pull/push (core/embedding.py, the two CUDA kernels on
the card) under its own planned exchange: the NMT's target table
``embed`` and source table ``enc_embed`` may ride different methods. The
gate, projection, attention and logit products are plain
``torch.matmul``, as the reference leaves them to XLA.

The encoder is what the reference computes: a unidirectional stack run
from zero states (the config's "bidirectional" describes GNMT, not the
reference). The decoder attends to its outputs with the reference's
GNMT-lite dot attention in f32; ``[x, ctx] @ attn_mix`` feeds the head.
The reference serves no encoder-decoder model, so neither does the port.

On a process mesh the cell runs tensor-parallel over ``model``
(``_lstm_layer``): a rank holds H/M units, its gate-strided block of
``w_x`` / ``w_h`` / ``bias`` (its units of each of i, f, g, o;
``core/plan.py::gate_groups``) and their rows of ``w_proj``, so the
elementwise step needs no communication; each time step's projection is
summed over ``model``. The carry's ``c`` is a rank's (B, H/M), ``h``
whole. The encoder's output and the GNMT-lite attention run on the
reduced, whole activations.

Dtypes follow the reference step for step: the lookup returns rows in the
table dtype, cast to the compute dtype; gates are summed in the compute
dtype and cast to f32; the cell state ``c`` stays f32 and ``h`` is cast to
the compute dtype before the projection; the head product runs in the
compute dtype and the loss casts to f32.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.core import collectives as coll
from repro_torch.core import embedding as emb
from repro_torch.core.xent import sharded_xent
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
    d, hidden = cfg.d_model, cfg.d_ff
    vp = rt.padded_vocab
    specs = {
        "embed": ParamSpec((vp, d), ("vocab", "embed"), init="embed", sparse=True),
        "layers": stack_tree(lstm_cell_specs(d, hidden, d), cfg.n_layers),
        "head": ParamSpec((vp, d), ("vocab", "embed"), scale=0.02),
    }
    if cfg.is_encdec:
        specs["enc_layers"] = stack_tree(
            lstm_cell_specs(d, hidden, d), cfg.enc_layers)
        specs["enc_embed"] = ParamSpec((vp, d), ("vocab", "embed"),
                                       init="embed", sparse=True)
        # simple dot cross-attention mixer (GNMT-lite)
        specs["attn_mix"] = ParamSpec((2 * d, d), (None, None),
                                      fan_in_axes=(0,))
    return specs


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b under JAX's dtype promotion (bf16 @ f32 runs in f32)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.matmul(a.to(dt), b.to(dt))


def _lstm_layer(p: dict, xs: torch.Tensor, state: tuple, mesh=None) -> tuple:
    """xs: (B,S,Din); state: (c (B,H) f32, h (B,P)). Loops over time.

    ``mesh``: ``p`` holds this rank's H/M units (``w_x`` / ``w_h`` /
    ``bias`` gate-strided: its units of each of i, f, g, o; ``w_proj``
    their rows) and the cell runs tensor-parallel over ``model``: the
    input and ``h`` feed the column-parallel gate products through
    ``copy_to``, the row-parallel projection's partial sums meet in
    ``reduce_from`` each step (one (B, P) all-reduce a step forward, one
    backward). ``c`` is this rank's (B, H/M); ``h`` is whole."""
    w_x, w_h, bias, w_proj = p["w_x"], p["w_h"], p["bias"], p["w_proj"]
    if mesh is not None:
        xs = coll.copy_to(xs, "model", mesh)
    gx = _mm(xs, w_x)                                  # (B,S,4H) hoisted
    c, h = state
    ys = []
    for t in range(gx.shape[1]):
        h_in = h if mesh is None else coll.copy_to(h, "model", mesh)
        gates = gx[:, t] + _mm(h_in, w_h) + bias
        i, f, g, o = gates.float().chunk(4, dim=-1)
        c = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
        h = _mm((torch.sigmoid(o) * torch.tanh(c)).to(xs.dtype), w_proj)
        if mesh is not None:
            h = coll.reduce_from(h, "model", mesh)
        ys.append(h)
    return torch.stack(ys, dim=1), (c, h)


def _init_state(cfg, batch: int, n_layers: int, dtype: torch.dtype,
                device, hidden: int = None) -> tuple:
    # c stays f32 (the accumulator) at this rank's ``hidden`` units (all
    # of d_ff off a mesh); h matches the activation dtype, whole
    return (torch.zeros((n_layers, batch, hidden or cfg.d_ff),
                        dtype=torch.float32, device=device),
            torch.zeros((n_layers, batch, cfg.d_model), dtype=dtype,
                        device=device))


def _run_stack(layers_p: dict, x: torch.Tensor, states: tuple, *, cfg,
               rt) -> tuple:
    n = next(iter(layers_p.values())).shape[0]
    # tensor-parallel where this rank holds a block of the units
    mesh = rt.mesh if layers_p["w_proj"].shape[1] < cfg.d_ff else None
    cs, hs = states
    new_c, new_h = [], []
    for i in range(n):       # few layers; unrolled for per-layer residuals
        p_i = {k: v[i] for k, v in layers_p.items()}
        y, (c, h) = _lstm_layer(p_i, x, (cs[i], hs[i]), mesh)
        x = x + y if y.shape == x.shape else y
        new_c.append(c)
        new_h.append(h)
    return x, (torch.stack(new_c), torch.stack(new_h))


class LSTMLM(nn.Module):
    """``parallax-lm`` and ``parallax-nmt``: its ``named_parameters()``
    carry the reference's dotted names (embed, head, layers.bias,
    layers.w_h, layers.w_proj, layers.w_x; the NMT adds attn_mix,
    enc_embed and enc_layers.*), enumerated in JAX's flatten order by
    ``utils/tree.py::named_parameters``. Parameters are allocated
    uninitialized; ``init_`` or ``load_`` fills them
    (core/transform.py::build_step)."""

    def __init__(self, cfg, rt):
        super().__init__()
        self.cfg, self.rt = cfg, rt
        specs = model_specs(cfg, rt)
        dev, pdt = rt.param_device, rt.param_dtype
        for name in sorted(specs):
            s = specs[name]
            if isinstance(s, dict):
                self.add_module(name, ParamTree(s, pdt, dev))
            else:
                self.register_parameter(name, nn.Parameter(torch.empty(
                    s.shape, dtype=s.dtype or pdt, device=dev)))

    def specs(self) -> dict:
        return model_specs(self.cfg, self.rt)

    def param_specs(self) -> list:
        """[(dotted_name, ParamSpec)] in JAX's flatten order."""
        return flatten_specs(self.specs())

    def input_specs(self, shape=None) -> dict:
        """{name: (shape, dtype)} of one training batch."""
        shape = shape or self.rt.shape_cfg
        b, s = shape.global_batch, shape.seq_len
        specs = {"tokens": ((b, s), torch.int32),
                 "labels": ((b, s), torch.int32)}
        if self.cfg.is_encdec and shape.kind in ("train", "prefill"):
            specs["src_tokens"] = ((b, s), torch.int32)
        return specs

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
                                tokens.device, self._hidden())
        run = dict(cfg=self.cfg, rt=rt)
        if self.cfg.is_encdec:
            if "src_tokens" not in batch:
                raise ValueError(
                    "parallax-nmt's forward needs the batch's src_tokens; "
                    "the reference serves no encoder-decoder model")
            # each table runs its own planned exchange and reports its own
            # census metrics
            src, m2 = emb.lookup(self.enc_embed, batch["src_tokens"],
                                 ctx=rt.embed_ctx("enc_embed"),
                                 capacity=rt.embed_capacity_for("enc_embed"),
                                 name="enc_embed")
            enc_out, _ = _run_stack(
                dict(self.enc_layers.named_parameters()), src.to(rt.dtype),
                _init_state(self.cfg, b, self.cfg.enc_layers, rt.dtype,
                            tokens.device,
                            self.enc_layers.w_proj.shape[1]), **run)
            metrics.update(m2)
        layers = dict(self.layers.named_parameters())
        x, new_state = _run_stack(layers, x, state, **run)
        if self.cfg.is_encdec:
            # GNMT-lite dot attention over the encoder states, in f32
            enc32 = enc_out.float()
            scores = torch.matmul(x.float(), enc32.transpose(1, 2)) \
                * (self.cfg.d_model ** -0.5)
            ctx_vec = torch.matmul(torch.softmax(scores, -1), enc32).to(
                x.dtype)
            x = _mm(torch.cat([x, ctx_vec], dim=-1), self.attn_mix)
        if rt.vocab_shards > 1:
            x = coll.copy_to(x, "model", rt.mesh)
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

    def _hidden(self) -> int:
        """The units of the cell this rank holds (``w_proj``'s rows)."""
        return self.layers.w_proj.shape[1]

    def init_cache(self, batch: int, cache_seq: int) -> tuple:
        """The zeroed carry of ``batch`` slots: this replica's B/D on a
        serve mesh, each rank's ``c`` at its H/M units."""
        n = max(self.rt.replicas, 1)
        if batch % n:
            raise ValueError(f"{batch} slots do not split over {n} "
                             "replicas")
        return _init_state(self.cfg, batch // n, self.cfg.n_layers,
                           self.rt.dtype, self.rt.device, self._hidden())

    def loss_fn(self, batch: dict, params: dict = None) -> tuple:
        """-> (this replica's mean loss, metrics). ``params``: {dotted
        name: tensor} standing in for parameters in this call (the step's
        FSDP-gathered weights)."""
        if params:
            logits, _, metrics = torch.func.functional_call(
                self, params, (batch,))
        else:
            logits, _, metrics = self(batch)
        rt = self.rt
        per_tok = sharded_xent(logits, batch["labels"], mesh=rt.mesh,
                               model_axis="model", batch_axes=rt.batch_axes,
                               vocab=self.cfg.vocab_size)
        loss = per_tok.mean()
        metrics["xent"] = loss.detach()
        return loss, metrics
