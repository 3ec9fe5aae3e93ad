"""Encoder-decoder backbone (seamless-m4t, family ``audio``): a transformer
encoder over stub frame embeddings and a causal decoder with cross
attention (the port of ``repro/models/encdec.py``).

The cell's ``seq_len`` splits enc:dec as (seq_len // 4, seq_len): audio
frames are time-compressed ~4x by the (stubbed) conformer adaptor, so a
batch carries ``frames`` (B, S // 4, D) beside ``tokens``. Parameters stay
stacked under the reference's dotted names (``enc_layers.attn.wq``,
``dec_layers.cross.wk``, ...); the reference's ``lax.scan`` becomes a
Python loop over the stack. On a process mesh the attention (self and
cross) and the MLP run tensor-parallel over ``model`` as the decoder LM's
do (``transformer.attn_block`` / ``mlp_block``), in training and in
``ToyServer``'s decode on a serve mesh. The decoder's table ``embed``
goes through the PS lookup (the ``embed_gather`` kernel on the card), the
head is untied. With ``attention_impl="pallas"`` outside autograd the encoder's and the
cross attention's non-causal, Sq != Sk products go to the
``flash_attention`` kernel; training runs plain attention.

The decode cache is the reference's 4-tuple (self k, self v, cross k,
cross v), each (n_layers, B, S or S // 4, KV, hd); a decode step takes the
cross K/V from it. ``init_cache`` leaves the cross K/V zero, and
``ToyServer`` (the loop this family serves through, as in the reference)
never runs the encoder: decoding attends over zero cross K/V, a reference
behaviour the port matches (ROADMAP Queue 3).

No counterpart: the reference's ``emb.overlap_gate`` (its manual region's
schedule of the decoder table's push before the encoder's backward);
autograd issues the push where its gradient is ready (ROADMAP Queue 3).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import embedding as emb
from repro_torch.core.xent import sharded_xent
from repro_torch.models.layers import (ParamSpec, ParamTree, flatten_specs,
                                       rms_norm, stack_tree)
from repro_torch.models.transformer import (_head, _layer_params, attn_block,
                                            attn_specs, check_trainable,
                                            mlp_block, mlp_specs, remat)


def enc_ratio(cfg) -> int:
    return 4 if cfg.frontend_stub else 1


def enc_layer_specs(cfg, rt) -> dict:
    d = cfg.d_model
    return {
        "ln1": ParamSpec((d,), (None,), init="ones"),
        "attn": attn_specs(cfg, rt),
        "ln2": ParamSpec((d,), (None,), init="ones"),
        "mlp": mlp_specs(cfg),
    }


def dec_layer_specs(cfg, rt) -> dict:
    d = cfg.d_model
    s = enc_layer_specs(cfg, rt)
    s["ln_cross"] = ParamSpec((d,), (None,), init="ones")
    s["cross"] = attn_specs(cfg, rt)
    return s


def model_specs(cfg, rt) -> dict:
    d = cfg.d_model
    vp = rt.padded_vocab
    return {
        "embed": ParamSpec((vp, d), ("vocab", "embed"), init="embed",
                           sparse=True),
        "enc_layers": stack_tree(enc_layer_specs(cfg, rt), cfg.enc_layers),
        "enc_norm": ParamSpec((d,), (None,), init="ones"),
        "dec_layers": stack_tree(dec_layer_specs(cfg, rt), cfg.n_layers),
        "final_norm": ParamSpec((d,), (None,), init="ones"),
        "head": ParamSpec((vp, d), ("vocab", "embed"), scale=0.02),
    }


def _ffn(p: dict, x: torch.Tensor, cfg, rt) -> torch.Tensor:
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + mlp_block(p["mlp"], h, cfg=cfg, rt=rt)


def _enc_layer(p: dict, x: torch.Tensor, *, cfg, rt, positions):
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    a, _ = attn_block(p["attn"], h, cfg=cfg, rt=rt, positions=positions,
                      causal=False)
    return _ffn(p, x + a, cfg, rt)


def encode(params: dict, frames: torch.Tensor, *, cfg, rt) -> torch.Tensor:
    """frames (B, S_enc, D), the precomputed frontend embeddings (stub) ->
    the normed encoder output."""
    x = frames.to(rt.dtype)
    positions = torch.arange(x.shape[1], device=x.device)
    layer = _enc_layer
    if torch.is_grad_enabled():
        layer = remat(_enc_layer, rt.run_cfg.remat)
    for i in range(cfg.enc_layers):
        x = layer(_layer_params(params, i, "enc_layers."), x, cfg=cfg, rt=rt,
                  positions=positions)
    return rms_norm(x, params["enc_norm"], cfg.norm_eps)


def _cross_kv(p_cross: dict, enc_out: torch.Tensor, cfg, rt) -> tuple:
    b, se, _ = enc_out.shape
    kv, hd = cfg.n_kv_heads, cfg.head_dim
    k = (enc_out @ p_cross["wk"]).reshape(b, se, kv, hd)
    v = (enc_out @ p_cross["wv"]).reshape(b, se, kv, hd)
    return k, v


def _dec_layer(p: dict, x: torch.Tensor, enc_out, layer_cache, *, cfg, rt,
               positions, cache_len):
    """Self attention, cross attention, SwiGLU. The cached path writes its
    self K/V rows into the layer's cache in place and reads the cross K/V
    from it."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    if layer_cache is not None:
        cross_k, cross_v = layer_cache[2], layer_cache[3]
        a, _ = attn_block(p["attn"], h, cfg=cfg, rt=rt, positions=positions,
                          layer_cache=(layer_cache[0], layer_cache[1]),
                          cache_len=cache_len, cache_axes=rt.cache_seq_axes)
    else:
        cross_k, cross_v = _cross_kv(p["cross"], enc_out, cfg, rt)
        a, _ = attn_block(p["attn"], h, cfg=cfg, rt=rt, positions=positions)
    x = x + a
    h = rms_norm(x, p["ln_cross"], cfg.norm_eps)
    c, _ = attn_block(p["cross"], h, cfg=cfg, rt=rt, positions=positions,
                      cross_kv=(cross_k, cross_v), causal=False)
    return _ffn(p, x + c, cfg, rt)


def decode_stack(params: dict, tokens: torch.Tensor,
                 enc_out: Optional[torch.Tensor], *, cfg, rt, cache=None,
                 cache_len=None) -> tuple:
    """The decoder over text tokens with cross attention to ``enc_out`` (or
    to the cached cross K/V). -> (logits, cache or None, metrics); the
    cache's self K/V rows are written in place."""
    b, s = tokens.shape
    x, metrics = emb.lookup(params["embed"], tokens, ctx=rt.embed_ctx(),
                            capacity=rt.embed_capacity_for("embed"))
    x = x.to(rt.dtype)
    base = torch.as_tensor(0 if cache_len is None else cache_len,
                           device=tokens.device)
    steps = torch.arange(s, device=tokens.device)
    # a (B,) cache_len: per-slot positions (attn_block masks per slot)
    positions = base[:, None] + steps[None, :] if base.dim() == 1 \
        else base + steps
    layer = _dec_layer
    if cache is None and torch.is_grad_enabled():
        layer = remat(_dec_layer, rt.run_cfg.remat)
    for i in range(cfg.n_layers):
        layer_cache = None if cache is None else tuple(c[i] for c in cache)
        x = layer(_layer_params(params, i, "dec_layers."), x, enc_out,
                  layer_cache, cfg=cfg, rt=rt, positions=positions,
                  cache_len=cache_len)
    return _head(params, x, cfg, rt), cache, metrics


def forward(params: dict, batch: dict, *, cfg, rt, cache=None,
            cache_len=None) -> tuple:
    """The training / prefill forward over {frames, tokens}; with a cache,
    one decode step over {tokens}."""
    if cache is not None:
        return decode_stack(params, batch["tokens"], None, cfg=cfg, rt=rt,
                            cache=cache, cache_len=cache_len)
    enc_out = encode(params, batch["frames"], cfg=cfg, rt=rt)
    return decode_stack(params, batch["tokens"], enc_out, cfg=cfg, rt=rt)


def init_cache(cfg, rt, batch: int, cache_seq: int, enc_seq: int,
               dtype: Optional[torch.dtype] = None) -> tuple:
    """(self k, self v, cross k, cross v), each (n_layers, B, S or S_enc,
    KV, hd), zeroed. On a process mesh this rank's block: the slots over
    the batch axes, the self K/V's positions over ``cache_seq_axes`` (as
    the decoder LM's cache); the cross K/V, which decoding reads whole,
    stay whole over ``model``, where the reference's ``cache_pspec_tree``
    shards them too (ROADMAP Queue 3: bytes only)."""
    dtype = dtype or rt.dtype
    kv, hd = cfg.n_kv_heads, cfg.head_dim
    b_loc, s_loc, _ = rt.cache_shard(batch, cache_seq)
    return tuple(torch.zeros((cfg.n_layers, b_loc, seq, kv, hd),
                             dtype=dtype, device=rt.device)
                 for seq in (s_loc, s_loc, enc_seq, enc_seq))


def cache_pspec_tree(cfg, rt) -> Optional[tuple]:
    """The reference's placement of the 4-tuple cache, as a record (axis
    names per dimension); None off a mesh. The port's cache follows it
    but for the cross K/V, whole over ``model`` (``init_cache``)."""
    if rt.mesh is None:
        return None
    kvspec = (None, rt.rules.rules.get("batch"), rt.rules.rules.get("kv_seq"),
              None, None)
    return (kvspec,) * 4


class EncDecLM(ParamTree):
    """The encoder-decoder LM (``seamless-m4t-medium``). Its
    ``named_parameters()`` carry the reference's dotted names (embed,
    enc_layers.attn.wq, enc_norm, dec_layers.cross.wk, dec_layers.ln_cross,
    final_norm, head, ...). It serves through ``ToyServer``'s decode loop
    (no ``prefill_cache_fn``: its prefill needs the encoder's inputs)."""

    prefill_cache_fn = None

    def __init__(self, cfg, rt):
        super().__init__(model_specs(cfg, rt), rt.param_dtype,
                         rt.param_device)
        self.cfg, self.rt = cfg, rt

    def specs(self) -> dict:
        return model_specs(self.cfg, self.rt)

    def param_specs(self) -> list:
        """[(dotted_name, ParamSpec)] in JAX's flatten order."""
        return flatten_specs(self.specs())

    def params(self) -> dict:
        return dict(self.named_parameters())

    def input_specs(self, shape=None) -> dict:
        """{name: (shape, dtype)} of one step's inputs; train and prefill
        carry ``frames`` (B, S // 4, D)."""
        shape = shape or self.rt.shape_cfg
        b, s = shape.global_batch, shape.seq_len
        if shape.kind == "decode":
            return {"tokens": ((b, 1), torch.int32),
                    "cache_len": ((), torch.int32)}
        specs = {"tokens": ((b, s), torch.int32),
                 "frames": ((b, s // enc_ratio(self.cfg), self.cfg.d_model),
                            torch.bfloat16)}
        if shape.kind == "train":
            specs["labels"] = ((b, s), torch.int32)
        return specs

    def forward(self, batch: dict) -> tuple:
        """The training forward: -> (logits (B, S, Vp / M), None,
        metrics)."""
        return forward(self.params(), batch, cfg=self.cfg, rt=self.rt)

    def loss_fn(self, batch: dict, params: dict = None) -> tuple:
        """-> (this replica's mean loss, metrics). ``params``: {dotted
        name: tensor} standing in for parameters in this call."""
        rt = self.rt
        check_trainable(rt.run_cfg)
        if params:
            logits, _, metrics = torch.func.functional_call(
                self, params, (batch,))
        else:
            logits, _, metrics = self(batch)
        per_tok = sharded_xent(logits, batch["labels"], mesh=rt.mesh,
                               model_axis="model", batch_axes=rt.batch_axes,
                               vocab=self.cfg.vocab_size)
        loss = per_tok.mean()
        metrics["xent"] = loss.detach()
        return loss, metrics

    @torch.no_grad()
    def prefill_fn(self, batch: dict) -> tuple:
        """{frames, tokens} -> (logits, None, metrics)."""
        return forward(self.params(), batch, cfg=self.cfg, rt=self.rt)

    @torch.no_grad()
    def decode_fn(self, cache: tuple, tokens: torch.Tensor,
                  cache_len) -> tuple:
        """-> (logits (B, 1, Vp), cache written in place)."""
        logits, new_cache, _ = forward(self.params(), {"tokens": tokens},
                                       cfg=self.cfg, rt=self.rt, cache=cache,
                                       cache_len=cache_len)
        return logits, new_cache

    def init_cache(self, batch: int, cache_seq: int) -> tuple:
        return init_cache(self.cfg, self.rt, batch, cache_seq,
                          cache_seq // enc_ratio(self.cfg))
