"""Decoder LM of the dense, moe, vlm, hybrid and ssm families (the port of
``repro/models/transformer.py``).

Parameters stay stacked over layers, under the reference's dotted names
(``layers.attn.wq`` is (n_layers, d, H*hd), and so on), so
``weights.load_reference_params`` carries a reference model across by name;
the reference's ``lax.scan`` over that stack becomes a Python loop over
``params["layers.*"][i]`` (views, no copies). The embedding goes through the
PS lookup (core/embedding.py, the ``embed_gather`` kernel on the card); with
``attention_impl="pallas"`` the cache-less attention goes to the
``flash_attention`` kernel.

The moe family (``grok-1-314b``, ``llama4-maverick-400b-a17b``) swaps the
dense MLP for ``models/moe.py``'s routed experts (``layers.moe.*``); its
``moe_aux`` and ``moe_dropped`` are summed over the layers, and the loss
adds ``0.01 * moe_aux / n_layers``, as the reference's. The expert
execution (``ep`` / ``tp``) is picked once per forward, as there.

The vlm family (``chameleon-34b``) runs the dense layers; ``forward`` adds
its precomputed frontend ``embeds`` after the lookup, as the reference does.
The hybrid family (``hymba-1.5b``) runs attention and ``models/ssm.py``'s
selective SSM on the same normed input and averages them. The ssm family
(``rwkv6-7b``) swaps the decoder layer for ``models/rwkv.py``'s block, whose
WKV goes to the ``wkv`` kernel in serving and to the chunked form under
autograd.

The dense and vlm decode cache is the reference's tuple ``(k, v)`` of
(n_layers, B, S, KV, hd) tensors; the hybrid cache adds the SSM state,
``(k, v, h (n_layers, B, D, N) f32)``; the ssm cache is its recurrent carry
``(tm_x (n_layers, B, D), state (n_layers, B, H, E, E) f32, cm_x
(n_layers, B, D))``. Where JAX returns an updated cache, the port writes the
new rows (or carry, or state) into the given tensors in place and returns
them.

Training (``DenseLM.loss_fn``) runs the cache-less path under autograd
through plain attention (``naive`` or ``chunked``): the reference's Pallas
flash kernel is forward-only, so ``attention_impl="pallas"`` is refused in
a training step. ``RunConfig.remat`` recomputes each layer in the
backward as the reference's ``jax.checkpoint`` does (``block``: the
matmul outputs saved, the counterpart of
``dots_with_no_batch_dims_saveable``; ``full``: the whole layer
recomputed).

On a process mesh the attention block and the SwiGLU MLP (and the MoE's
shared expert) run tensor-parallel over ``model`` in Megatron's form: each
rank holds its block of the padded q heads (``wq`` / ``wo``) and of d_ff
(``ParamPlan.held``), ``copy_to`` before the column-parallel products,
``reduce_from`` after the row-parallel ones; K/V come from the replicated
``wk`` / ``wv`` on every rank. The residual stream is whole on every model
rank, and the head is vocab-sharded: ``coll.copy_to`` sums the
activation's gradient over ``model`` before it, and a tied head reads this
rank's rows of the table (below). Under ``RunConfig.explicit_sp`` the
dense and vlm families hold the residual sequence-sharded between the
blocks and run them through ``core/sp.py`` (``sp_residual``). The hybrid
family's selective SSM (``models/ssm.py``: its channels), the ssm family's
RWKV time and channel mixes (``models/rwkv.py``: its heads and d_ff) and
the routed experts under ``tp`` (``models/moe.py``: their d_ff) run
tensor-parallel over ``model`` too, each keyed on the held shape of its
leaves; their recurrent carries are each rank's share (the SSM state
(B, D/M, N), the WKV state (B, H/M, E, E): ``init_cache``). In serving
the decode cache is sequence-sharded over ``model`` ((n_layers, B/D, S/M,
KV, hd) a rank, ``init_cache``): each rank writes the positions it holds,
attends with every q head over them and merges the partial softmaxes
over ``model`` (``attention.decode_attention``).

``attn_block`` also takes the encoder-decoder's cross attention
(``cross_kv``: K/V from the encoder, no RoPE, never causal) for
``models/encdec.py``.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

from repro_torch.core import collectives as coll
from repro_torch.core import embedding as emb
from repro_torch.core import sp
from repro_torch.core.xent import sharded_xent
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import rwkv as rwkv_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (ParamSpec, ParamTree, flatten_specs,
                                       rms_norm, stack_tree, swiglu)

_LAYERS = "layers."


@functools.lru_cache(maxsize=64)
def _qmap(n_heads: int, n_kv: int, padded: int, device: torch.device,
          lo: int = 0, count: int = None):
    """``make_qmap`` once per shape, head block and device: the map is a
    host list, and building it as a device tensor in every layer of every
    step would be a host-to-device copy each time. Nothing mutates the
    cached tensor."""
    return attn_mod.make_qmap(n_heads, n_kv, padded, device=device, lo=lo,
                              count=count)


# the families whose every block runs the explicit sequence-parallel
# schedule (attention and the SwiGLU MLP); the others keep the residual
# whole on every model rank and run their attention and MLP
# tensor-parallel (the same values)
SP_FAMILIES = ("dense", "vlm")


def check_trainable(run_cfg) -> None:
    """Refuse, by name, a training step the dense family cannot run."""
    if run_cfg.attention_impl == "pallas":
        raise NotImplementedError(
            "attention_impl='pallas' in a training step: the reference's "
            "Pallas flash kernel is forward-only (jax.grad through it "
            "fails), so training runs plain attention; use 'naive' or "
            "'chunked' (serving keeps the flash kernel)")


# ---------------------------------------------------------------------------
# specs
# ---------------------------------------------------------------------------

def attn_specs(cfg, rt) -> dict:
    d, hd = cfg.d_model, cfg.head_dim
    hp = rt.pad_heads(cfg.n_heads)
    kv = cfg.n_kv_heads
    return {
        "wq": ParamSpec((d, hp * hd), (None, "heads_hd"), fan_in_axes=(0,),
                        init="normal"),
        "wk": ParamSpec((d, kv * hd), (None, "kv_heads"), fan_in_axes=(0,)),
        "wv": ParamSpec((d, kv * hd), (None, "kv_heads"), fan_in_axes=(0,)),
        "wo": ParamSpec((hp * hd, d), ("heads_hd", None), fan_in_axes=(0,)),
    }


def mlp_specs(cfg) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "w_gate": ParamSpec((d, f), (None, "mlp"), fan_in_axes=(0,)),
        "w_up": ParamSpec((d, f), (None, "mlp"), fan_in_axes=(0,)),
        "w_down": ParamSpec((f, d), ("mlp", None), fan_in_axes=(0,)),
    }


def layer_specs(cfg, rt, moe_exec: str = "tp") -> dict:
    if cfg.family == "ssm":
        return rwkv_mod.rwkv_block_specs(cfg)
    if cfg.family not in ("dense", "moe", "vlm", "hybrid"):
        raise ValueError(f"family {cfg.family!r} has no decoder-LM layers")
    d = cfg.d_model
    specs = {
        "ln1": ParamSpec((d,), (None,), init="ones"),
        "attn": attn_specs(cfg, rt),
        "ln2": ParamSpec((d,), (None,), init="ones"),
    }
    if cfg.family == "moe":
        specs["moe"] = moe_mod.moe_specs(cfg, moe_exec)
    else:
        specs["mlp"] = mlp_specs(cfg)
    if cfg.family == "hybrid":
        specs["ssm"] = ssm_mod.ssm_specs(cfg)
    return specs


def model_specs(cfg, rt) -> dict:
    d = cfg.d_model
    vp = rt.padded_vocab
    moe_exec = moe_mod.pick_exec_mode(cfg, rt) if cfg.n_experts else "tp"
    specs = {
        "embed": ParamSpec((vp, d), ("vocab", "embed"), init="embed",
                           sparse=True),
        "layers": stack_tree(layer_specs(cfg, rt, moe_exec), cfg.n_layers),
        "final_norm": ParamSpec((d,), (None,), init="ones"),
    }
    if not cfg.tie_embeddings:
        specs["head"] = ParamSpec((vp, d), ("vocab", "embed"), scale=0.02)
    return specs


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def _write_cache(cache: torch.Tensor, new: torch.Tensor, cache_len,
                 offset: int = 0, total: Optional[int] = None) -> None:
    """Write this step's K or V rows into one layer's (B, S, KV, hd) cache,
    in place. ``offset``: the global position of the cache's first row (a
    rank's block of a sequence-sharded cache of ``total`` positions); a
    row whose position lies outside the block is written on the rank that
    holds it.

    Per-slot ``cache_len`` (a (B,) tensor): row b lands at position
    cache_len[b], and a slot with cache_len outside this block writes
    nowhere (the reference's one-hot select). Computed without a host
    sync: the position is clamped into range and an out-of-range slot
    writes back the bits it read. Scalar ``cache_len``: the rows land at
    cache_len, with the start clamped into [0, total - s] as
    ``dynamic_update_slice`` clamps it."""
    b, s_cache = cache.shape[:2]
    new = new.to(cache.dtype)
    cl = cache_len
    if isinstance(cl, torch.Tensor) and cl.dim() == 1:
        if new.shape[1] != 1:
            raise ValueError("a per-slot cache write takes one token per "
                             f"slot, got {new.shape[1]}")
        rows = torch.arange(b, device=cache.device)
        cl = cl.to(cache.device).long() - offset
        pos = cl.clamp(0, s_cache - 1)
        hit = ((cl >= 0) & (cl < s_cache))[:, None, None]
        cache[rows, pos] = torch.where(hit, new[:, 0], cache[rows, pos])
        return
    s = new.shape[1]
    total = s_cache if total is None else total
    start = max(0, min(int(cl), total - s))
    lo, hi = max(start, offset), min(start + s, offset + s_cache)
    if lo < hi:
        cache[:, lo - offset:hi - offset] = new[:, lo - start:hi - start]


def _tp_mesh(rt, local: int, whole: int):
    """The mesh a block runs tensor-parallel over when its weights hold
    ``local`` of ``whole`` columns on this rank (``ParamPlan.held``), else
    None."""
    return rt.mesh if local < whole else None


def attn_block(p: dict, x: torch.Tensor, *, cfg, rt, positions,
               layer_cache: Optional[tuple] = None, cache_len=None,
               cross_kv: Optional[tuple] = None, causal: bool = True,
               return_kv: bool = False, sp_on: bool = False,
               cache_axes: tuple = ()) -> tuple:
    """Self (or cross) attention sub-block. Returns (out, new_cache).

    ``cross_kv``: (K, V) of the encoder, (B, Se, KV, hd); then q takes no
    RoPE, the attention is never causal and nothing is cached.
    ``return_kv``: on the cache-less path, hand back this layer's (K, V) at
    the compute dtype — the serving engine's batched prefill collects them
    across layers and inserts the rows into the live decode cache.

    On a process mesh whose ``wq`` / ``wo`` hold this rank's block of the
    padded q heads the block runs tensor-parallel over ``model``
    (Megatron's form): ``copy_to`` before the column-parallel ``wq``, K/V
    on every rank from the replicated ``wk`` / ``wv`` (their gradient
    summed over ``model``, as the reference's replicated K/V's is), the
    attention of this rank's heads, and ``reduce_from`` after the
    row-parallel ``wo``. ``sp_on``: ``x`` is this rank's sequence block and
    the projections run ``core/sp.py``'s schedule. ``cache_axes``: the
    mesh axes ``layer_cache``'s positions are sharded over; then every
    rank attends with all q heads over its positions, the partials are
    merged (``attention.decode_attention``) and the rank keeps its own
    heads for the o-proj."""
    b, s, _ = x.shape
    hd = cfg.head_dim
    hp = rt.pad_heads(cfg.n_heads)
    kv = cfg.n_kv_heads
    hl = p["wq"].shape[-1] // hd                 # this rank's q heads
    mesh = _tp_mesh(rt, hl, hp)
    lo = rt.model_index * hl if mesh is not None else 0
    qmap = _qmap(cfg.n_heads, kv, hp, x.device, lo, hl)

    replicated_kv = True
    if sp_on:
        if sp.kv_local_favorable(rt, cfg):
            # replicated K/V weights: a sequence-local matmul and a small
            # output all-gather, whose cotangent stays each rank's share
            (qf,) = sp.proj_in(rt, x, [p["wq"]], [True])
            kf, vf = sp.local_proj(rt, x, [p["wk"], p["wv"]])
            replicated_kv = False
        else:
            qf, kf, vf = sp.proj_in(rt, x, [p["wq"], p["wk"], p["wv"]],
                                    [True, False, False])
        s = qf.shape[1]
        q = qf.reshape(b, s, hl, hd)
        k = kf.reshape(b, s, kv, hd)
        v = vf.reshape(b, s, kv, hd)
        if cfg.rope_theta:
            q = attn_mod.rope(q, positions, cfg.rope_theta)
            k = attn_mod.rope(k, positions, cfg.rope_theta)
    else:
        xq = x if mesh is None else coll.copy_to(x, "model", mesh)
        q = (xq @ p["wq"]).reshape(b, s, hl, hd)
        if cross_kv is None:
            k = (x @ p["wk"]).reshape(b, s, kv, hd)
            v = (x @ p["wv"]).reshape(b, s, kv, hd)
            if cfg.rope_theta:
                q = attn_mod.rope(q, positions, cfg.rope_theta)
                k = attn_mod.rope(k, positions, cfg.rope_theta)
        else:
            k, v = cross_kv
    if mesh is not None and replicated_kv:
        # every rank's heads read K/V: the gradient is summed over model
        k, v = coll.copy_to(k, "model", mesh), coll.copy_to(v, "model", mesh)

    if layer_cache is not None:
        k_cache, v_cache = layer_cache
        off = total = 0
        if cache_axes:
            off = rt.mesh.index(cache_axes) * k_cache.shape[1]
            total = k_cache.shape[1] * rt.mesh.axes_size(cache_axes)
        if cross_kv is None:
            _write_cache(k_cache, k, cache_len, off, total or None)
            _write_cache(v_cache, v, cache_len, off, total or None)
        if mesh is not None and cache_axes:
            # all q heads over this rank's positions; own heads kept below
            qa = coll.all_gather(q, "model", mesh, dim=2)
            out = attn_mod.decode_attention(
                qa, k_cache, v_cache,
                cache_len + (1 if cross_kv is None else 0),
                qmap=_qmap(cfg.n_heads, kv, hp, x.device), mesh=rt.mesh,
                axes=cache_axes, kv_offset=off)[:, :, lo:lo + hl]
        else:
            out = attn_mod.decode_attention(
                q, k_cache, v_cache,
                cache_len + (1 if cross_kv is None else 0), qmap=qmap,
                mesh=rt.mesh if cache_axes else None, axes=cache_axes,
                kv_offset=off)
        new_cache = (k_cache, v_cache)
    else:
        out = attn_mod.attention(
            q, k, v, impl=rt.run_cfg.attention_impl,
            causal=causal and cross_kv is None,
            chunk=rt.run_cfg.attention_chunk, qmap=qmap)
        new_cache = (k.to(rt.dtype), v.to(rt.dtype)) \
            if return_kv and cross_kv is None else None
    if hp > cfg.n_heads:
        # padded heads zeroed before the o-proj, as the reference does
        # (per shard: this rank's heads lo .. lo + hl): their columns get
        # no gradient, so padding changes no value
        keep = lo + torch.arange(hl, device=out.device) < cfg.n_heads
        out = out * keep.to(out.dtype)[None, None, :, None]
    out = out.reshape(b, out.shape[1], hl * hd)
    if sp_on:
        return sp.proj_out(rt, out, p["wo"]), new_cache
    out = out @ p["wo"]
    if mesh is not None:
        out = coll.reduce_from(out, "model", mesh)
    return out, new_cache


def mlp_block(p: dict, x: torch.Tensor, *, cfg, rt,
              sp_on: bool = False) -> torch.Tensor:
    """The SwiGLU MLP: tensor-parallel over ``model`` where ``p`` holds
    this rank's d_ff block; under ``sp_on`` through ``core/sp.py``."""
    if sp_on:
        g, u = sp.proj_in(rt, x, [p["w_gate"], p["w_up"]], [True, True])
        return sp.proj_out(rt, torch.nn.functional.silu(g) * u, p["w_down"])
    return swiglu(x, p["w_gate"], p["w_up"], p["w_down"],
                  mesh=_tp_mesh(rt, p["w_gate"].shape[-1], cfg.d_ff))


def decoder_layer(p: dict, x: torch.Tensor, *, cfg, rt, positions,
                  layer_cache=None, cache_len=None, moe_exec: str = "tp",
                  collect_kv: bool = False, sp_on: bool = False) -> tuple:
    """Pre-norm decoder layer; returns (x, new_cache, metrics). The hybrid
    family (hymba) runs attention and the SSM on the same normed input and
    averages them; its layer cache is (k, v, h_ssm), and the new one
    carries the SSM's new state (a new tensor, not written in place). The
    moe family's FFN is ``moe_ffn`` under ``moe_exec``, whose routing
    metrics the layer returns; a remat recompute routes the same inputs
    to the same dispatch. ``sp_on``: ``x`` is this rank's sequence block
    (``core/sp.py``); the norms' weights then see only its tokens, so
    their gradients are summed over ``model``."""
    ln1, ln2 = p["ln1"], p["ln2"]
    if sp_on:
        ln1 = coll.copy_to(ln1, "model", rt.mesh)
        ln2 = coll.copy_to(ln2, "model", rt.mesh)
    cache_axes = rt.cache_seq_axes if layer_cache is not None else ()
    h = rms_norm(x, ln1, cfg.norm_eps)
    if cfg.family == "hybrid":
        kv_cache = layer_cache[:2] if layer_cache is not None else None
        h_ssm = layer_cache[2] if layer_cache is not None else \
            ssm_mod.init_ssm_state(cfg, x.shape[0], x.device,
                                   p["ssm"]["w_in"].shape[-1])
        attn_out, new_kv = attn_block(
            p["attn"], h, cfg=cfg, rt=rt, positions=positions,
            layer_cache=kv_cache, cache_len=cache_len, return_kv=collect_kv,
            cache_axes=cache_axes)
        ssm_out, h_ssm = ssm_mod.ssm_mix(p["ssm"], h, h_ssm, cfg=cfg, rt=rt)
        attn_out = (attn_out + ssm_out) * 0.5
        new_cache = (*new_kv, h_ssm) if new_kv is not None else None
    else:
        attn_out, new_cache = attn_block(
            p["attn"], h, cfg=cfg, rt=rt, positions=positions,
            layer_cache=layer_cache, cache_len=cache_len,
            return_kv=collect_kv, sp_on=sp_on, cache_axes=cache_axes)
    x = x + attn_out
    h2 = rms_norm(x, ln2, cfg.norm_eps)
    if cfg.family == "moe":
        ffn_out, metrics = moe_mod.moe_ffn(p["moe"], h2, cfg=cfg, rt=rt,
                                           exec_mode=moe_exec)
        return x + ffn_out, new_cache, metrics
    return x + mlp_block(p["mlp"], h2, cfg=cfg, rt=rt, sp_on=sp_on), \
        new_cache, {}


# ---------------------------------------------------------------------------
# full model
# ---------------------------------------------------------------------------

def rt_residual_axes(rt, x: torch.Tensor) -> tuple:
    """The residual stream's placement: sequence-parallel when the
    sequence divides the ``seq_sp`` axis (the reference pins it with
    ``rt.constrain``). Under ``RunConfig.explicit_sp`` it drives execution:
    ``forward`` holds each rank's sequence block between the blocks where
    it reads ``seq_sp`` (``sp_residual``)."""
    s = x.shape[1]
    m = rt.rules.axis_size("seq_sp")
    if rt.shape_cfg.kind != "decode" and m > 1 and s % m == 0:
        return ("batch", "seq_sp", None)
    return ("batch", None, None)


def sp_residual(cfg, rt, x: torch.Tensor) -> bool:
    """Does this forward hold the residual sequence-sharded and run every
    block through ``core/sp.py``? Under ``explicit_sp``, for the families
    whose blocks are all attention and SwiGLU (``SP_FAMILIES``), when the
    residual is placed on ``seq_sp`` and the MLP's d_ff is sharded too."""
    return (cfg.family in SP_FAMILIES and sp.sp_active(rt, x)
            and rt_residual_axes(rt, x)[1] == "seq_sp"
            and cfg.d_ff % rt.model_size == 0)


def _held_widths(params: dict, cfg) -> dict:
    """This rank's share of the recurrent carries' widths, read off the
    held leaves: the WKV heads (``tm.w_r``'s columns) and the SSM
    channels (``ssm.w_in``'s); None where the family has no such block."""
    out = {"heads": None, "channels": None}
    if "layers.tm.w_r" in params:
        out["heads"] = params["layers.tm.w_r"].shape[-1] // cfg.head_dim
    if "layers.ssm.w_in" in params:
        out["channels"] = params["layers.ssm.w_in"].shape[-1]
    return out


def _layer_carry_init(cfg, rt, batch: int, cache_seq: int,
                      dtype: torch.dtype, widths: dict) -> tuple:
    """One layer's zeroed decode cache (``init_cache`` stacks it): on a
    process mesh this rank's block, (B/D, S/M, KV, hd), the slots over the
    batch axes and the positions over ``cache_seq_axes``; the SSM state
    and the WKV state at this rank's ``widths`` (``_held_widths``)."""
    hd, kv = cfg.head_dim, cfg.n_kv_heads
    batch, cache_seq, _ = rt.cache_shard(batch, cache_seq)
    if cfg.family == "ssm":
        return rwkv_mod.init_rwkv_carry(cfg, batch, dtype, rt.device,
                                        widths["heads"])
    kvc = tuple(torch.zeros((batch, cache_seq, kv, hd), dtype=dtype,
                            device=rt.device) for _ in range(2))
    if cfg.family == "hybrid":
        return (*kvc, ssm_mod.init_ssm_state(cfg, batch, rt.device,
                                             widths["channels"]))
    return kvc


def init_cache(cfg, rt, batch: int, cache_seq: int,
               dtype: Optional[torch.dtype] = None,
               params: Optional[dict] = None) -> tuple:
    """Zeroed decode cache, each layer's stacked: (k, v), each
    (n_layers, B, S, KV, hd) — on a process mesh (n_layers, B/D, S/M, KV,
    hd), as the reference's ``cache_pspec_tree`` places it; hybrid adds
    the SSM state (n_layers, B, D, N) f32; for the ssm family the carry
    (tm_x, state, cm_x) of every layer, whatever ``cache_seq``. ``params``
    (the held leaves): on a mesh the SSM state is this rank's (B/D, D/M,
    N) and the WKV state its (B/D, H/M, E, E), where the reference's
    ``cache_pspec_tree`` keeps both whole over ``model`` (ROADMAP Queue
    3: bytes only)."""
    one = _layer_carry_init(cfg, rt, batch, cache_seq, dtype or rt.dtype,
                            _held_widths(params or {}, cfg))
    return tuple(torch.zeros((cfg.n_layers, *a.shape), dtype=a.dtype,
                             device=a.device) for a in one)


def _layer_params(params: dict, i: int, stack: str = _LAYERS) -> dict:
    """Layer i of the stacked ``layers.*`` parameters (or another stack's,
    e.g. ``enc_layers.``) as the nested dict the blocks read
    (``p["attn"]["wq"]``); each leaf is a view."""
    out: dict = {}
    for name, t in params.items():
        if not name.startswith(stack):
            continue
        *path, leaf = name[len(stack):].split(".")
        node = out
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = t[i]
    return out


def forward(params: dict, tokens: torch.Tensor, *, cfg, rt, cache=None,
            cache_len=None, embeds: Optional[torch.Tensor] = None,
            collect_kv: bool = False) -> tuple:
    """tokens (B, S) -> logits (B, S, Vp), new cache, metrics.

    ``params``: {dotted_name: tensor}. ``cache_len`` may be a scalar
    (homogeneous batch) or a per-slot (B,) tensor (the serving engine's
    slot-paged decode). ``collect_kv`` makes the cache-less (prefill) path
    return the per-layer K/V stack, (n_layers, B, S, KV, hd) each, instead
    of None (hybrid: also the per-layer SSM states). ``embeds`` (B, S, D):
    precomputed frontend embeddings (the vlm stub) added after the lookup.
    The ssm family always carries state: without a cache it starts a fresh
    carry and returns it as the new cache, and it ignores ``cache_len``."""
    b, s = tokens.shape
    x, metrics = emb.lookup(params["embed"], tokens, ctx=rt.embed_ctx(),
                            capacity=rt.embed_capacity_for("embed"))
    x = x.to(rt.dtype)
    if embeds is not None:
        x = x + embeds.to(rt.dtype)
    if cfg.family == "ssm":
        # a given cache is written in place; a fresh carry is stacked from
        # the layers' new carries (autograd may still need the zeros read)
        fresh = cache is None
        if fresh:
            # this call's rows: ``b`` is already this replica's batch on a
            # mesh (init_cache cuts a global serving batch)
            cache = tuple(torch.zeros((cfg.n_layers, *a.shape),
                                      dtype=a.dtype, device=a.device)
                          for a in rwkv_mod.init_rwkv_carry(
                              cfg, b, rt.dtype, rt.device,
                              _held_widths(params, cfg)["heads"]))
        block = rwkv_mod.rwkv_block
        if torch.is_grad_enabled():
            block = remat(block, rt.run_cfg.remat)
        carries = []
        for i in range(cfg.n_layers):
            x, new_carry = block(
                _layer_params(params, i), x, tuple(c[i] for c in cache),
                cfg=cfg, rt=rt)
            if fresh:
                carries.append(new_carry)
            else:
                for c, new in zip(cache, new_carry):
                    c[i].copy_(new)
        if fresh:
            cache = tuple(torch.stack(c) for c in zip(*carries))
        return _head(params, x, cfg, rt), cache, metrics
    dev = tokens.device

    if cache_len is None and cache is None:
        positions = torch.arange(s, device=dev)
    else:
        base = torch.as_tensor(0 if cache_len is None else cache_len,
                               device=dev)
        if base.dim() == 1:
            positions = base[:, None] + torch.arange(s, device=dev)[None, :]
        else:
            positions = base + torch.arange(s, device=dev)

    moe_exec = moe_mod.pick_exec_mode(cfg, rt) if cfg.n_experts else "tp"
    sp_on = cache is None and not collect_kv and sp_residual(cfg, rt, x)
    if sp_on:
        # this rank's sequence block from here to the head
        x = coll.split_to(x, "model", rt.mesh, dim=1)
    layer = decoder_layer
    if cache is None and not collect_kv and torch.is_grad_enabled():
        # the training forward: each layer under the run's remat
        layer = remat(decoder_layer, rt.run_cfg.remat)
    collected = []
    layer_metrics: dict = {}
    for i in range(cfg.n_layers):
        layer_cache = None if cache is None else tuple(c[i] for c in cache)
        x, new_c, lm = layer(
            _layer_params(params, i), x, cfg=cfg, rt=rt, positions=positions,
            layer_cache=layer_cache, cache_len=cache_len, moe_exec=moe_exec,
            collect_kv=collect_kv, sp_on=sp_on)
        for k, v in lm.items():         # summed over the layers
            layer_metrics[k] = v if k not in layer_metrics \
                else layer_metrics[k] + v
        if cache is not None and cfg.family == "hybrid":
            cache[2][i].copy_(new_c[2])      # the SSM state, a new tensor
        elif cache is None and collect_kv:
            collected.append(new_c)
    if cache is not None:
        new_cache = cache
    elif collect_kv:
        new_cache = tuple(torch.stack(c) for c in zip(*collected))
    else:
        new_cache = None
    return (_head(params, x, cfg, rt, sp_on), new_cache,
            {**layer_metrics, **metrics})


# matmuls with no batch dimension: ``x @ w`` of a (B, S, D) activation
# reaches the dispatcher as ``mm`` on (B·S, D); attention's einsums are
# ``bmm`` (batched) and are recomputed, as under the reference's policy
_SAVED_MATMULS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_matmuls(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_MATMULS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def remat(fn, mode: str):
    """``fn`` under ``RunConfig.remat`` (the reference's ``jax.checkpoint``
    around each layer): ``none`` keeps every activation; ``block`` keeps
    the matmul outputs and recomputes the rest in the backward (the
    counterpart of ``dots_with_no_batch_dims_saveable``); ``full`` keeps
    only the layer's inputs and recomputes the layer. The values are the
    same under all three."""
    if mode == "none":
        return fn
    if mode not in ("block", "full"):
        raise ValueError(f"unknown remat {mode!r} (none | block | full)")
    from torch.utils.checkpoint import (checkpoint,
                                        create_selective_checkpoint_contexts)
    kw = {}
    if mode == "block":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_matmuls)

    def run(*args, **kwargs):
        return checkpoint(fn, *args, use_reentrant=False, **kw, **kwargs)
    return run


def _tied_head(table: torch.Tensor, rt) -> torch.Tensor:
    """The head a tied table gives this rank: its rows of the vocab
    shard the logits cover, with the gradient summed where the table's
    other gradient, the lookup's push, arrives summed.

    A pushed table (ps, ps_gather, mpi_gatherv) comes out of the lookup's
    backward already summed over the replicas, and the step only scales it
    by 1/N; so the head's part is summed over the batch axes too (the
    reference's GSPMD step sums both). A replicated table (mpi_gatherv or
    the dense exchange) under a vocab-sharded head is cut to this model
    rank's rows, and the gradient summed over ``model`` puts every rank's
    rows back together, so every model rank holds the same gradient."""
    mesh = rt.mesh
    if mesh is None:
        return table
    axes = ()
    if rt.replicas > 1 and rt.embed_ctx().method in emb.PUSHED:
        axes = tuple(rt.batch_axes)
    vs = rt.padded_vocab // rt.vocab_shards
    cut = rt.vocab_shards > 1 and table.shape[0] != vs
    if cut:
        axes += ("model",)
    if axes:
        table = coll.copy_to(table, axes, mesh)
    if cut:
        m = mesh.coords["model"]
        table = table[m * vs:(m + 1) * vs]
    return table


def _head(params: dict, x: torch.Tensor, cfg, rt,
          sp_on: bool = False) -> torch.Tensor:
    """The final norm and the vocab projection (this rank's vocab shard on
    a mesh, its input's gradient summed over ``model``). ``sp_on``: ``x``
    is this rank's sequence block, gathered after the norm (its backward
    reduce-scatters the vocab shards' partial gradients)."""
    w = params["final_norm"]
    if sp_on:
        w = coll.copy_to(w, "model", rt.mesh)
    x = rms_norm(x, w, cfg.norm_eps)
    if sp_on:
        x = coll.gather_rs(x, "model", rt.mesh, dim=1)
    elif rt.vocab_shards > 1:
        x = coll.copy_to(x, "model", rt.mesh)
    head = (_tied_head(params["embed"], rt) if cfg.tie_embeddings
            else params["head"])
    return torch.matmul(x, head.to(x.dtype).t())


def decode_step(params: dict, cache: tuple, tokens: torch.Tensor, cache_len,
                *, cfg, rt) -> tuple:
    """One serving step: tokens (B, 1) + caches -> logits (B, 1, Vp),
    cache (written in place), metrics."""
    return forward(params, tokens, cfg=cfg, rt=rt, cache=cache,
                   cache_len=cache_len)


class DenseLM(ParamTree):
    """A dense-family decoder LM (``phi3-medium-14b`` and kin). Its
    ``named_parameters()`` carry the reference's dotted names (embed, head,
    final_norm, layers.ln1, layers.attn.wq, ..., layers.mlp.w_up).
    Parameters are allocated uninitialized; core/transform.py fills them
    (a seeded init or loaded weights)."""

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
        """{name: (shape, dtype)} of one step's inputs."""
        shape = shape or self.rt.shape_cfg
        b, s = shape.global_batch, shape.seq_len
        if shape.kind == "decode":
            return {"tokens": ((b, 1), torch.int32),
                    "cache_len": ((), torch.int32)}
        specs = {"tokens": ((b, s), torch.int32)}
        if shape.kind == "train":
            specs["labels"] = ((b, s), torch.int32)
        return specs

    def forward(self, batch: dict) -> tuple:
        """The training forward: -> (logits (B, S, Vp / M), None,
        metrics)."""
        return forward(self.params(), batch["tokens"], cfg=self.cfg,
                       rt=self.rt, embeds=batch.get("embeds"))

    def loss_fn(self, batch: dict, params: dict = None) -> tuple:
        """-> (this replica's mean loss, metrics). ``params``: {dotted
        name: tensor} standing in for parameters in this call (the step's
        FSDP-gathered weights)."""
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
        if "moe_aux" in metrics:
            loss = loss + 0.01 * metrics["moe_aux"] / self.cfg.n_layers
            metrics["moe_aux"] = metrics["moe_aux"].detach()
        return loss, metrics

    @torch.no_grad()
    def prefill_fn(self, batch: dict) -> tuple:
        """-> (logits, None, metrics) over a whole prompt batch (its
        ``embeds``, if any, added after the lookup)."""
        return forward(self.params(), batch["tokens"], cfg=self.cfg,
                       rt=self.rt, embeds=batch.get("embeds"))

    @torch.no_grad()
    def prefill_cache_fn(self, tokens: torch.Tensor) -> tuple:
        """tokens (B, S) -> (logits, (k, v)) with the per-layer K/V in the
        decode-cache layout, for slot insertion."""
        logits, kv, _ = forward(self.params(), tokens, cfg=self.cfg,
                                rt=self.rt, collect_kv=True)
        return logits, kv

    @torch.no_grad()
    def decode_fn(self, cache: tuple, tokens: torch.Tensor,
                  cache_len) -> tuple:
        """-> (logits (B, 1, Vp), cache written in place)."""
        logits, new_cache, _ = decode_step(self.params(), cache, tokens,
                                           cache_len, cfg=self.cfg,
                                           rt=self.rt)
        return logits, new_cache

    def init_cache(self, batch: int, cache_seq: int) -> tuple:
        return init_cache(self.cfg, self.rt, batch, cache_seq,
                          params=self.params())


class RwkvLM(DenseLM):
    """An ssm-family LM (``rwkv6-7b``): the parameters under the
    reference's dotted names (layers.tm.mu, layers.tm.w_lora_a, ...,
    layers.cm.w_recv, layers.ln1, layers.ln2). It trains through
    ``DenseLM.loss_fn`` (the WKV under autograd takes
    ``models/rwkv.py::chunk_wkv``) and serves through ``ToyServer``'s
    decode loop and ``make_prefill_step``; ``prefill_fn`` returns the final
    carry as its cache."""

    # the recurrent carry cannot be bucket-prefilled exactly under padding:
    # serving runs it through ToyServer's decode loop
    prefill_cache_fn = None


class HybridLM(DenseLM):
    """A hybrid-family LM (``hymba-1.5b``): the dense layers' names plus
    layers.ssm.* (w_in, w_gate, w_b, w_c, w_dt, dt_bias, a_log, w_out).
    Its cache carries the SSM state beside K/V, which padding would
    corrupt, so it serves through ``ToyServer`` as the reference does."""

    prefill_cache_fn = None
