"""RWKV6 "Finch" — attention-free time mix with data-dependent per-channel
decay, plus a squared-ReLU channel mix [arXiv:2404.05892] (the port of
``repro/models/rwkv.py``); tensor-parallel over ``model`` on a process
mesh (``time_mix``, ``channel_mix``).

The time mix's WKV recurrence has two routes, picked by autograd's mode:
  * under autograd (training): ``chunk_wkv``, the port of the reference's
    jnp ``_chunk_wkv`` in plain torch, whose autodiff is the backward, as
    the reference trains through its ``_chunk_wkv`` and not its Pallas
    kernel (which has no backward);
  * without grad (serving: ``prefill_fn``, ``decode_fn``):
    ``kernels/ops.wkv``, the hand-written CUDA kernel on the card, its
    plain chunked version on the CPU — the same function (chunk 32, the
    clamps at 80).
The dense family splits the same way (plain attention in training, flash
in serving). The reference's ``rt.constrain`` calls pin shardings; the blocks take
the runtime for its mesh only, and key their tensor parallelism on the
held shape of their leaves.

A decode step carries O(1) state per layer: the (B, H, E, E) f32 WKV state
and the token-shift inputs of both mixes.
"""
from __future__ import annotations

import torch

from repro_torch.core import collectives as coll
from repro_torch.kernels import ops
from repro_torch.models.layers import ParamSpec, rms_norm


def rwkv_block_specs(cfg) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    lora = 64
    return {
        "tm": {  # time mix
            "mu": ParamSpec((5, d), (None, None), init="zeros"),  # r,k,v,w,g shifts
            "w_r": ParamSpec((d, d), (None, "heads_hd"), fan_in_axes=(0,)),
            "w_k": ParamSpec((d, d), (None, "heads_hd"), fan_in_axes=(0,)),
            "w_v": ParamSpec((d, d), (None, "heads_hd"), fan_in_axes=(0,)),
            "w_g": ParamSpec((d, d), (None, "heads_hd"), fan_in_axes=(0,)),
            "w_o": ParamSpec((d, d), ("heads_hd", None), fan_in_axes=(0,)),
            "w0": ParamSpec((d,), (None,), init="zeros"),
            "w_lora_a": ParamSpec((d, lora), (None, None), scale=0.02),
            "w_lora_b": ParamSpec((lora, d), (None, None), init="zeros"),
            "bonus": ParamSpec((d,), (None,), init="zeros"),        # u
            "ln_w": ParamSpec((d,), (None,), init="ones"),          # group/out norm
        },
        "cm": {  # channel mix
            "mu": ParamSpec((2, d), (None, None), init="zeros"),
            "w_in": ParamSpec((d, f), (None, "mlp"), fan_in_axes=(0,)),
            "w_out": ParamSpec((f, d), ("mlp", None), fan_in_axes=(0,)),
            "w_recv": ParamSpec((d, d), (None, None), fan_in_axes=(0,)),
        },
        "ln1": ParamSpec((d,), (None,), init="ones"),
        "ln2": ParamSpec((d,), (None,), init="ones"),
    }


def _token_shift(x: torch.Tensor, x_prev: torch.Tensor) -> torch.Tensor:
    """x: (B, S, D); x_prev: (B, D), the last token of the previous
    segment."""
    return torch.cat([x_prev[:, None, :], x[:, :-1, :]], dim=1)


CLAMP = 80.0  # fp32-safe clamp; exact while chunk * |log-decay| <= 80


def chunk_wkv(r, k, v, lw, bonus, state, chunk: int) -> tuple:
    """The chunked WKV of the reference (``_chunk_wkv``), differentiable:
    r/k/v (B, S, H, E); lw (B, S, H, E) log-decay (<= 0); bonus (H, E);
    state (B, H, E, E) carried. The tail is zero-padded to a whole chunk.
    f32 inside -> (out (B, S, H, E) f32, state (B, H, E, E) f32)."""
    b, s, h, e = r.shape
    pad = (-s) % chunk
    r, k, v, lw = (torch.nn.functional.pad(a, (0, 0, 0, 0, 0, pad))
                   if pad else a for a in (r, k, v, lw))
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=r.device), diagonal=-1)
    st = state.float()
    outs = []
    for c0 in range(0, s + pad, chunk):
        rj, kj, vj, lwj = (a[:, c0:c0 + chunk].float()
                           for a in (r, k, v, lw))
        cum = torch.cumsum(lwj, dim=1)                       # inclusive
        cin = cum - lwj                                      # exclusive
        qf = rj * torch.exp(torch.clamp(cin, -CLAMP, 0.0))
        kf = kj * torch.exp(torch.clamp(-cum, 0.0, CLAMP))
        s_tt = torch.einsum("bthe,bihe->bhti", qf, kf)       # intra scores
        s_tt = torch.where(mask[None, None], s_tt, 0.0)
        out = torch.einsum("bhti,bihe->bthe", s_tt, vj)
        # the diagonal bonus u * k_t
        diag = torch.einsum("bthe,bthe->bth", rj * bonus, kj)
        out = out + diag[..., None] * vj
        out = out + torch.einsum("bthe,bhef->bthf", qf, st)  # inter-chunk
        tot = cum[:, -1:]                                    # (B, 1, H, E)
        kdec = kj * torch.exp(torch.clamp(tot - cum, -CLAMP, CLAMP))
        st = st * torch.exp(torch.clamp(tot, -CLAMP, 0.0))[:, 0, ..., None] \
            + torch.einsum("bthe,bthf->bhef", kdec, vj)
        outs.append(out)
    return torch.cat(outs, dim=1)[:, :s], st


def _tp_slice(w: torch.Tensor, lo: int, n: int, mesh) -> torch.Tensor:
    """A replicated leaf's columns [lo, lo + n) of its last dimension, its
    gradient summed over ``model`` (each rank's block reads only its
    columns); the whole leaf off a mesh."""
    if mesh is None:
        return w
    return coll.copy_to(w, "model", mesh)[..., lo:lo + n]


def time_mix(p: dict, x: torch.Tensor, x_prev: torch.Tensor,
             state: torch.Tensor, *, cfg, rt=None, chunk: int = 32) -> tuple:
    """x: (B, S, D). Returns (out, (x_last, new_state)).

    Where ``w_r`` holds this rank's block of the heads (on a process
    mesh) the mix runs tensor-parallel over ``model``: ``w_r / w_k / w_v
    / w_g`` column-parallel by heads, the WKV and the per-head group norm
    on this rank's H/M heads (the state (B, H/M, E, E)), ``w_o``
    row-parallel with ``reduce_from``. The token-shift mixes and the
    decay LoRA's ``tanh`` run whole on every rank and reach the sharded
    products through ``copy_to``; the replicated per-channel leaves
    (``w0``, ``bonus``, ``ln_w``, ``w_lora_b``) are sliced to the rank's
    heads with their gradient summed over ``model``."""
    b, s, d = x.shape
    e = cfg.head_dim
    d_loc = p["w_r"].shape[-1]
    h = d_loc // e
    mesh = rt.mesh if rt is not None and d_loc < d else None
    lo = rt.model_index * d_loc if mesh is not None else 0
    xs = _token_shift(x, x_prev)
    mu = p["mu"].to(x.dtype)
    xr, xk, xv, xw, xg = (x + (xs - x) * mu[i] for i in range(5))
    if mesh is not None:
        # the column-parallel products' inputs: one backward all-reduce
        xr, xk, xv, xg = coll.copy_to(torch.stack([xr, xk, xv, xg]),
                                      "model", mesh).unbind(0)
    r = (xr @ p["w_r"]).reshape(b, s, h, e)
    k = (xk @ p["w_k"]).reshape(b, s, h, e)
    v = (xv @ p["w_v"]).reshape(b, s, h, e)
    g = xg @ p["w_g"]
    # data-dependent decay (Finch): w = w0 + tanh(xw A) B, in f32
    lora = torch.tanh(xw.float() @ p["w_lora_a"].float())
    if mesh is not None:
        lora = coll.copy_to(lora, "model", mesh)
    wdelta = lora @ _tp_slice(p["w_lora_b"], lo, d_loc, mesh).float()
    w = _tp_slice(p["w0"], lo, d_loc, mesh).float() + wdelta
    lw = -torch.exp(w).reshape(b, s, h, e)                   # log-decay <= 0
    bonus = torch.exp(_tp_slice(p["bonus"], lo, d_loc, mesh).float()
                      ).reshape(h, e)
    if torch.is_grad_enabled():
        out, new_state = chunk_wkv(r, k, v, lw, bonus, state, chunk)
    else:
        out, new_state = ops.wkv(r, k, v, lw, bonus, state, chunk=chunk)
    out = out.reshape(b, s, d_loc).to(x.dtype)
    # per-head group norm, then the gate
    out = rms_norm(out.reshape(b, s, h, e),
                   _tp_slice(p["ln_w"], lo, d_loc, mesh).reshape(h, e),
                   cfg.norm_eps).reshape(b, s, d_loc)
    out = out * (g * torch.sigmoid(g))         # jax.nn.silu's two roundings
    out = out @ p["w_o"]
    if mesh is not None:
        out = coll.reduce_from(out, "model", mesh)
    return out, (x[:, -1, :], new_state)


def channel_mix(p: dict, x: torch.Tensor, x_prev: torch.Tensor, *, cfg=None,
                rt=None) -> tuple:
    """The squared-ReLU channel mix. Where ``w_in`` holds this rank's
    block of d_ff it runs tensor-parallel over ``model``: ``w_in``
    column-parallel (its input through ``copy_to``), ``w_out``
    row-parallel, and ``reduce_from`` before the receptance gate, whose
    ``w_recv`` is replicated on the whole input."""
    mesh = rt.mesh if rt is not None and p["w_in"].shape[-1] < cfg.d_ff \
        else None
    xs = _token_shift(x, x_prev)
    mu = p["mu"].to(x.dtype)
    xk = x + (xs - x) * mu[0]
    xr = x + (xs - x) * mu[1]
    if mesh is not None:
        xk = coll.copy_to(xk, "model", mesh)
    hidden = torch.square(torch.relu(xk @ p["w_in"]))
    out = hidden @ p["w_out"]
    if mesh is not None:
        out = coll.reduce_from(out, "model", mesh)
    return out * torch.sigmoid(xr @ p["w_recv"]), x[:, -1, :]


def rwkv_block(p: dict, x: torch.Tensor, carry: tuple, *, cfg, rt=None,
               chunk: int = 32) -> tuple:
    """One RWKV6 layer. carry = (tm_x, wkv_state, cm_x)."""
    tm_x, wkv_state, cm_x = carry
    h1 = rms_norm(x, p["ln1"], cfg.norm_eps)
    att, (tm_x, wkv_state) = time_mix(p["tm"], h1, tm_x, wkv_state, cfg=cfg,
                                      rt=rt, chunk=chunk)
    x = x + att
    h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
    ffn, cm_x = channel_mix(p["cm"], h2, cm_x, cfg=cfg, rt=rt)
    x = x + ffn
    return x, (tm_x, wkv_state, cm_x)


def init_rwkv_carry(cfg, batch: int, dtype: torch.dtype = torch.float32,
                    device=None, heads: int = None) -> tuple:
    """The zeroed carry (tm_x, state, cm_x): the WKV state at ``heads``
    (this rank's H/M under tensor parallelism) where given."""
    h, e, d = heads or cfg.n_heads, cfg.head_dim, cfg.d_model
    return (torch.zeros((batch, d), dtype=dtype, device=device),
            torch.zeros((batch, h, e, e), dtype=torch.float32, device=device),
            torch.zeros((batch, d), dtype=dtype, device=device))
