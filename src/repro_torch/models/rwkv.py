"""RWKV6 "Finch" — attention-free time mix with data-dependent per-channel
decay, plus a squared-ReLU channel mix [arXiv:2404.05892] (the port of
``repro/models/rwkv.py``), single device.

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
in serving). The reference's ``rt.constrain`` calls pin shardings and have
nothing to pin on one device, so the blocks take no runtime.

A decode step carries O(1) state per layer: the (B, H, E, E) f32 WKV state
and the token-shift inputs of both mixes.
"""
from __future__ import annotations

import torch

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


def time_mix(p: dict, x: torch.Tensor, x_prev: torch.Tensor,
             state: torch.Tensor, *, cfg, chunk: int = 32) -> tuple:
    """x: (B, S, D). Returns (out, (x_last, new_state))."""
    b, s, d = x.shape
    h, e = cfg.n_heads, cfg.head_dim
    xs = _token_shift(x, x_prev)
    mu = p["mu"].to(x.dtype)
    xr, xk, xv, xw, xg = (x + (xs - x) * mu[i] for i in range(5))
    r = (xr @ p["w_r"]).reshape(b, s, h, e)
    k = (xk @ p["w_k"]).reshape(b, s, h, e)
    v = (xv @ p["w_v"]).reshape(b, s, h, e)
    g = xg @ p["w_g"]
    # data-dependent decay (Finch): w = w0 + tanh(xw A) B, in f32
    wdelta = torch.tanh(xw.float() @ p["w_lora_a"].float()) \
        @ p["w_lora_b"].float()
    w = p["w0"].float() + wdelta
    lw = -torch.exp(w).reshape(b, s, h, e)                   # log-decay <= 0
    bonus = torch.exp(p["bonus"].float()).reshape(h, e)
    if torch.is_grad_enabled():
        out, new_state = chunk_wkv(r, k, v, lw, bonus, state, chunk)
    else:
        out, new_state = ops.wkv(r, k, v, lw, bonus, state, chunk=chunk)
    out = out.reshape(b, s, d).to(x.dtype)
    # per-head group norm, then the gate
    out = rms_norm(out.reshape(b, s, h, e), p["ln_w"].reshape(h, e),
                   cfg.norm_eps).reshape(b, s, d)
    out = out * (g * torch.sigmoid(g))         # jax.nn.silu's two roundings
    return out @ p["w_o"], (x[:, -1, :], new_state)


def channel_mix(p: dict, x: torch.Tensor, x_prev: torch.Tensor) -> tuple:
    xs = _token_shift(x, x_prev)
    mu = p["mu"].to(x.dtype)
    xk = x + (xs - x) * mu[0]
    xr = x + (xs - x) * mu[1]
    hidden = torch.square(torch.relu(xk @ p["w_in"]))
    out = hidden @ p["w_out"]
    return out * torch.sigmoid(xr @ p["w_recv"]), x[:, -1, :]


def rwkv_block(p: dict, x: torch.Tensor, carry: tuple, *, cfg,
               chunk: int = 32) -> tuple:
    """One RWKV6 layer. carry = (tm_x, wkv_state, cm_x)."""
    tm_x, wkv_state, cm_x = carry
    h1 = rms_norm(x, p["ln1"], cfg.norm_eps)
    att, (tm_x, wkv_state) = time_mix(p["tm"], h1, tm_x, wkv_state, cfg=cfg,
                                      chunk=chunk)
    x = x + att
    h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
    ffn, cm_x = channel_mix(p["cm"], h2, cm_x)
    x = x + ffn
    return x, (tm_x, wkv_state, cm_x)


def init_rwkv_carry(cfg, batch: int, dtype: torch.dtype = torch.float32,
                    device=None) -> tuple:
    h, e, d = cfg.n_heads, cfg.head_dim, cfg.d_model
    return (torch.zeros((batch, d), dtype=dtype, device=device),
            torch.zeros((batch, h, e, e), dtype=torch.float32, device=device),
            torch.zeros((batch, d), dtype=dtype, device=device))
