"""Selective SSM (Mamba-style, S4D-real) for hymba's parallel SSM heads (the
port of ``repro/models/ssm.py``); tensor-parallel over ``model`` on a
process mesh (``ssm_mix``).

Recurrence  h[t,d,n] = a[t,d]·h[t-1,d,n] + (dt[t,d]·x[t,d])·B[t,n]
            y[t,d]   = Σ_n C[t,n]·h[t,d,n]
with data-dependent a[t,d] = exp(dt[t,d]·A_d), A_d = -exp(A_log_d).

The scan is chunked as the reference's is — the (B, D, N) f32 state
carried between chunks, C_t·B_i scores inside one — but each decay is
taken as one factor exp(cum_t - cum_i) <= 1 (a (C x C) block per chunk)
where the reference factors it as exp(cum_t)·exp(-cum_i) clamped at ±80.
The two agree wherever the reference is exact (chunk × |dt·A| <= 80); at
hymba's published width its dt·|A| reach ~4, so a 128-token chunk's
factors leave that range from the initialization, and after a few AdamW
steps the reference's f32 sums overflow (its own CPU run at d 1,600
returns NaN losses from step 2; ROADMAP Queue 3). Here every exponent is
<= 0, so the scan is the recurrence's for any chunk; the chunk only sets
the size of the (B, S, chunk, D) decay blocks. The reference's
``lax.scan`` over chunks becomes a Python loop over the chunks' states;
everything runs in plain torch under autograd (the reference has no Pallas
kernel here). A decode step carries h (B, D, N).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import collectives as coll
from repro_torch.models.layers import ParamSpec

# the decay blocks' length in the model (the reference scans chunks of 128;
# the values are the recurrence's either way, and 16 keeps the (B, S, 16, D)
# f32 blocks at 420 MB for hymba's training cell)
CHUNK = 16


def ssm_specs(cfg) -> dict:
    d, n = cfg.d_model, cfg.ssm_state
    return {
        "w_in": ParamSpec((d, d), (None, "heads_hd"), fan_in_axes=(0,)),
        "w_gate": ParamSpec((d, d), (None, "heads_hd"), fan_in_axes=(0,)),
        "w_b": ParamSpec((d, n), (None, None), scale=0.02),
        "w_c": ParamSpec((d, n), (None, None), scale=0.02),
        "w_dt": ParamSpec((d, d), (None, "heads_hd"), scale=0.02),
        "dt_bias": ParamSpec((d,), (None,), init="zeros"),
        "a_log": ParamSpec((d,), (None,), init="zeros"),
        "w_out": ParamSpec((d, d), ("heads_hd", None), fan_in_axes=(0,)),
    }


def _chunk_ssm(u, dt, b_t, c_t, a_d, h0, chunk: int) -> tuple:
    """u/dt: (B, S, D); b_t/c_t: (B, S, N); a_d: (D,) negative; h0:
    (B, D, N). The tail is zero-padded to a whole chunk (dt 0: decay e^0,
    no input). -> (y (B, S, D) f32, h (B, D, N) f32)."""
    bsz, s, d = u.shape
    pad = (-s) % chunk
    if pad:
        u, dt, b_t, c_t = (F.pad(a, (0, 0, 0, pad)) for a in (u, dt, b_t, c_t))
    k = (s + pad) // chunk
    uj, dtj, bj, cj = (a.float().reshape(bsz, k, chunk, a.shape[-1])
                       for a in (u, dt, b_t, c_t))
    src = dtj * uj                                       # (B, K, C, D)
    cum = torch.cumsum(dtj * a_d, dim=2)                 # inclusive, <= 0
    # inside a chunk: y_t = Σ_{i<=t} (C_t·B_i) exp(cum_t - cum_i) src_i
    lower = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                  device=u.device))[..., None]
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (B, K, C, C, D)
    decay = torch.exp(torch.where(lower, seg, -torch.inf))
    scores = torch.einsum("bktn,bkin->bkti", cj, bj)
    y = torch.einsum("bkti,bktid,bkid->bktd", scores, decay, src)
    # each chunk's own state: Σ_i exp(tot - cum_i) src_i ⊗ B_i
    tot = cum[:, :, -1]                                  # (B, K, D)
    own = torch.einsum("bkid,bkin->bkdn",
                       src * torch.exp(tot[:, :, None] - cum), bj)
    h = h0.float()
    h_in = []
    for j in range(k):                                   # the state carry
        h_in.append(h)
        h = h * torch.exp(tot[:, j])[..., None] + own[:, j]
    y = y + torch.exp(cum) * torch.einsum("bktn,bkdn->bktd", cj,
                                          torch.stack(h_in, dim=1))
    return y.reshape(bsz, k * chunk, d)[:, :s], h


def ssm_mix(p: dict, x: torch.Tensor, h0: torch.Tensor, *, cfg, rt=None,
            chunk: int = CHUNK) -> tuple:
    """x: (B, S, D) -> (y (B, S, D) in x's dtype, h (B, D, N) f32): the
    selective-SSM branch.

    Where ``p`` holds this rank's block of the channels (``w_in`` /
    ``w_gate`` / ``w_dt`` column-parallel, ``w_out`` row-parallel: the
    held shape, on a process mesh) the branch runs tensor-parallel over
    ``model``: the scan is per channel, so it stays local on this rank's
    D/M channels and ``h`` is (B, D/M, N); ``reduce_from`` sums the
    output. The replicated leaves inside the block see only this rank's
    channels' share of their gradient, so it is summed over ``model``:
    ``copy_to`` on the B and C projections (computed from the whole
    input, as one device does) and on ``dt_bias`` / ``a_log`` before they
    are sliced to the rank's channels."""
    d_loc = p["w_in"].shape[-1]
    mesh = rt.mesh if d_loc < cfg.d_model else None
    xt = x if mesh is None else coll.copy_to(x, "model", mesh)
    dt_bias, a_log = p["dt_bias"], p["a_log"]
    b_t = (x @ p["w_b"]).float()
    c_t = (x @ p["w_c"]).float()
    if mesh is not None:
        lo = rt.model_index * d_loc
        dt_bias, a_log = (coll.copy_to(w, "model", mesh)[lo:lo + d_loc]
                          for w in (dt_bias, a_log))
        b_t, c_t = (coll.copy_to(a, "model", mesh) for a in (b_t, c_t))
    u = xt @ p["w_in"]
    g = xt @ p["w_gate"]
    gate = g * torch.sigmoid(g)                 # jax.nn.silu
    dt = F.softplus((xt @ p["w_dt"]).float() + dt_bias.float())
    a_d = -torch.exp(a_log.float())
    y, h = _chunk_ssm(u.float(), dt, b_t, c_t, a_d, h0, chunk)
    y = (y.to(x.dtype) * gate) @ p["w_out"]
    if mesh is not None:
        y = coll.reduce_from(y, "model", mesh)
    return y, h


def init_ssm_state(cfg, batch: int, device=None,
                   channels: int = None) -> torch.Tensor:
    """The zeroed (B, D, N) f32 state: ``channels`` (this rank's D/M under
    tensor parallelism) in place of D where given."""
    return torch.zeros((batch, channels or cfg.d_model, cfg.ssm_state),
                       dtype=torch.float32, device=device)
