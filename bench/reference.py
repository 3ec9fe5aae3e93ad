"""The plain reference: the benchmark's models and their training step in
plain PyTorch, float32, written from the published descriptions. It
imports nothing of the program; the harness hands it the same weights
(``weights.py``, from the seed) and the same batches (``traffic.py``) it
hands the program, and it works out everything else again.

Models (``family`` of a configuration file under ``bench/configs/``):

``lstm``   the BIG LSTM language model (arXiv:1602.02410): the embedding,
           LSTM layers with a projection, a residual around each layer
           whose output width equals its input's, an untied softmax head.
           Gates i, f, g, o; c = sigmoid(f + 1) c + sigmoid(i) tanh(g) (the
           forget gate's bias of 1); h = (sigmoid(o) tanh(c)) @ w_proj;
           state zero at each sequence's start.
``dense``  a pre-norm decoder (phi-3, arXiv:2404.14219): RMSNorm, grouped-
           query causal attention with rotary positions (the rotated halves
           convention), a SwiGLU MLP, a final RMSNorm and an untied head; no
           biases.

The loss is the mean cross-entropy over every token, over the whole
vocabulary. The optimizer is AdamW with the gradient clipped to a global
norm, as the configuration states it. ``Precision("fp8")`` is the control:
the same arithmetic with every weight product's operands (forward and
backward) rounded to float8 e4m3 with a per-tensor scale, which is the
next precision below the configurations' bfloat16.

Memory: the head and the loss run over blocks of rows with their gradient
written by hand, so no (tokens, vocabulary) tensor exists whole; the dense
layers are recomputed in the backward (``torch.utils.checkpoint``), so
only each layer's input is kept.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

F8 = torch.float8_e4m3fn
F8_MAX = 448.0
# the rows of the head's product per block: at most this many f32 logits
HEAD_BLOCK_ELEMS = 1 << 29


@dataclass(frozen=True)
class Leaf:
    name: str
    shape: tuple
    init: str           # normal | zeros | ones
    std: float = 0.0


def leaf_specs(cfg: dict) -> list:
    """The model's leaves under the port's dotted names, in sorted order,
    with their draws: N(0, 0.02) for the tables, N(0, 1 / fan-in) for the
    matrices, ones for the norms, zeros for the gate bias."""
    d, f, v, n = cfg["d_model"], cfg["d_ff"], cfg["vocab_size"], \
        cfg["n_layers"]
    out = [Leaf("embed", (v, d), "normal", 0.02),
           Leaf("head", (v, d), "normal", 0.02)]
    if cfg["family"] == "lstm":
        out += [Leaf("layers.bias", (n, 4 * f), "zeros"),
                Leaf("layers.w_h", (n, d, 4 * f), "normal", d ** -0.5),
                Leaf("layers.w_proj", (n, f, d), "normal", f ** -0.5),
                Leaf("layers.w_x", (n, d, 4 * f), "normal", d ** -0.5)]
    elif cfg["family"] == "dense":
        q, kv = cfg["n_heads"] * cfg["head_dim"], \
            cfg["n_kv_heads"] * cfg["head_dim"]
        out += [Leaf("final_norm", (d,), "ones"),
                Leaf("layers.attn.wk", (n, d, kv), "normal", d ** -0.5),
                Leaf("layers.attn.wo", (n, q, d), "normal", q ** -0.5),
                Leaf("layers.attn.wq", (n, d, q), "normal", d ** -0.5),
                Leaf("layers.attn.wv", (n, d, kv), "normal", d ** -0.5),
                Leaf("layers.ln1", (n, d), "ones"),
                Leaf("layers.ln2", (n, d), "ones"),
                Leaf("layers.mlp.w_down", (n, f, d), "normal", f ** -0.5),
                Leaf("layers.mlp.w_gate", (n, d, f), "normal", d ** -0.5),
                Leaf("layers.mlp.w_up", (n, d, f), "normal", d ** -0.5)]
    else:
        raise ValueError(f"no reference for family {cfg['family']!r}")
    return sorted(out, key=lambda s: s.name)


# ---------------------------------------------------------------------------
# precision
# ---------------------------------------------------------------------------

def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under a per-tensor scale (its largest
    magnitude at e4m3's largest finite value), back in f32."""
    amax = x.detach().abs().amax().float()
    scale = torch.where(amax > 0, amax / F8_MAX, torch.ones_like(amax))
    return (x / scale).to(F8).float() * scale


class _Fp8Matmul(torch.autograd.Function):
    @staticmethod
    def forward(fctx, a, b):
        qa, qb = fp8_round(a), fp8_round(b)
        fctx.save_for_backward(qa, qb)
        return qa @ qb

    @staticmethod
    def backward(fctx, g):
        qa, qb = fctx.saved_tensors
        qg = fp8_round(g)
        ga = qg @ qb.transpose(-1, -2)
        gb = qa.transpose(-1, -2) @ qg
        while gb.dim() > qb.dim():
            gb = gb.sum(0)
        return ga, gb


@dataclass(frozen=True)
class Precision:
    """How the reference multiplies: ``f32`` (TF32 off) or ``fp8``."""
    name: str = "f32"

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.name == "fp8":
            return _Fp8Matmul.apply(a, b)
        return a @ b

    def mm_nograd(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.name == "fp8":
            return fp8_round(a) @ fp8_round(b)
        return a @ b


# ---------------------------------------------------------------------------
# models: (f32 leaves, tokens) -> the last hidden state (T, d)
# ---------------------------------------------------------------------------

def _lstm_body(cfg: dict, p: dict, tokens: torch.Tensor,
               pr: Precision) -> torch.Tensor:
    x = F.embedding(tokens.long(), p["embed"])             # (B, S, d)
    b, s, d = x.shape
    f = cfg["d_ff"]
    for i in range(cfg["n_layers"]):
        w_x, w_h = p["layers.w_x"][i], p["layers.w_h"][i]
        bias, w_proj = p["layers.bias"][i], p["layers.w_proj"][i]
        gx = pr.mm(x.reshape(b * s, d), w_x).reshape(b, s, 4 * f)
        c = x.new_zeros((b, f))
        h = x.new_zeros((b, w_proj.shape[1]))
        ys = []
        for t in range(s):
            gates = gx[:, t] + pr.mm(h, w_h) + bias
            gi, gf, gg, go = gates.chunk(4, dim=-1)
            c = torch.sigmoid(gf + 1.0) * c + torch.sigmoid(gi) * torch.tanh(gg)
            h = pr.mm(torch.sigmoid(go) * torch.tanh(c), w_proj)
            ys.append(h)
        y = torch.stack(ys, dim=1)
        x = x + y if y.shape == x.shape else y
    return x.reshape(b * s, -1)


def _rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, H, D): positions 0 .. S - 1, the halves rotated."""
    s, half = x.shape[1], x.shape[-1] // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=x.device) / half))
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] \
        * freqs
    cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _dense_layer(x, ln1, wq, wk, wv, wo, ln2, wg, wu, wd, *, cfg, pr):
    b, s, d = x.shape
    hd, nh, nkv = cfg["head_dim"], cfg["n_heads"], cfg["n_kv_heads"]
    h = _rms(x, ln1, cfg["norm_eps"]).reshape(b * s, d)
    q = pr.mm(h, wq).reshape(b, s, nh, hd)
    k = pr.mm(h, wk).reshape(b, s, nkv, hd)
    v = pr.mm(h, wv).reshape(b, s, nkv, hd)
    q, k = _rope(q, cfg["rope_theta"]), _rope(k, cfg["rope_theta"])
    k = k.repeat_interleave(nh // nkv, dim=2)
    v = v.repeat_interleave(nh // nkv, dim=2)
    att = torch.einsum("bqhd,bkhd->bhqk", q, k) * hd ** -0.5
    mask = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    att = att.masked_fill(~mask, float("-inf")).softmax(-1)
    o = torch.einsum("bhqk,bkhd->bqhd", att, v).reshape(b * s, nh * hd)
    x = x + pr.mm(o, wo).reshape(b, s, d)
    h2 = _rms(x, ln2, cfg["norm_eps"]).reshape(b * s, d)
    m = pr.mm(F.silu(pr.mm(h2, wg)) * pr.mm(h2, wu), wd)
    return x + m.reshape(b, s, d)


def _dense_body(cfg: dict, p: dict, tokens: torch.Tensor,
                pr: Precision) -> torch.Tensor:
    x = F.embedding(tokens.long(), p["embed"])
    names = ("layers.ln1", "layers.attn.wq", "layers.attn.wk",
             "layers.attn.wv", "layers.attn.wo", "layers.ln2",
             "layers.mlp.w_gate", "layers.mlp.w_up", "layers.mlp.w_down")
    for i in range(cfg["n_layers"]):
        x = checkpoint(_dense_layer, x, *(p[n][i] for n in names),
                       cfg=cfg, pr=pr, use_reentrant=False)
    x = _rms(x, p["final_norm"], cfg["norm_eps"])
    return x.reshape(-1, x.shape[-1])


BODIES = {"lstm": _lstm_body, "dense": _dense_body}


def head_xent(x: torch.Tensor, w: torch.Tensor, labels: torch.Tensor,
              pr: Precision) -> tuple:
    """Mean cross-entropy of ``x @ w.T`` over every row, in blocks of rows.
    -> (loss, d loss / d x, d loss / d w)."""
    t, v = x.shape[0], w.shape[0]
    rows = max(1, HEAD_BLOCK_ELEMS // v)
    dx = torch.empty_like(x)
    dw = torch.zeros_like(w)
    total = torch.zeros((), dtype=torch.float64, device=x.device)
    for lo in range(0, t, rows):
        xb, lb = x[lo:lo + rows], labels[lo:lo + rows].long()
        lg = pr.mm_nograd(xb, w.t())
        lse = torch.logsumexp(lg, dim=-1)
        total += (lse - lg.gather(1, lb[:, None])[:, 0]).double().sum()
        lg.sub_(lse[:, None]).exp_()
        lg[torch.arange(lg.shape[0], device=lg.device), lb] -= 1.0
        lg.div_(t)
        dw += pr.mm_nograd(lg.t(), xb)
        dx[lo:lo + rows] = pr.mm_nograd(lg, w)
        del lg
    return float(total / t), dx, dw


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Adam:
    lr: float
    b1: float
    b2: float
    eps: float
    clip_norm: float
    weight_decay: float = 0.0

    @classmethod
    def of(cls, opt: dict) -> "Adam":
        if opt.get("name", "adamw") != "adamw":
            raise ValueError(f"no reference for optimizer {opt['name']!r}")
        return cls(lr=opt["lr"], b1=opt["b1"], b2=opt["b2"], eps=opt["eps"],
                   clip_norm=opt["clip_norm"],
                   weight_decay=opt.get("weight_decay", 0.0))


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.double()))


def train(cfg: dict, params: dict, batches: list, adam: Adam, *,
          precision: str = "f32", grad_scale: float = 1.0,
          grad_steps=(1,)) -> dict:
    """Train ``params`` ({name: f32 leaf}, updated in place) over
    ``batches`` (each {"tokens", "labels"} on the device), one AdamW step
    a batch. ``grad_scale`` multiplies every gradient before the clip (1
    for the sound step). -> {"losses": [loss before each step],
    "grad_norms": {leaf: norm of the clipped first gradient},
    "grad_norms_at": {str(step): {leaf: norm of that step's clipped
    gradient}} for the later ``grad_steps`` (counted from 1)}."""
    pr = Precision(precision)
    body = BODIES[cfg["family"]]
    m = {n: torch.zeros_like(t) for n, t in params.items()}
    v = {n: torch.zeros_like(t) for n, t in params.items()}
    losses, norms = [], {k: {} for k in sorted({1, *grad_steps})}
    for step, batch in enumerate(batches, start=1):
        for t in params.values():
            t.requires_grad_(True)
            t.grad = None
        hidden = body(cfg, params, batch["tokens"], pr)
        loss, dx, dw_head = head_xent(hidden.detach(),
                                      params["head"].detach(),
                                      batch["labels"].reshape(-1), pr)
        hidden.backward(dx)
        del hidden, dx
        grads = {}
        for n, t in params.items():
            grads[n] = t.grad if t.grad is not None else torch.zeros_like(t)
            t.grad = None
            t.requires_grad_(False)
        grads["head"] += dw_head
        del dw_head
        if grad_scale != 1.0:
            for g in grads.values():
                g.mul_(grad_scale)
        total = math.sqrt(sum(_norm(g) ** 2 for g in grads.values()))
        clip = min(1.0, adam.clip_norm / max(total, 1e-9))
        bc1, bc2 = 1.0 - adam.b1 ** step, 1.0 - adam.b2 ** step
        with torch.no_grad():
            for n, p in params.items():
                g = grads.pop(n).mul_(clip)
                if step in norms:
                    norms[step][n] = _norm(g)
                m[n].mul_(adam.b1).add_(g, alpha=1 - adam.b1)
                v[n].mul_(adam.b2).addcmul_(g, g, value=1 - adam.b2)
                del g
                if adam.weight_decay:
                    p.mul_(1.0 - adam.lr * adam.weight_decay)
                den = (v[n] / bc2).sqrt_().add_(adam.eps)
                p.addcdiv_(m[n], den, value=-adam.lr / bc1)
                del den
        losses.append(loss)
    first = norms.pop(1)
    return {"losses": losses, "grad_norms": first,
            "grad_norms_at": {str(k): v for k, v in norms.items()}}
