"""Analytic per-card HBM traffic model for the roofline's memory term
(the port's copy of ``repro/utils/traffic.py``; the same arithmetic on
``ModelConfig`` and ``ShapeConfig``, so the same numbers).

The dry-run (launch/dryrun.py) runs its step on the meta device, which
moves no byte, so it has no measured traffic at all; this module gives
the traffic a tuned implementation on the card would see, with the
standard streaming assumptions:

  * each projection matmul streams operands and outputs once per pass
    (1 forward pass; the backward's dgrad and wgrad are 2 passes; remat
    adds 1 recompute),
  * flash attention streams Q, K, V, O once per pass; the score and
    softmax tiles stay in shared memory and registers,
  * optimizer: params read and written, grads read, m/v (f32) read and
    written,
  * decode: params and the KV cache stream once; activations negligible.

Bytes are bf16 activations and weights (2 B), f32 moments; nothing here
is a measurement.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.configs.base import ModelConfig, ShapeConfig


@dataclass
class Traffic:
    params_opt: float
    activations: float
    attention: float
    kv_cache: float
    embed_head: float

    @property
    def total(self) -> float:
        return (self.params_opt + self.activations + self.attention
                + self.kv_cache + self.embed_head)

    def to_dict(self):
        return {"params_opt": self.params_opt,
                "activations": self.activations,
                "attention": self.attention, "kv_cache": self.kv_cache,
                "embed_head": self.embed_head, "total": self.total}


def _proj_traffic(t_tokens, d_in, d_out, passes, dtype=2):
    """One projection: activations in/out + weights per pass."""
    return passes * dtype * (t_tokens * d_in + d_in * d_out + t_tokens * d_out)


def estimate_traffic(cfg: ModelConfig, shape: ShapeConfig, *, chips: int,
                     model_shards: int, remat: str = "full",
                     param_count: int | None = None,
                     zero_stage: int = 0) -> Traffic:
    train = shape.kind == "train"
    decode = shape.kind == "decode"
    # tokens processed per chip this step
    if decode:
        tokens_chip = max(shape.global_batch, 1) / chips * model_shards
        # (model shards each process the replicated decode tokens)
        tokens_chip = max(shape.global_batch / (chips / model_shards), 1)
    else:
        tokens_chip = shape.tokens / (chips / model_shards)

    d, f, hd = cfg.d_model, cfg.d_ff, cfg.head_dim
    hp = cfg.n_heads or (d // max(hd, 1))
    kv = cfg.n_kv_heads or hp
    L = cfg.n_layers + (cfg.enc_layers if cfg.is_encdec else 0)
    ms = model_shards

    p_total = param_count if param_count is not None else cfg.param_count()
    p_chip = p_total / (ms if zero_stage < 3 else chips)

    passes = (3.0 if train else 1.0)
    if train and remat in ("block", "full"):
        passes += 1.0

    # per-layer projections, model-sharded where the plan shards them
    proj = 0.0
    if cfg.n_heads:
        proj += _proj_traffic(tokens_chip, d, hp * hd / ms, passes)
        proj += 2 * _proj_traffic(tokens_chip, d, kv * hd, passes)
        proj += _proj_traffic(tokens_chip, hp * hd / ms, d, passes)
    if cfg.n_experts:
        active = cfg.experts_per_token
        proj += 3 * _proj_traffic(tokens_chip * active, d, f / ms, passes)
        # expert weights resident: all local experts stream once per pass
        e_loc = max(cfg.n_experts / ms, 1)
        proj += passes * 2 * (e_loc * 3 * d * f) if cfg.n_experts >= ms else \
            passes * 2 * (cfg.n_experts * 3 * d * f / ms)
        if cfg.shared_expert:
            proj += 3 * _proj_traffic(tokens_chip, d, f / ms, passes)
    else:
        proj += 3 * _proj_traffic(tokens_chip, d, f / ms, passes)
    if cfg.family == "hybrid":
        proj += 4 * _proj_traffic(tokens_chip, d, d / ms, passes)
    if cfg.family == "ssm":
        proj = 6 * _proj_traffic(tokens_chip, d, d / ms, passes) \
            + 2 * _proj_traffic(tokens_chip, d, f / ms, passes)
    if cfg.is_encdec:
        proj += 2 * _proj_traffic(tokens_chip, d, (hp * hd + kv * hd) / ms,
                                  passes)  # cross attention
    activations = proj * L
    # residual stream + norms: ~6 streams of (T, D) per layer
    activations += L * 6 * passes * 2 * tokens_chip * d / ms

    # flash attention streams Q,K,V,O once per pass
    attention = 0.0
    if cfg.n_heads and not decode:
        attention = L * passes * 2 * tokens_chip * (hp / ms + 3 * kv) * hd

    kv_cache = 0.0
    if decode and cfg.n_heads:
        cache_tokens = shape.global_batch * shape.seq_len
        kv_cache = 2 * 2 * cache_tokens * kv * hd * cfg.n_layers / chips

    # params+optimizer traffic
    if train:
        params_opt = p_chip * (2 * passes + 2 + 2 + 16)
        # ^ bf16 reads per pass + grad rw + param write + m/v f32 rw
    else:
        params_opt = p_chip * 2

    # embedding rows + logits head
    vp = cfg.vocab_size
    if decode:
        embed_head = 2 * tokens_chip * (d + vp / ms)
    else:
        embed_head = passes * 2 * tokens_chip * (d + vp / ms)

    return Traffic(params_opt=params_opt, activations=activations,
                   attention=attention, kv_cache=kv_cache,
                   embed_head=embed_head)
