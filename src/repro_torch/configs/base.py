"""Config system: model architecture, input shapes, mesh, and run options.

Every assigned architecture gets a ``configs/<id>.py`` exporting ``CONFIG``
with the exact published numbers. Smoke tests use ``reduced(CONFIG)``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, replace
from typing import Optional


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class ModelConfig:
    """Architecture description (exact published numbers)."""

    name: str
    family: str                     # dense | moe | vlm | ssm | hybrid | audio | lstm
    n_layers: int
    d_model: int
    n_heads: int                    # 0 for attention-free
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128
    # --- MoE ---
    n_experts: int = 0
    experts_per_token: int = 0
    moe_capacity_factor: float = 1.25
    shared_expert: bool = False     # llama4-style shared expert alongside routed
    # --- SSM / hybrid ---
    ssm_state: int = 0
    conv_width: int = 4
    # --- enc-dec (audio) ---
    is_encdec: bool = False
    enc_layers: int = 0             # if encdec: encoder layers (n_layers = decoder)
    frontend_stub: bool = False     # input_specs() provides precomputed embeddings
    # --- misc ---
    tie_embeddings: bool = False
    use_bias: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    source: str = ""

    # ---- derived, sharding-aware quantities ----
    def padded_heads(self, shards: int) -> int:
        """q heads padded to divisibility for TP (zero-init pad => exact)."""
        if self.n_heads == 0:
            return 0
        return _round_up(self.n_heads, shards)

    def padded_vocab(self, shards: int) -> int:
        return _round_up(self.vocab_size, shards)

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def subquadratic(self) -> bool:
        """Can this arch serve a 500k context (long_500k shape)?"""
        return self.family in ("ssm", "hybrid")

    def param_count(self) -> int:
        """Analytic parameter count (embedding + per-layer blocks)."""
        d, f, L = self.d_model, self.d_ff, self.n_layers
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        if self.family == "ssm":                     # rwkv6-ish census
            per_layer = 4 * d * d + 3 * d * f // 1 + 2 * d  # timemix + channelmix approx
            per_layer = 4 * d * d + 2 * d * f + 6 * d
        else:
            attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
            if self.n_experts > 0:
                ffn = self.n_experts * 3 * d * f
                if self.shared_expert:
                    ffn += 3 * d * f
            else:
                ffn = 3 * d * f
            per_layer = attn + ffn
            if self.family == "hybrid":
                per_layer += 3 * d * d // 1 + d * self.ssm_state * 2   # ssm head branch
        layers = L + (self.enc_layers if self.is_encdec else 0)
        body = layers * per_layer
        if self.is_encdec:  # cross attention in decoder
            body += L * (d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d)
        return emb + body

    def active_param_count(self) -> int:
        """Params touched per token (MoE active experts only) for 6·N·D."""
        if self.n_experts == 0:
            return self.param_count()
        d, f, L = self.d_model, self.d_ff, self.n_layers
        routed_total = self.n_experts * 3 * d * f * L
        routed_active = self.experts_per_token * 3 * d * f * L
        return self.param_count() - routed_total + routed_active


@dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str               # train | prefill | decode

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}


@dataclass(frozen=True)
class RunConfig:
    """Distribution/runtime knobs — the Parallax plan inputs."""

    # paper's comm modes: hybrid (the contribution), ps, mpi (baselines)
    comm_mode: str = "hybrid"         # hybrid | ps | mpi
    local_agg: bool = True            # C2: dedup + hierarchical aggregation
    opau: bool = True                 # C3a: clip/EMA after aggregation, scalar-only
    opsw: bool = True                 # C3b: wire-dtype cast before collectives
    wire_dtype: str = "bfloat16"
    # sparse-exchange capacity mode (static-shape TPU adaptation)
    capacity_mode: str = "exact"      # exact | capped
    capacity_factor: float = 1.0      # multiplier on expected unique rows
    # overflow-driven capacity growth (capped mode): when a table's observed
    # ``*_dropped`` EMA stays above ``overflow_tolerance`` rows/step, the
    # replan loop regrows that table's capacity to
    # ceil(observed_unique * capacity_factor * capacity_growth) — headroom
    # past measured demand so one growth absorbs recurring bursts.
    capacity_growth: float = 1.5
    overflow_tolerance: float = 0.5
    # memory strategy for dense params (auto-escalated by the planner)
    zero_stage: int = 0               # 0: replicate, 1: shard opt state, 3: fsdp
    remat: str = "block"              # none | block | full
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    optimizer: str = "adamw"
    learning_rate: float = 1e-3
    weight_decay: float = 0.0
    clip_norm: float = 1.0
    ema_decay: float = 0.0            # 0 disables EMA shadow params
    seed: int = 0
    # §Perf knobs (beyond-paper optimizations; default off = paper-faithful)
    explicit_sp: bool = False         # explicit AG/RS sequence-parallel blocks
    dense_strategy: str = "tp"        # tp | dp (dp: model axis joins data)
    # §Exchange-schedule knobs: these change how the Table-3 plan *executes*
    # (collective fusion, kernel choice), never what is exchanged — wire
    # bytes, placement, and math are those of the paper's plan (summation
    # order aside), so bucketing defaults on. Set bucket_bytes=0 for the
    # per-tensor baseline.
    # bucketed dense-gradient exchange (core/buckets.py): fuse per-tensor
    # all-reduces into flat buffers of at most this many wire bytes. 0
    # disables. Applies on data-parallel meshes (every non-batch axis size
    # 1); elsewhere the planner falls back to per-tensor collectives.
    bucket_bytes: int = 4 * 1024 * 1024
    # embedding gather/scatter implementation for the sparse hot path in
    # the JAX package: jnp | pallas. Kept for field-for-field parity only:
    # the port reads it nowhere — its gather and scatter dispatch on the
    # tensor's device (kernels/ops.py: the plain version on the CPU, the
    # CUDA kernel on the card).
    embed_impl: str = "jnp"
    # per-message collective latency override (seconds) for the planner's
    # α + β·b argmin; None = utils/roofline.py HW.link_latency. 0 recovers
    # the paper's pure-byte Table-3 argmin.
    link_latency: Optional[float] = None
    # path to a fitted hardware profile (tools/profile_collectives.py fit):
    # JSON overriding link_bw/link_latency and — on multi-host meshes — the
    # inter-host inter_bw/inter_latency tier, so the planner's argmin and
    # the two-level-schedule choice run on measured constants, not defaults.
    hw_profile: Optional[str] = None
    # communication/computation overlap for the bucketed exchange: buckets
    # are ordered reverse-topologically by the backward pass and each
    # bucket's fused psum is issued inside the backward graph as soon as its
    # last gradient is produced (core/buckets.py custom_vjp taps). False
    # pins every bucket collective strictly after the full backward — the
    # regression baseline; the math is bit-identical either way.
    overlap: bool = True
    # attention implementation: naive (tests) | chunked (dry-run) | pallas (TPU)
    attention_impl: str = "chunked"
    attention_chunk: int = 1024
    moe_exec: str = "auto"            # auto | ep | tp
    # estimated fraction of vocab touched per replica-step (sparsity alpha);
    # None -> derived from shape (min(1, local_tokens / vocab)).
    sparsity_alpha: Optional[float] = None
    # declared token skew for the *planner*: when set, the census estimates
    # expected-unique under folded Zipf(zipf_a) instead of the uniform upper
    # bound (core/sparsity.py::expected_unique_zipf). None = uniform bound.
    zipf_a: Optional[float] = None
    # per-table planner declarations (tuples of (table_name, value) pairs so
    # the frozen config stays hashable): a table named here gets its own
    # census skew / activated-fraction instead of the global zipf_a /
    # sparsity_alpha — two tables with different skews legitimately land on
    # different methods and capacities in one analyze() call.
    table_zipf: tuple = ()            # e.g. (("embed", 1.3),)
    table_alpha: tuple = ()           # e.g. (("enc_embed", 0.99),)
    # profiled wire-dtype selection: when True, the replan loop reads the
    # in-graph dense-gradient magnitude census (per-bucket |g|inf / rms
    # scalars riding the fused metrics psum, core/buckets.py) and keeps a
    # bucket's parameters at float32 on the wire when its peak-to-rms ratio
    # exceeds ``wire_outlier_ratio`` (outlier-prone grads lose too much to
    # bf16 rounding); everything else rides ``wire_dtype``.
    wire_dtype_auto: bool = False
    wire_outlier_ratio: float = 64.0
    # fused bucket-apply (optim/optimizer.py update_fused): when the bucketed
    # exchange is active, keep adamw/momentum state as flat per-bucket f32
    # buffers and apply the update straight from the post-psum wire buffer —
    # no unflatten -> per-param update -> reflatten round trip. Bit-identical
    # to the per-param path at f32; eligibility also needs zero_stage 0 and
    # opau (core/buckets.py fused_apply_eligible).
    fused_apply: bool = True
    # roofline-guided measured autotune of the Pallas embed_gather /
    # embed_scatter_add block sizes (kernels/autotune.py): a small sweep per
    # (table shape, dtype, backend) cached on disk; False = fixed full-row
    # blocks. Tile choice never changes the math, only the schedule.
    kernel_autotune: bool = False
    # per-host heartbeat scalars riding the fused metrics psum: each data
    # slice contributes a host-stamped timing value decoded host-side for
    # straggler *attribution* (runtime/monitor.py names the slow process
    # instead of dropping the last slice by convention). Adds one batch
    # entry ("_heartbeat") and D scalar metrics; off by default so
    # non-Trainer callers keep their input pytrees.
    heartbeat: bool = False
    # bounded-staleness sparse fallback (the DeepSpark-style degraded mode,
    # applied per-table through the plan): sparse tables flipped to
    # ``stale`` apply s-step-old exchanged gradients through a staleness
    # buffer in the train state while dense buckets stay synchronous.
    # 0 disables the machinery entirely (no buffer in the state); >0 bounds
    # the age any applied sparse gradient may reach (asserted in-graph via
    # the ``staleness_violation`` metric).
    max_staleness: int = 0
    # debug gate (analysis/contract.py): the first step after every build
    # and replan records its collectives (core/collectives.py::record) and
    # diffs them against the plan's exchange contract before the optimizer
    # applies, raising ContractViolation on a mismatch (the state is left
    # as it was). Costs one synchronize on that step; off by default.
    verify_contract: bool = False


def reduced(cfg: ModelConfig, *, layers: int = 2, d_model: int = 64,
            heads: int = 4, kv_heads: int = 2, d_ff: int = 128,
            vocab: int = 512, experts: int = 4, head_dim: int = 16) -> ModelConfig:
    """Tiny same-family config for CPU smoke tests."""
    kw = dict(
        n_layers=layers, d_model=d_model, d_ff=d_ff,
        vocab_size=vocab, head_dim=head_dim,
    )
    if cfg.n_heads:
        kw.update(n_heads=heads, n_kv_heads=min(kv_heads, heads))
    else:
        kw.update(n_heads=0, n_kv_heads=0)
    if cfg.n_experts:
        kw.update(n_experts=min(experts, cfg.n_experts),
                  experts_per_token=min(cfg.experts_per_token, 2))
    if cfg.ssm_state:
        kw.update(ssm_state=min(cfg.ssm_state, 8))
    if cfg.is_encdec:
        kw.update(enc_layers=layers)
    return replace(cfg, **kw)


_REGISTRY: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    # populate registry lazily from the configs package
    if not _REGISTRY:
        from repro_torch.configs import ALL_ARCHS  # noqa: F401 (side effect)
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def all_configs() -> dict[str, ModelConfig]:
    if not _REGISTRY:
        from repro_torch.configs import ALL_ARCHS  # noqa: F401
    return dict(_REGISTRY)
