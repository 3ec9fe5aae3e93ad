"""Parameter sparsity census (paper §3.2 / Table 1 analogue) — the port of
the estimators and ``run_census`` of ``repro/core/sparsity.py``.

A parameter is sparse when its ``ParamSpec.sparse`` says it is read only
through integer gathers, and its activated fraction α is estimated from the
workload:

  α ≈ E[#unique ids per replica-step] / vocab_rows

under the uniform-draw bound ``V·(1 - (1-1/V)^T)`` or, when a skew is
declared, the folded-Zipf expectation.

Planning-time estimates are only the opening bid: the paper profiles the
actual sparsity during the first iterations and re-optimizes the plan.
``SparsityProfile`` keeps a host-side EMA of the census scalars every step
emits (``{table}_unique`` / ``{table}_dropped`` from core/embedding.py;
``gbucket{k}_gmax`` / ``_grms`` and ``{table}_gmax`` / ``_grms`` from
core/buckets.py under ``RunConfig.wire_dtype_auto``); ``observed_census``
folds it back into a ``Census`` the planner re-runs on
(``transform.analyze(census=)``), growing a table whose buffer overflows;
``wire_dtype_hints`` turns the magnitude census into per-parameter wire
dtypes. Plain Python and numpy: the port keeps its own copy.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from typing import Any, Optional

import numpy as np

from repro_torch.configs.base import ModelConfig, RunConfig, ShapeConfig
from repro_torch.models.layers import flatten_specs


def expected_unique(tokens: int, vocab: int) -> float:
    """E[#unique] for `tokens` uniform draws from `vocab` rows."""
    if tokens <= 0 or vocab <= 0:
        return 0.0
    return vocab * (1.0 - math.exp(tokens * math.log1p(-1.0 / vocab)))


def zipf_row_probs(vocab: int, a: float, folds: int = 8) -> np.ndarray:
    """P(id == i) when ids are drawn as ``(zipf(a) - 1) % vocab`` (the
    synthetic-corpus scheme in data/pipeline.py).

    Unbounded Zipf ranks fold onto [0, vocab); the first ``folds`` wraps are
    summed exactly and the remaining tail mass (which varies slowly over any
    vocab-sized window at large rank) is spread uniformly.
    """
    if a <= 1.0:
        raise ValueError("zipf exponent must be > 1")
    n = vocab * folds
    ranks = np.arange(1, n + 1, dtype=np.float64)
    w = ranks ** -a
    # zeta(a) ~ partial sum + Euler-Maclaurin tail of the unbounded series
    tail = n ** (1.0 - a) / (a - 1.0) + 0.5 * n ** -a
    z = w.sum() + tail
    p = w.reshape(folds, vocab).sum(axis=0) / z
    return p + (tail / z) / vocab


def expected_unique_zipf(tokens: int, vocab: int, a: float = 1.3) -> float:
    """E[#unique] for `tokens` draws from the folded-Zipf(a) id distribution:
    E[U] = sum_i 1 - (1 - p_i)^T."""
    if tokens <= 0 or vocab <= 0:
        return 0.0
    p = np.minimum(zipf_row_probs(vocab, a), 1.0 - 1e-12)
    return float(np.sum(-np.expm1(tokens * np.log1p(-p))))


@dataclass
class TableCensus:
    """Per-sparse-table workload record — the planner's unit of decision."""
    name: str
    rows: int                  # table rows (padded vocab)
    tokens: int                # per-replica tokens touching the table / step
    unique: float              # expected unique rows / step
    alpha: float               # unique / rows
    capacity: int
    dropped: float = 0.0
    grown: bool = False


@dataclass
class Census:
    dense_params: int
    sparse_params: int
    alpha: float               # per-replica activated fraction of sparse rows
    local_tokens: int
    capacity: int              # binding (largest) sparse-exchange capacity
    tables: dict = field(default_factory=dict)   # name -> TableCensus
    wire_dtypes: dict = field(default_factory=dict)  # param name -> dtype str

    def alpha_for(self, name: str) -> float:
        t = self.tables.get(name)
        return t.alpha if t is not None else self.alpha

    def capacity_for(self, name: str) -> int:
        t = self.tables.get(name)
        return t.capacity if t is not None else self.capacity


def _per_table(run_cfg: RunConfig, name: str, rows: int, tokens: int):
    """(unique, alpha) for one table: per-table declarations (alpha, then
    zipf) beat the global knobs (sparsity_alpha, then zipf_a, then the
    uniform bound)."""
    t_alpha = dict(run_cfg.table_alpha).get(name)
    if t_alpha is not None:
        return t_alpha * rows, t_alpha
    t_zipf = dict(run_cfg.table_zipf).get(name)
    if t_zipf is None:
        if run_cfg.sparsity_alpha is not None:
            return run_cfg.sparsity_alpha * rows, run_cfg.sparsity_alpha
        t_zipf = run_cfg.zipf_a
    if t_zipf is not None and rows:
        uniq = expected_unique_zipf(tokens, rows, t_zipf)
    else:
        uniq = expected_unique(tokens, rows)
    return uniq, (uniq / rows if rows else 0.0)


def _capacity(run_cfg: RunConfig, uniq: float, tokens: int, rows: int) -> int:
    if run_cfg.capacity_mode == "exact":
        cap = min(tokens, rows)
    else:
        cap = min(int(math.ceil(uniq * run_cfg.capacity_factor)), tokens, rows)
    return max(cap, 8)


def run_census(specs: Any, model_cfg: ModelConfig, shape_cfg: ShapeConfig,
               run_cfg: RunConfig, replicas: int) -> Census:
    dense = sparse = 0
    tables: dict[str, TableCensus] = {}
    if shape_cfg.kind in ("train", "prefill"):
        local_tokens = shape_cfg.tokens // max(replicas, 1)
    else:  # decode: one token per sequence per step
        local_tokens = max(shape_cfg.global_batch // max(replicas, 1), 1)
    for name, s in flatten_specs(specs):
        n = math.prod(s.shape)
        if s.sparse:
            sparse += n
            rows = s.shape[0]
            uniq_t, alpha_t = _per_table(run_cfg, name, rows, local_tokens)
            tables[name] = TableCensus(
                name=name, rows=rows, tokens=local_tokens, unique=uniq_t,
                alpha=alpha_t,
                capacity=_capacity(run_cfg, uniq_t, local_tokens, rows))
        else:
            dense += n
    # binding aggregates: alpha from the unpadded vocab under the global
    # knobs, capacity = the worst table's
    vocab = model_cfg.vocab_size
    if run_cfg.sparsity_alpha is not None:
        alpha = run_cfg.sparsity_alpha
        uniq = alpha * vocab
    else:
        if run_cfg.zipf_a is not None and vocab:
            uniq = expected_unique_zipf(local_tokens, vocab, run_cfg.zipf_a)
        else:
            uniq = expected_unique(local_tokens, vocab)
        alpha = uniq / vocab if vocab else 0.0
    capacity = _capacity(run_cfg, uniq, local_tokens, vocab)
    if tables:
        capacity = max(capacity, max(t.capacity for t in tables.values()))
    return Census(dense, sparse, alpha, local_tokens, capacity, tables=tables)


# ---------------------------------------------------------------------------
# runtime profile: observed sparsity (the paper's early-iteration profiling)
# ---------------------------------------------------------------------------

# metric suffixes the profile EMAs: the sparse census (unique rows,
# overflow) and the dense-gradient magnitude census (per-bucket |g|inf/rms)
_PROFILE_SUFFIXES = ("_unique", "_dropped", "_gmax", "_grms")


@dataclass
class SparsityProfile:
    """Host-side EMA of the in-graph workload census, one entry per metric.

    The jitted step emits ``{table}_unique`` / ``{table}_dropped`` scalars
    per sparse table (core/embedding.py's dedupe census) and — under the
    bucketed exchange — ``gbucket{i}_gmax`` / ``gbucket{i}_grms`` dense-
    gradient magnitude scalars (core/buckets.py); ``update`` folds each
    host-materialized metrics dict into per-metric EMAs. ``observed_census``
    turns the profile into a Census the planner re-runs on.
    """
    decay: float = 0.9
    ema: dict = field(default_factory=dict)     # metric name -> EMA count
    last: dict = field(default_factory=dict)    # metric name -> last count
    steps: int = 0                              # steps with census data

    def update(self, metrics: dict) -> None:
        seen = False
        for k, v in metrics.items():
            if not k.endswith(_PROFILE_SUFFIXES):
                continue
            try:
                v = float(v)
            except (TypeError, ValueError):
                continue
            seen = seen or k.endswith("_unique")
            self.last[k] = v
            prev = self.ema.get(k)
            self.ema[k] = v if prev is None else \
                self.decay * prev + (1.0 - self.decay) * v
        if seen:
            self.steps += 1

    def ready(self, min_steps: int = 1) -> bool:
        return bool(self.ema) and self.steps >= min_steps

    @property
    def observed_unique(self) -> float:
        """Per-replica unique rows per step (max over sparse params — the
        capacity-binding table)."""
        return max((v for k, v in self.ema.items() if k.endswith("_unique")),
                   default=0.0)

    def unique_for(self, table: str) -> Optional[float]:
        return self.ema.get(f"{table}_unique")

    def dropped_for(self, table: str) -> float:
        return self.ema.get(f"{table}_dropped", 0.0)

    def dropped(self, tables=None) -> dict:
        """Per-table overflow EMA (rows silently zeroed per step) — the
        signal the monitor surfaces and the growth rule acts on. ``tables``
        (any container of table names) restricts the sweep to real sparse
        tables: other subsystems also emit ``*_dropped`` scalars (e.g. the
        MoE router's ``moe_dropped``) that are not buffer overflow."""
        out = {k[:-len("_dropped")]: v for k, v in self.ema.items()
               if k.endswith("_dropped")}
        if tables is not None:
            out = {k: v for k, v in out.items() if k in tables}
        return out

    def alpha(self, vocab: int) -> float:
        return self.observed_unique / vocab if vocab else 0.0

    def reset_grad_census(self) -> None:
        """Drop the per-bucket magnitude EMAs. Bucket metrics are keyed by
        *index*; after a replan regroups the buckets, index i names a
        different member set, and blending old-layout samples into its EMA
        would mis-attribute magnitudes across parameters."""
        for d in (self.ema, self.last):
            for k in [k for k in d if k.startswith("gbucket")]:
                del d[k]


def observed_census(profile: SparsityProfile, base: Census,
                    vocab: int, run_cfg: RunConfig,
                    live: Optional[dict] = None) -> Census:
    """Fold a runtime profile into a planning Census.

    Per-table: each table whose ``{name}_unique`` EMA has data gets its own
    measured α and capacity; a table whose ``{name}_dropped`` EMA stays above
    ``run_cfg.overflow_tolerance`` gets *grown* capacity — measured demand
    times ``capacity_factor * capacity_growth`` headroom (overflow means the
    live buffer is provably too small; the plain re-fit alone could sit
    inside the replan drift deadband forever). Totals and local_tokens stay
    structural (they don't drift at runtime).

    ``live`` ({table: (capacity, grown)} from the running plan — the
    trainer passes it) makes growth *sticky*: once the overflow stops, the
    dropped EMA decays below tolerance, and a bare re-fit would shrink the
    buffer by exactly ``capacity_growth`` — tripping the drift rule and
    re-introducing the overflow in an endless grow/shrink/recompile cycle.
    A previously-grown table therefore keeps growth-headroom sizing
    (``ceil(unique · factor · growth)``) — once a buffer has overflowed it
    stays provisioned with headroom, still tracking the demand EMA downward.
    """
    if not profile.ema or vocab <= 0:
        return base
    uniq = min(profile.observed_unique, vocab, base.local_tokens)
    alpha = uniq / vocab
    if run_cfg.capacity_mode == "exact":
        capacity = base.capacity      # exact mode sizes buffers per call-site
    else:
        capacity = min(int(math.ceil(uniq * run_cfg.capacity_factor)),
                       base.local_tokens, vocab)
    capacity = max(capacity, 8)
    tables = {}
    for name, t in base.tables.items():
        obs = profile.unique_for(name)
        if obs is None or run_cfg.capacity_mode == "exact":
            tables[name] = t
            continue
        # clip observed demand at rows only: a table on the dense/allreduce
        # path dedupes *global* ids, so its true unique count legitimately
        # exceeds the per-replica token estimate (lookup() re-clips the
        # buffer to its call-site token count anyway)
        uniq_t = min(obs, t.rows)
        cap_fit = max(min(int(math.ceil(uniq_t * run_cfg.capacity_factor)),
                          t.rows), 8)
        headroom = min(int(math.ceil(uniq_t * run_cfg.capacity_factor *
                                     run_cfg.capacity_growth)), t.rows)
        dropped_t = profile.dropped_for(name)
        live_cap, live_grown = (live or {}).get(name, (0, False))
        if dropped_t > run_cfg.overflow_tolerance:
            cap_t, grown = max(cap_fit, headroom), True
        elif live_grown:
            # sticky growth (see docstring): hold headroom sizing, tracking
            # the demand EMA downward, never snapping back to the bare fit
            cap_t = max(cap_fit, min(max(live_cap, cap_fit), headroom))
            grown = cap_t > cap_fit
        else:
            cap_t, grown = cap_fit, False
        tables[name] = replace(t, unique=uniq_t,
                               alpha=uniq_t / t.rows if t.rows else 0.0,
                               capacity=cap_t, dropped=dropped_t, grown=grown)
    if tables:
        capacity = max(capacity, max(t.capacity for t in tables.values()))
    return replace(base, alpha=alpha, capacity=capacity, tables=tables)


def wire_dtype_hints(profile: SparsityProfile, bucket_plan: Any,
                     param_names: list, *, outlier_ratio: float,
                     default: str = "bfloat16",
                     sparse_tables: Any = ()) -> dict:
    """Profiled per-parameter wire-dtype selection from the gradient
    magnitude census.

    Each bucket's ``gbucket{i}_gmax`` / ``gbucket{i}_grms`` EMAs summarize
    the magnitudes its member gradients ride the wire at. A bucket whose
    peak-to-rms ratio exceeds ``outlier_ratio`` is outlier-prone: bf16's
    ~8-bit mantissa quantizes the small-magnitude bulk relative to the
    outliers, so its members keep float32 on the wire; everybody else rides
    ``default``. Returns {param name -> dtype str} for Census.wire_dtypes.

    ``sparse_tables`` extends the same rule to sparse row-buffer pushes:
    a table that kept its own exchange emits ``{table}_gmax`` /
    ``{table}_grms`` scalars (core/buckets.py measures the densified
    post-exchange grad over the rows the push touched), so an
    outlier-prone table pins its row buffer to float32 too — without this
    the sparse push could never earn a pin.
    """
    hints: dict[str, str] = {}

    def judge(key_prefix: str):
        gmax = profile.ema.get(f"{key_prefix}_gmax")
        grms = profile.ema.get(f"{key_prefix}_grms")
        if gmax is None or grms is None:
            return None
        return "float32" if gmax > outlier_ratio * max(grms, 1e-30) \
            else default

    if bucket_plan is not None:
        for i, b in enumerate(bucket_plan.buckets):
            choice = judge(f"gbucket{i}")
            if choice is None:
                continue
            for j in b.idx:
                hints[param_names[j]] = choice
    for name in sparse_tables:
        choice = judge(name)
        if choice is not None:
            hints[name] = choice
    return hints
