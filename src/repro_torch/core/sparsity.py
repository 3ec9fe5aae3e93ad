"""Parameter sparsity census (paper §3.2 / Table 1 analogue) — the port of
the estimators and ``run_census`` of ``repro/core/sparsity.py``.

A parameter is sparse when its ``ParamSpec.sparse`` says it is read only
through integer gathers, and its activated fraction α is estimated from the
workload:

  α ≈ E[#unique ids per replica-step] / vocab_rows

under the uniform-draw bound ``V·(1 - (1-1/V)^T)`` or, when a skew is
declared, the folded-Zipf expectation. The runtime profile that refines
these estimates (``SparsityProfile``, ``observed_census``,
``wire_dtype_hints``) comes with ROADMAP slice 3.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any

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
