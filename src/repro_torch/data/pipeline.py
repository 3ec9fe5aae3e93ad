"""Data pipeline with the paper's ``shard()`` API (Table 2).

``shard(ds)`` splits a dataset into disjoint per-replica streams — here by
deterministic index striding, so (a) every replica sees a disjoint subset,
(b) the union over replicas equals the single-device stream (the correctness
precondition for data-parallel ≡ single-device), and (c) training can resume
mid-epoch from a step counter alone (fault tolerance: no iterator state in
checkpoints).

Synthetic corpora draw tokens from a Zipf-like distribution so embedding-row
sparsity (α) behaves like natural text rather than uniform noise.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np


@dataclass
class Dataset:
    """A deterministic, index-addressable batch source."""
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    replica_id: int = 0
    num_replicas: int = 1
    zipf_a: float = 1.3
    is_encdec: bool = False
    frames_dim: int = 0
    frames_len: int = 0
    # per-stream skew: the encoder-side src_tokens stream can carry its own
    # distribution (None = same as zipf_a; 0 = uniform over the vocab, i.e.
    # a near-dense table) — the two-table per-parameter planning scenario
    src_zipf_a: Optional[float] = None
    # workload shift: the first ``burst_steps`` batches draw tokens at
    # ``burst_zipf_a`` (0 = uniform) before settling to zipf_a — a sustained
    # high-unique burst that overflows a capped dedupe buffer and exercises
    # the overflow-driven capacity-growth replan
    burst_steps: int = 0
    burst_zipf_a: float = 0.0

    @property
    def local_batch(self) -> int:
        assert self.global_batch % self.num_replicas == 0
        return self.global_batch // self.num_replicas

    def _rng(self, step: int) -> np.random.Generator:
        # step-addressed GLOBAL stream: every replica generates the same
        # global batch and slices its disjoint rows, so the union over
        # replicas is exactly the single-device stream (paper §3.1) and
        # resume needs only the step counter.
        return np.random.default_rng(
            np.random.SeedSequence([self.seed, step]))

    def _tokens(self, rng, shape, a: Optional[float] = None) -> np.ndarray:
        a = self.zipf_a if a is None else a
        if a <= 1.0:
            # a <= 1 has no proper Zipf normalization: uniform ids
            return rng.integers(0, self.vocab, size=shape, dtype=np.int64) \
                .astype(np.int32)
        # bounded Zipf: rejection-free via truncated zipf ranks
        ranks = rng.zipf(a, size=shape)
        return ((ranks - 1) % self.vocab).astype(np.int32)

    def _step_a(self, step: int) -> Optional[float]:
        if self.burst_steps and step < self.burst_steps:
            return self.burst_zipf_a
        return None

    def batch(self, step: int) -> dict:
        rng = self._rng(step)
        b, s = self.global_batch, self.seq_len
        toks = self._tokens(rng, (b, s + 1), self._step_a(step))
        out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if self.is_encdec and self.frames_dim:
            out["frames"] = rng.standard_normal(
                (b, self.frames_len, self.frames_dim)).astype(np.float32) * 0.02
        elif self.is_encdec:
            out["src_tokens"] = self._tokens(rng, (b, s), self.src_zipf_a)
        if self.num_replicas > 1:
            sl = slice(self.replica_id, None, self.num_replicas)
            out = {k: v[sl] for k, v in out.items()}
        return out

    def unique_counts(self, steps: int = 8, start: int = 0) -> list:
        """Empirical unique token ids per (per-replica) batch — the ground
        truth the census estimators and the runtime profiler are pinned
        against (tests/test_replan.py)."""
        return [int(np.unique(self.batch(s)["tokens"]).size)
                for s in range(start, start + steps)]

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


def SyntheticLM(vocab: int, seq_len: int, global_batch: int, seed: int = 0,
                **kw) -> Dataset:
    return Dataset(vocab=vocab, seq_len=seq_len, global_batch=global_batch,
                   seed=seed, **kw)


def shard(ds: Dataset, replica_id: int = 0, num_replicas: int = 1) -> Dataset:
    """The paper's shard() API: disjoint per-replica split."""
    return dataclasses.replace(ds, replica_id=replica_id,
                               num_replicas=num_replicas)


def make_batch_specs(model, shape_cfg) -> dict:
    """ShapeDtypeStructs for a training batch (mirrors Model.input_specs)."""
    return model.input_specs(shape_cfg)
