"""The one traffic generator: a training stream of token ids, step by step,
from a mix file under ``bench/traffic/`` and the run's seed.

A mix file holds only parameters::

    {"seq_len": 20, "batch_per_rank": 128, "ranks": 1,
     "ids": {"dist": "zipf", "a": 1.0}}

``ranks`` ranks each train on ``batch_per_rank`` rows a step, so a step's
global batch is ``ranks * batch_per_rank`` rows of ``seq_len`` tokens;
rank r takes the contiguous rows ``[r * batch_per_rank, (r + 1) *
batch_per_rank)``, which is how the port cuts a global batch
(``core/transform.py::local_batch``). ``ids`` draws each token from a
distribution over the model's vocabulary: ``zipf`` (id ``k - 1`` with
probability proportional to ``k ** -a`` for ranks ``k`` = 1 .. vocabulary,
the law truncated to the vocabulary, so any ``a`` > 0 draws) or
``uniform``. Every seed gives the same sizes; only the ids differ. A mix
file may carry further keys (its ``source``), which the generator ignores.

The step-addressed ``SeedSequence`` follows the port's own synthetic corpus
(``repro_torch/data/pipeline.py::Dataset``), whose ``rng.zipf(a)`` folds the
ranks past the vocabulary back onto it and needs ``a`` > 1; the draw here is
the benchmark's own, so that no change to the port moves its inputs.
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

import numpy as np

TRAFFIC_DIR = Path(__file__).resolve().parent / "traffic"


@dataclass(frozen=True)
class Mix:
    name: str
    seq_len: int
    batch_per_rank: int
    ranks: int
    dist: str
    a: float = 0.0

    @property
    def global_batch(self) -> int:
        return self.batch_per_rank * self.ranks

    @property
    def tokens_per_step(self) -> int:
        """Tokens of one step over every rank."""
        return self.global_batch * self.seq_len


def load_mix(name: str, root: Path = TRAFFIC_DIR) -> Mix:
    """The mix ``name`` from ``<root>/<name>.json``."""
    raw = json.loads((root / f"{name}.json").read_text())
    ids = raw["ids"]
    if ids["dist"] not in ("zipf", "uniform"):
        raise ValueError(f"traffic {name}: unknown id distribution "
                         f"{ids['dist']!r} (zipf | uniform)")
    if ids["dist"] == "zipf" and not float(ids["a"]) > 0.0:
        raise ValueError(f"traffic {name}: zipf needs a > 0")
    return Mix(name=name, seq_len=int(raw["seq_len"]),
               batch_per_rank=int(raw["batch_per_rank"]),
               ranks=int(raw["ranks"]), dist=ids["dist"],
               a=float(ids.get("a", 0.0)))


class Stream:
    """Step-addressed global batches of ``mix`` over ``vocab`` ids: step
    ``i`` of seed ``s`` is the same array in every process that asks.
    ``batch(i)`` returns {"tokens", "labels"} (global rows, int32), the
    shape of batch the port's trainer takes from its dataset."""

    def __init__(self, mix: Mix, vocab: int, seed: int):
        self.mix, self.vocab, self.seed = mix, int(vocab), int(seed)
        self._cdf = None
        if mix.dist == "zipf":
            w = np.arange(1, self.vocab + 1, dtype=np.float64) ** -mix.a
            self._cdf = np.cumsum(w) / w.sum()

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.seed, int(step)]))

    def _ids(self, rng: np.random.Generator, shape: tuple) -> np.ndarray:
        if self.mix.dist == "uniform":
            return rng.integers(0, self.vocab, size=shape).astype(np.int32)
        ids = np.searchsorted(self._cdf, rng.random(shape), side="right")
        return np.minimum(ids, self.vocab - 1).astype(np.int32)

    def batch(self, step: int) -> dict:
        toks = self._ids(self._rng(step),
                         (self.mix.global_batch, self.mix.seq_len + 1))
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def rank_rows(self, batch: dict, rank: int) -> dict:
        """Rank ``rank``'s contiguous rows of a global batch."""
        n = self.mix.batch_per_rank
        return {k: v[rank * n:(rank + 1) * n] for k, v in batch.items()}
