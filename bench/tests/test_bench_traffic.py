"""The traffic generator: a seed gives the same batches, every seed the
same sizes; ranks take contiguous rows."""
import numpy as np
import pytest

from bench.traffic import Stream, load_mix

SEEDS = (0, 7, 2 ** 31 + 11, 2 ** 40 + 3)


def test_shipped_mixes_load():
    for name, rows, seq, ranks in (("lm1b-zipf", 128, 20, 1),
                                   ("phi3-zipf", 8, 512, 1),
                                   ("lm1b-zipf-dp4", 128, 20, 4)):
        mix = load_mix(name)
        assert (mix.batch_per_rank, mix.seq_len, mix.ranks) == \
            (rows, seq, ranks)
        assert mix.dist == "zipf" and mix.a == 1.0


def test_a_seed_repeats_and_seeds_differ():
    mix = load_mix("lm1b-zipf")
    for seed in SEEDS:
        a, b = Stream(mix, 800_000, seed), Stream(mix, 800_000, seed)
        for step in (0, 1, 57):
            x, y = a.batch(step), b.batch(step)
            assert np.array_equal(x["tokens"], y["tokens"])
            assert np.array_equal(x["labels"], y["labels"])
    t = [Stream(mix, 800_000, s).batch(0)["tokens"] for s in SEEDS]
    assert all(not np.array_equal(t[0], u) for u in t[1:])
    s = Stream(mix, 800_000, SEEDS[0])
    assert not np.array_equal(s.batch(0)["tokens"], s.batch(1)["tokens"])


def test_every_seed_has_the_same_sizes():
    for name, vocab in (("lm1b-zipf", 800_000), ("phi3-zipf", 32_064),
                        ("lm1b-zipf-dp4", 800_000)):
        mix = load_mix(name)
        for seed in SEEDS:
            b = Stream(mix, vocab, seed).batch(3)
            assert b["tokens"].shape == (mix.global_batch, mix.seq_len)
            assert b["tokens"].dtype == np.int32
            assert 0 <= b["tokens"].min() and b["tokens"].max() < vocab
            # labels are the next token
            full = Stream(mix, vocab, seed)._ids(
                full_rng := Stream(mix, vocab, seed)._rng(3),
                (mix.global_batch, mix.seq_len + 1))
            assert np.array_equal(b["tokens"], full[:, :-1])
            assert np.array_equal(b["labels"], full[:, 1:])
            del full_rng


def test_ranks_take_contiguous_rows():
    mix = load_mix("lm1b-zipf-dp4")
    s = Stream(mix, 800_000, 5)
    b = s.batch(0)
    parts = [s.rank_rows(b, r)["tokens"] for r in range(mix.ranks)]
    assert all(p.shape == (128, 20) for p in parts)
    assert np.array_equal(np.concatenate(parts), b["tokens"])


def test_zipf_is_skewed_and_folded():
    """Ids follow the law truncated to the vocabulary: id k - 1 at a share
    k ** -a of the first's, and none past the vocabulary."""
    mix = load_mix("lm1b-zipf")
    ids = np.concatenate([Stream(mix, 1000, 3).batch(i)["tokens"].ravel()
                          for i in range(4)])
    counts = np.bincount(ids, minlength=1000)
    assert counts[0] > counts[1] > counts[10]
    assert ids.max() < 1000
    # the share of id 0 is 1 / H(1000) at a = 1
    h = np.sum(1.0 / np.arange(1, 1001))
    assert counts[0] / ids.size == pytest.approx(1 / h, rel=0.05)


def test_distinct_ids_a_step_at_the_lm_cells_shape():
    """At a = 1 over 800,000 ids a step of 128 x 20 tokens holds ~1,590
    distinct ids, on every seed within a few per cent."""
    mix = load_mix("lm1b-zipf")
    for seed in SEEDS:
        s = Stream(mix, 800_000, seed)
        u = [np.unique(s.batch(i)["tokens"]).size for i in range(3)]
        assert all(1_500 <= x <= 1_690 for x in u), u
