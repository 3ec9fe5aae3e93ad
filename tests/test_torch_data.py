"""The port's data pipeline is a numpy copy of the reference's: batches are
byte-identical across seed, step, replica split, bursts and stream skews."""
import numpy as np
import pytest

from repro.data import pipeline as jp
from repro_torch.data import pipeline as tp

CASES = [
    dict(vocab=512, seq_len=16, global_batch=4),
    dict(vocab=512, seq_len=16, global_batch=4, seed=7),
    dict(vocab=800000, seq_len=20, global_batch=8, zipf_a=1.1),
    dict(vocab=300, seq_len=8, global_batch=8, replica_id=1, num_replicas=4),
    dict(vocab=300, seq_len=8, global_batch=4, zipf_a=1.0),
    dict(vocab=256, seq_len=12, global_batch=4, burst_steps=2,
         burst_zipf_a=0.0),
    dict(vocab=256, seq_len=12, global_batch=4, burst_steps=3,
         burst_zipf_a=1.05),
    dict(vocab=256, seq_len=12, global_batch=4, is_encdec=True),
    dict(vocab=256, seq_len=12, global_batch=4, is_encdec=True,
         src_zipf_a=0.0),
    dict(vocab=256, seq_len=12, global_batch=4, is_encdec=True,
         frames_dim=6, frames_len=3),
]


@pytest.mark.parametrize("kw", CASES, ids=lambda kw: ",".join(
    f"{k}={v}" for k, v in kw.items()))
def test_batches_byte_identical(kw):
    ref, port = jp.Dataset(**kw), tp.Dataset(**kw)
    for step in (0, 1, 2, 5):
        want, got = ref.batch(step), port.batch(step)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            assert got[k].shape == want[k].shape, k
            assert got[k].tobytes() == want[k].tobytes(), (step, k)


def test_shard_and_unique_counts_match():
    ref = jp.SyntheticLM(1000, 16, 8, seed=3)
    port = tp.SyntheticLM(1000, 16, 8, seed=3)
    assert port.unique_counts(4) == ref.unique_counts(4)
    for r in range(4):
        a = jp.shard(ref, r, 4).batch(1)
        b = tp.shard(port, r, 4).batch(1)
        np.testing.assert_array_equal(b["tokens"], a["tokens"])
        np.testing.assert_array_equal(b["labels"], a["labels"])
