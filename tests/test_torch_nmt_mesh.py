"""The paper's correctness property (§3.1) for parallax-nmt, whose one plan
puts its two tables on different exchange methods: the synchronous step on
a gloo process mesh computes what one device computes at equal global
batch.

Reduced parallax-nmt (vocab 256) at f32, ``ShapeConfig("tiny", 32, 4)``,
with the reference's two-table knobs (capped capacity × 1.5, zero link
latency, ``embed`` declared Zipf 1.3, ``enc_embed`` declared α 0.99), 3
steps from the JAX package's seeded init. On (4, 1) the hybrid plan puts
``embed`` on ``mpi_gatherv`` and ``enc_embed`` on the dense all-reduce, in
a bucket with the dense parameters (the fused apply on). Under the six
flag sets of ``tests/test_transform_correctness.py`` (hybrid, ps, mpi, no
LA, no OPAU, no OPSW), and on (2, 2) under hybrid (no buckets, the head
vocab-sharded over ``model``), each step's loss lies within the reference
test's bar, 5e-4 + 1e-4·i at step i, of the JAX package's single-device
trajectory on the same batches; every rank reports the same losses; no
capped buffer drops a row (so the math is the single-device math); and the
census of both tables is what each plan's exchange implies.
"""
import numpy as np
import pytest

import _torch_mesh_ranks as R
from repro.configs import RunConfig, ShapeConfig, get_config, reduced
from repro.core.transform import get_runner as jget_runner
from repro.utils.tree import named_leaves
from repro_torch.launch.mesh import spawn

pytestmark = pytest.mark.distributed

FLAGS = ["hybrid", "ps", "mpi", "no_la", "no_opau", "no_opsw"]
CASES = [((4, 1), f) for f in FLAGS] + [((2, 2), "hybrid")]


def _bar(i: int) -> float:
    return 5e-4 + 1e-4 * i


@pytest.fixture(scope="module")
def reference():
    """The JAX package's single-device trajectory (exact capacity: one
    device's math) and its seeded parameters."""
    jr = jget_runner(reduced(get_config("parallax-nmt"), vocab=R.NMT_VOCAB),
                     ShapeConfig("tiny", R.SEQ, R.BATCH, "train"),
                     RunConfig(**R.KW), seed=0)
    named = {n: np.asarray(a) for n, a in named_leaves(jr.state.params)}
    losses = [float(jr.run(b)["loss"]) for b in R.nmt_batches()]
    return named, losses


@pytest.fixture(scope="module")
def meshes(reference):
    named, _ = reference
    return {
        (4, 1): spawn(R.nmt_mesh_rank, 4, "gloo",
                      args=((4, 1), named, FLAGS), timeout=600),
        (2, 2): spawn(R.nmt_mesh_rank, 4, "gloo",
                      args=((2, 2), named, ["hybrid"]), timeout=600),
    }


def _census(batch: dict, methods: dict, bucketed: bool, n: int,
            local_agg: bool) -> dict:
    """Both tables' census as each plan's exchange implies it: each
    replica's unique ids averaged over the replicas (a table on the dense
    exchange outside buckets: the global batch's)."""
    out = {}
    for table, key in (("embed", "tokens"), ("enc_embed", "src_tokens")):
        ids = batch[key]
        blocks = ([ids] if methods[table] == "allreduce" and not bucketed
                  else np.split(ids, n))
        uniq = [np.unique(b).size if local_agg else b.size for b in blocks]
        out[f"{table}_unique"] = float(np.mean(uniq))
        out[f"{table}_dropped"] = 0.0
    return out


@pytest.mark.parametrize("shape,flags", CASES,
                         ids=["x".join(map(str, s)) + "-" + f
                              for s, f in CASES])
def test_nmt_mesh_equals_single_device(reference, meshes, shape, flags):
    _, jax_losses = reference
    ranks = [r[flags] for r in meshes[shape]]
    r0 = ranks[0]
    assert all(r["loss"] == r0["loss"] for r in ranks), \
        [r["loss"] for r in ranks]
    for i, (a, b) in enumerate(zip(r0["loss"], jax_losses)):
        assert abs(a - b) < _bar(i), (flags, i, r0["loss"], jax_losses)
    if shape == (4, 1) and flags in ("hybrid", "no_la", "no_opsw"):
        # one analyze(), two methods: the skewed table gathered, the
        # near-dense one on the dense all-reduce, bucketed and fused
        assert r0["methods"] == {"embed": "mpi_gatherv",
                                 "enc_embed": "allreduce"}, r0["methods"]
        assert r0["buckets"] == 1 and r0["fused_apply"]
    if shape == (2, 2):
        assert r0["buckets"] == 0 and r0["vocab_shards"] == 2
        assert r0["methods"]["enc_embed"] == "allreduce"
    n = shape[0]
    local_agg = R.FLAG_SETS[flags].get("local_agg", True)
    for i, b in enumerate(R.nmt_batches()):
        got = {k: v for k, v in r0["census"][i].items()
               if not k.endswith("_rows")}
        assert got == _census(b, r0["methods"], r0["buckets"] > 0, n,
                              local_agg), (flags, i)
