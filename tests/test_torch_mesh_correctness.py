"""The paper's correctness property (§3.1) for the port: the synchronous
step on a (data, model) process mesh computes what one device computes at
equal global batch — for comm_mode hybrid, ps and mpi and with each of LA,
OPAU and OPSW off (the JAX package's ``tests/test_transform_correctness.py``
flag sets), on gloo meshes (2, 4), (2, 2) and (4, 1).

Reduced parallax-lm at f32, ``ShapeConfig("tiny", 32, 4)``, 3 steps. The
parameters are the JAX package's seeded init, loaded into every rank
through ``weights.load_reference_params``. Each flag set's losses must lie
within the reference test's own bar, 5e-4 + 1e-4·i at step i, of the JAX
package's single-device trajectory (run here from the same parameters)
and of the port's own one-device run; every rank must report the same
losses. The census metrics must equal what the plan's exchange implies for
the batch: each replica's unique ids averaged over the replicas (a table
on the dense exchange outside buckets: the global batch's).

Also the port of ``test_clip_after_aggregation_semantics``: clipping acts
on the aggregated gradient, so a (4, 2) mesh's clipped step reports the
one-device global norm.
"""
import numpy as np
import pytest

import _torch_mesh_ranks as R
from repro.configs import RunConfig, ShapeConfig, get_config, reduced
from repro.core.transform import get_runner as jget_runner
from repro.utils.tree import named_leaves
import repro_torch.configs as tc
from repro_torch.core.transform import get_runner
from repro_torch.launch.mesh import spawn
from repro_torch.utils.tree import named_parameters
from repro_torch.weights import load_reference_params

pytestmark = pytest.mark.distributed

MESHES = [(2, 4), (2, 2), (4, 1)]
# Adam's first steps move each weight by about lr = 1e-3 whatever the
# gradient's size, so last-bit loss differences show at ~1e-6 here
TOL_PARAM = 1e-5


def _bar(i: int) -> float:
    return 5e-4 + 1e-4 * i


@pytest.fixture(scope="module")
def reference():
    """The JAX package's single-device trajectory and its parameters."""
    jr = jget_runner(reduced(get_config("parallax-lm")),
                     ShapeConfig("tiny", R.SEQ, R.BATCH, "train"),
                     RunConfig(**R.KW), seed=0)
    named = {n: np.asarray(a) for n, a in named_leaves(jr.state.params)}
    losses = [float(jr.run(b)["loss"]) for b in R.batches()]
    return named, losses


@pytest.fixture(scope="module")
def port(reference):
    named, _ = reference
    one = get_runner(R.cfg(), R.shape(), tc.RunConfig(**R.KW, comm_mode="ps"),
                     device="cpu", params=load_reference_params(named, "cpu"))
    single = [float(one.run(b)["loss"]) for b in R.batches()]
    single_params = {k: v.detach().numpy()
                     for k, v in named_parameters(one.model).items()}
    meshes = {shape: spawn(R.mesh_rank, shape[0] * shape[1], "gloo",
                           args=(shape, named), timeout=300)
              for shape in MESHES}
    return single, single_params, meshes


def _census(tokens: np.ndarray, method: str, bucketed: bool, n: int,
            local_agg: bool) -> dict:
    """The census the plan's exchange implies for one global batch."""
    vp = R.cfg().vocab_size
    if method == "allreduce" and not bucketed:
        blocks = [tokens]                  # one dedupe of the global batch
    else:
        blocks = np.split(tokens, n)       # each replica's contiguous rows
    uniq = [np.unique(b).size if local_agg else b.size for b in blocks]
    t = blocks[0].size
    return {"embed_unique": float(np.mean(uniq)),
            "embed_rows": float(min(t, vp) if local_agg else t),
            "embed_dropped": 0.0}


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("flags", list(R.FLAG_SETS))
def test_mesh_equals_single_device(reference, port, shape, flags):
    _, jax_losses = reference
    single, _, meshes = port
    ranks = [r[flags] for r in meshes[shape]]
    got = ranks[0]["loss"]
    assert all(r["loss"] == got for r in ranks), [r["loss"] for r in ranks]
    for i, (a, b, c) in enumerate(zip(got, jax_losses, single)):
        assert abs(a - b) < _bar(i), (flags, i, got, jax_losses)
        assert abs(a - c) < _bar(i), (flags, i, got, single)
    r0 = ranks[0]
    local_agg = R.FLAG_SETS[flags].get("local_agg", True)
    for i, b in enumerate(R.batches()):
        assert r0["census"][i] == _census(
            b["tokens"], r0["method"], r0["bucketed"], r0["replicas"],
            local_agg), (flags, i)


def test_clip_after_aggregation_semantics(reference):
    """Clipping must act on the *aggregated* gradient (paper §3.1):
    per-replica clipping gives a different, wrong, update. The mesh's
    norms (with OPAU's partial sums and with the gathered gradients of
    opau=False) must be the one-device norms, and large enough that
    clipping acts."""
    named, _ = reference
    one = get_runner(R.cfg(), R.shape(16), tc.RunConfig(**R.CLIP_KW),
                     device="cpu", params=load_reference_params(named, "cpu"))
    ref = [float(one.run(b)["grad_norm"]) for b in R.batches(16, 2)]
    assert min(ref) > R.CLIP_KW["clip_norm"]
    for r in spawn(R.clip_rank, 8, "gloo", args=(named,), timeout=300):
        for name, dist in r.items():
            for a, b in zip(ref, dist):
                assert abs(a - b) / max(abs(a), 1e-9) < 1e-3, (name, ref,
                                                                dist)


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(map(str, s)))
def test_gathered_params_equal_single_device(port, shape):
    """The ps plan's shards after 3 steps (the table row-sharded, the head
    FSDP over data as well), gathered whole by ``weights.gather_params``,
    are the one-device parameters: every rank gathers the same."""
    _, single_params, meshes = port
    for r in meshes[shape]:
        got = r["ps_params"]
        assert list(got) == list(single_params)
        for k, want in single_params.items():
            np.testing.assert_allclose(got[k], want, rtol=0, atol=TOL_PARAM,
                                       err_msg=k)


def test_bf16_mesh_close_to_single_device():
    """At the default bf16 (parameters, compute and wire), hybrid and ps on
    a (2, 2) mesh stay within test_torch_runner.py's bf16 bar, rtol 2e-2,
    of the port's one-device run; both start from the seed-0 init, which
    every rank draws alike."""
    one = get_runner(R.cfg(), R.shape(16), tc.RunConfig(), device="cpu",
                     seed=0)
    single = [float(one.run(b)["loss"]) for b in R.batches(16)]
    for r in spawn(R.bf16_rank, 4, "gloo", timeout=300):
        for name, got in r.items():
            np.testing.assert_allclose(got, single, rtol=2e-2, err_msg=name)
