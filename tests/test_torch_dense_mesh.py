"""The paper's correctness property (§3.1) for the dense transformer in the
port: the synchronous step on a gloo process mesh computes what one device
computes at equal global batch. The port of the reference's
``test_distributed_equals_single_device`` for ``phi3-medium-14b`` (the six
flag sets: hybrid, ps, mpi and each of LA, OPAU, OPSW off) and
``command-r-35b`` (tied embeddings: hybrid and mpi, as the reference runs
it; here also the other four, so the tied table rides ``ps`` and
``ps_gather`` too) on (2, 4), and command-r on (4, 1), where the
bucketed step flips its gatherv table to the dense bucket (the tied-table
coherence rule, ``core/buckets.py::assign_buckets``).

Reduced configs at f32, the reference test's ``RunConfig`` (naive
attention, no remat), ``ShapeConfig("tiny", 32, 4)``, 3 steps, from the JAX
package's seeded init. Each run's losses must lie within the reference
test's own bar, 5e-4 + 1e-4·i at step i, of the JAX package's
single-device losses (run here from the same parameters), and every rank
must report the same losses. Every flag set runs inside one spawn, as the
reference runs them in one subprocess.

Padded q heads: reduced phi3 with 6 q heads on (2, 4) pads them to 8
(zero ``wq`` columns, outputs zeroed before the o-proj, as the reference
pads); its losses must be the unpadded one-device model's within the same
bar, and the padded heads' weights must stay zero.

Also the port of ``test_clip_after_aggregation_semantics`` on (4, 2):
clipping acts on the aggregated gradient, so the mesh reports the
one-device global norm within rel 1e-3.
"""
import numpy as np
import pytest

import _torch_dense_ranks as R
from repro.configs import RunConfig, ShapeConfig, get_config, reduced
from repro.core.transform import get_runner as jget_runner
from repro.utils.tree import named_leaves
from repro_torch.launch.mesh import spawn

pytestmark = pytest.mark.distributed

PHI3, COMMAND_R = "phi3-medium-14b", "command-r-35b"
# (mesh, arch) -> the flag sets it runs
RUNS = {((2, 4), PHI3): list(R.FLAG_SETS),
        ((2, 4), COMMAND_R): list(R.FLAG_SETS),
        ((4, 1), COMMAND_R): list(R.TIED_SETS)}
CASES = [(mesh, arch, name) for (mesh, arch), names in RUNS.items()
         for name in names]


def _bar(i: int) -> float:
    return 5e-4 + 1e-4 * i


def _jax_run(arch: str, layers=None, seq=R.SEQ, steps=R.STEPS,
             kw=R.KW, metric="loss", **red):
    if layers:
        red["layers"] = layers
    cfg = reduced(get_config(arch), **red)
    jr = jget_runner(cfg, ShapeConfig("tiny", seq, R.BATCH, "train"),
                     RunConfig(**kw), seed=0)
    named = {n: np.asarray(a) for n, a in named_leaves(jr.state.params)}
    got = [float(jr.run(b)[metric])
           for b in R.batches(cfg.vocab_size, seq, steps)]
    return named, got


@pytest.fixture(scope="module")
def reference():
    """The JAX package's single-device losses and its parameters."""
    return {arch: _jax_run(arch) for arch in (PHI3, COMMAND_R)}


@pytest.fixture(scope="module")
def meshes(reference):
    out = {}
    for mesh in sorted({m for m, _ in RUNS}):
        cases = [(arch, names, reference[arch][0])
                 for (m, arch), names in RUNS.items() if m == mesh]
        out[mesh] = spawn(R.mesh_rank, mesh[0] * mesh[1], "gloo",
                          args=(mesh, cases), timeout=400)
    return out


@pytest.mark.parametrize("mesh,arch,flags", CASES,
                         ids=["-".join(("x".join(map(str, m)), a, f))
                              for m, a, f in CASES])
def test_distributed_equals_single_device(reference, meshes, mesh, arch,
                                          flags):
    want = reference[arch][1]
    ranks = [r[f"{arch}/{flags}"] for r in meshes[mesh]]
    got = ranks[0]["loss"]
    assert all(r["loss"] == got for r in ranks), [r["loss"] for r in ranks]
    for i, (a, b) in enumerate(zip(got, want)):
        assert abs(a - b) < _bar(i), (arch, flags, i, got, want)
    if arch == COMMAND_R and flags == "mpi":
        # unbucketed (2, 4) keeps the tied table on gatherv; bucketed
        # (4, 1) moves it to the dense bucket
        want_method = "allreduce" if mesh == (4, 1) else "mpi_gatherv"
        assert ranks[0]["method"] == want_method
        assert ranks[0]["bucketed"] == (mesh == (4, 1))


def test_clip_after_aggregation_semantics():
    """Clipping must act on the *aggregated* gradient (paper §3.1): a
    (4, 2) mesh's clipped step reports the one-device global norm, which
    is large enough that clipping acts."""
    named, ref = _jax_run(PHI3, layers=1, seq=16, steps=2, kw=R.CLIP_KW,
                          metric="grad_norm")
    assert min(ref) > R.CLIP_KW["clip_norm"]
    for dist in spawn(R.clip_rank, 8, "gloo", args=(named,), timeout=300):
        for a, b in zip(ref, dist):
            assert abs(a - b) / max(abs(a), 1e-9) < 1e-3, (ref, dist)


def test_padded_q_heads_equal_the_unpadded_model():
    named, want = _jax_run(PHI3, heads=R.PAD_HEADS, kv_heads=R.PAD_KV)
    for r in spawn(R.padded_rank, 8, "gloo", args=(named,), timeout=300):
        for i, (a, b) in enumerate(zip(r["loss"], want)):
            assert abs(a - b) < _bar(i), (i, r["loss"], want)
        # no gradient reaches the padded heads' columns of wq and rows of
        # wo: they stay zero
        assert r["padded_max"] == 0.0
