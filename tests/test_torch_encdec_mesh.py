"""seamless-m4t-medium (the encoder-decoder, family ``audio``) on gloo
process meshes in the port, against the JAX package, reduced at f32:

  * the paper's correctness property: on (2, 2) under the six flag sets of
    tests/test_transform_correctness.py (hybrid, ps, mpi, and each of LA,
    OPAU, OPSW off), 3 steps from the reference's seed-0 parameters, each
    within 5e-4 + 1e-4·i of the JAX package's single-device losses, the
    reference test's bar, and every rank reporting the same losses;
  * the reference's tests/test_fused_apply.py regroup case on (8, 1):
    fused and per-parameter trajectories equal bit for bit across a forced
    replan that regroups the buckets (the fused optimizer memory
    migrates), the decoder table on ``mpi_gatherv`` beside the buckets;
  * the reference's tests/test_perf_paths.py bucket case, held by values
    rather than HLO collective counts: on (8, 1) the dense parameters
    collapse into fewer buckets than tensors, the members of each bucket
    equal the reference planner's (over the reversed JAX flatten order),
    and per-tensor and bucketed losses agree within 2e-5 and lie within
    the bar of the JAX package's single-device run.
"""
import numpy as np
import pytest

import _torch_encdec_ranks as R
from conftest import distributed_run
from repro.configs import RunConfig, ShapeConfig, get_config, reduced
from repro.core.transform import get_runner as jget_runner
from repro.data import SyntheticLM
from repro.utils import roofline as jroof
from repro.utils.tree import named_leaves
from repro_torch.launch.mesh import spawn
from repro_torch.utils import roofline as troof

pytestmark = pytest.mark.distributed


def _bar(i: int) -> float:
    return 5e-4 + 1e-4 * i


def _jax_run(batch: int) -> tuple:
    cfg = reduced(get_config(R.ARCH))
    jr = jget_runner(cfg, ShapeConfig("tiny", R.SEQ, batch, "train"),
                     RunConfig(**R.KW), seed=0)
    named = {n: np.asarray(a) for n, a in named_leaves(jr.state.params)}
    ds = SyntheticLM(cfg.vocab_size, R.SEQ, batch, is_encdec=True,
                     frames_dim=cfg.d_model, frames_len=8)
    return named, [float(jr.run(ds.batch(i))["loss"])
                   for i in range(R.STEPS)]


@pytest.fixture(scope="module")
def reference():
    return _jax_run(4)


@pytest.fixture(scope="module")
def flag_ranks(reference):
    return spawn(R.mesh_rank, 4, "gloo",
                 args=(reference[0], list(R.FLAG_SETS)), timeout=600)


@pytest.mark.parametrize("flags", list(R.FLAG_SETS))
def test_distributed_equals_single_device(reference, flag_ranks, flags):
    want = reference[1]
    ranks = [r[flags] for r in flag_ranks]
    got = ranks[0]["loss"]
    assert all(r["loss"] == got for r in ranks), [r["loss"] for r in ranks]
    for i, (a, b) in enumerate(zip(got, want)):
        assert abs(a - b) < _bar(i), (flags, i, got, want)
    if flags == "mpi":
        assert ranks[0]["method"] == "mpi_gatherv"


def test_fused_apply_bit_exact_across_regrouping_replan():
    for r in spawn(R.regroup_rank, 8, "gloo", timeout=600):
        f, p = r["True"], r["False"]
        assert f["pre_flag"] and f["pre_fused"] and f["post_fused"]
        assert not p["pre_flag"] and not p["post_fused"]
        assert f["method"] == "mpi_gatherv"
        assert f["rebuilt"] and f["pre_sig"] != f["post_sig"]
        assert len(f["post_sig"]) > len(f["pre_sig"])
        assert f["post_sig"] == p["post_sig"]
        assert f["losses"] == p["losses"], (f["losses"], p["losses"])


_REF_BUCKETS = """
from repro.configs import get_config, reduced, RunConfig, ShapeConfig
from repro.core.runtime import Runtime
from repro.core.transform import analyze
from repro.models.model import build_model

cfg = reduced(get_config("seamless-m4t-medium"))
kw = dict(attention_impl="naive", remat="none", param_dtype="float32",
          compute_dtype="float32", wire_dtype="float32")
mesh = make_mesh((8, 1), ("data", "model"))
rt = Runtime(cfg, RunConfig(**kw), ShapeConfig("tiny", 32, 8, "train"),
             mesh=mesh)
plan = analyze(build_model(cfg, rt), rt)
print("RESULT:" + json.dumps(
    [[list(b.idx), b.key[1]] for b in plan.bucket_plan.buckets]))
"""


def _reference_hw():
    """The reference's hardware record as the port's planner takes it: the
    port prices against the H100 by default, and its (8, 1) plan then
    routes ``embed`` to the dense bucket where the reference's TPU
    pricing keeps it on ``ps``."""
    h = jroof.HW
    return troof.Hardware(name=h.name, peak_flops=h.peak_flops,
                          hbm_bw=h.hbm_bw, link_bw=h.link_bw,
                          hbm_bytes=h.hbm_bytes, smem_bytes=h.vmem_bytes,
                          link_latency=h.link_latency, inter_bw=h.inter_bw,
                          inter_latency=h.inter_latency)


def test_bucketed_exchange_collapses_dense_parameters_by_value():
    want_buckets = distributed_run(_REF_BUCKETS, devices=8, timeout=300)
    named, want = _jax_run(8)
    ranks = spawn(R.bucket_rank, 8, "gloo", args=(_reference_hw(), named),
                  timeout=600)
    for r in ranks:
        flat, fused = r["flat"], r["fused"]
        assert fused["n_dense"] >= 20 and flat["buckets"] is None
        stats = fused["stats"]
        assert stats["n_collectives_dense"] < \
            stats["n_collectives_unbucketed"] == fused["n_dense"]
        assert fused["buckets"] == want_buckets
        diff = max(abs(a - b) for a, b in zip(flat["losses"],
                                              fused["losses"]))
        assert diff < 2e-5, (flat["losses"], fused["losses"])
        for i, (a, b) in enumerate(zip(fused["losses"], want)):
            assert abs(a - b) < _bar(i), (i, fused["losses"], want)
        assert r == ranks[0]
