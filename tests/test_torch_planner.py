"""The port's planner against the JAX package's: the census, the Table-3
method argmin over a sweep of meshes, α and link latencies, and
single-device ``analyze()``. Pure math on both sides, so the answers must
be identical. The port's cost model is given the reference's TPU hardware
values for the sweep; its own default record is the H100's."""
import dataclasses
import itertools

import jax.numpy as jnp
import pytest

from repro.configs import RunConfig, ShapeConfig, get_config, reduced
from repro.core import cost_model as jcm
from repro.core import sparsity as jsp
from repro.core.runtime import Runtime as JRuntime
from repro.core.transform import analyze as janalyze
from repro.models import lstm as jlstm
from repro.models.model import build_model as jbuild
from repro.utils import roofline as jroof
from repro.utils.tree import named_leaves
import repro_torch.configs as tc
from repro_torch.core import cost_model as tcm
from repro_torch.core import sparsity as tsp
from repro_torch.core.runtime import Runtime
from repro_torch.core.transform import analyze
from repro_torch.models import lstm as tlstm
from repro_torch.models.model import build_model
from repro_torch.utils import roofline as troof
from repro_torch.utils.dtypes import dtype_name

RUN_CFGS = {
    "default": {},
    "zipf": dict(zipf_a=1.3),
    "alpha": dict(sparsity_alpha=0.1),
    "table_alpha": dict(table_alpha=(("embed", 0.5),)),
    "table_zipf": dict(table_zipf=(("embed", 1.1),), zipf_a=1.5),
    "capped": dict(capacity_mode="capped", capacity_factor=1.5, zipf_a=1.2),
    "no_opsw_f32": dict(opsw=False, param_dtype="float32",
                        compute_dtype="float32"),
    "mpi": dict(comm_mode="mpi"),
    "ps": dict(comm_mode="ps"),
}
SHAPES = {"lm1b": (20, 128, "train"), "tiny": (16, 4, "train"),
          "decode": (64, 8, "decode")}


def _tpu_hw_for_port():
    """The reference's default record, field for field, in the port's
    Hardware type (smem_bytes stands where vmem_bytes was)."""
    h = jroof.HW
    return troof.Hardware(name=h.name, peak_flops=h.peak_flops,
                          hbm_bw=h.hbm_bw, link_bw=h.link_bw,
                          hbm_bytes=h.hbm_bytes, smem_bytes=h.vmem_bytes,
                          link_latency=h.link_latency,
                          inter_bw=h.inter_bw,
                          inter_latency=h.inter_latency)


def test_h100_record_is_the_datasheet():
    hw = troof.HW
    assert hw.name == "h100-sxm"
    assert (hw.peak_flops, hw.hbm_bw, hw.hbm_bytes, hw.link_bw,
            hw.smem_bytes) == (989e12, 3.35e12, 80e9, 450e9, 232448)
    assert not hw.hierarchical


@pytest.mark.parametrize("tokens,vocab,a", [
    (64, 512, None), (2560, 800000, None), (2560, 800000, 1.3),
    (1, 10, 1.1), (5000, 300, 2.0)])
def test_estimators_match(tokens, vocab, a):
    assert tsp.expected_unique(tokens, vocab) == \
        jsp.expected_unique(tokens, vocab)
    if a is not None:
        assert tsp.expected_unique_zipf(tokens, vocab, a) == \
            jsp.expected_unique_zipf(tokens, vocab, a)


def _census_pair(arch_reduced, rc_kw, shape_key, replicas):
    s, b, kind = SHAPES[shape_key]
    jcfg = get_config("parallax-lm")
    tcfg = tc.get_config("parallax-lm")
    if arch_reduced:
        jcfg, tcfg = reduced(jcfg), tc.reduced(tcfg)
    jrt = JRuntime(jcfg, RunConfig(**rc_kw), ShapeConfig("x", s, b, kind))
    trt = Runtime(tcfg, tc.RunConfig(**rc_kw), tc.ShapeConfig("x", s, b, kind),
                  device="cpu")
    want = jsp.run_census(jlstm.model_specs(jcfg, jrt), jcfg, jrt.shape_cfg,
                          jrt.run_cfg, replicas)
    got = tsp.run_census(tlstm.model_specs(tcfg, trt), tcfg, trt.shape_cfg,
                         trt.run_cfg, replicas)
    return want, got


@pytest.mark.parametrize("rc", list(RUN_CFGS))
@pytest.mark.parametrize("shape", list(SHAPES))
def test_run_census_matches(rc, shape):
    for arch_reduced, replicas in itertools.product((False, True), (1, 4)):
        want, got = _census_pair(arch_reduced, RUN_CFGS[rc], shape, replicas)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("hierarchical", [False, True])
@pytest.mark.parametrize("comm_mode", ["hybrid", "ps", "mpi"])
def test_choose_method_sweep_matches(comm_mode, hierarchical):
    jhw = jroof.HW
    if hierarchical:
        jhw = dataclasses.replace(jhw, inter_bw=12.5e9, inter_latency=2e-5)
    thw0 = _tpu_hw_for_port()
    n = 0
    for latency, model, data, pod, hosts in itertools.product(
            (0.0, 1e-6, 1e-4), (1, 2, 4), (1, 2, 8), (1, 2), (1, 2)):
        jh = dataclasses.replace(jhw, link_latency=latency)
        th = dataclasses.replace(thw0, link_latency=latency,
                                 inter_bw=jh.inter_bw,
                                 inter_latency=jh.inter_latency)
        jd = jcm.MeshDims(model, data, pod, hosts)
        td = tcm.MeshDims(model, data, pod, hosts)
        for b, alpha, sparse, shard in itertools.product(
                (4e3, 2e6, 8e8), (1e-3, 0.05, 0.5, 1.0), (True, False),
                (True, False)):
            kw = dict(b=b, sparse=sparse, alpha=alpha, comm_mode=comm_mode,
                      can_shard_rows=shard)
            want = jcm.choose_method(dims=jd, hw=jh, **kw)
            got = tcm.choose_method(dims=td, hw=th, **kw)
            assert got == want, (kw, model, data, pod, hosts, latency)
            assert tcm.method_seconds(b=b, alpha=alpha, dims=td, hw=th) == \
                jcm.method_seconds(b=b, alpha=alpha, dims=jd, hw=jh)
            n += 1
        assert tcm.dense_schedule_seconds(3e7, td, th) == \
            jcm.dense_schedule_seconds(3e7, jd, jh)
    assert n == 3 * 3 * 3 * 2 * 2 * 3 * 4 * 2 * 2


def test_resolve_hw_overrides_match(tmp_path):
    prof = tmp_path / "hw.json"
    prof.write_text('{"link_bw": 1e10, "link_latency": 3e-6, '
                    '"inter_bw": 1e9, "inter_latency": 1e-5, "junk": 1}')
    for kw in ({}, dict(link_latency=0.0), dict(hw_profile=str(prof)),
               dict(hw_profile=str(prof), link_latency=2e-6)):
        want = jcm.resolve_hw(RunConfig(**kw))
        got = tcm.resolve_hw(tc.RunConfig(**kw), hw=_tpu_hw_for_port())
        for f in ("link_bw", "link_latency", "inter_bw", "inter_latency"):
            assert getattr(got, f) == getattr(want, f), (kw, f)


@pytest.mark.parametrize("rc", list(RUN_CFGS))
def test_single_device_analyze_matches(rc):
    kw = RUN_CFGS[rc]
    jcfg = reduced(get_config("parallax-lm"))
    tcfg = tc.reduced(tc.get_config("parallax-lm"))
    shape = (16, 4, "train")
    jrt = JRuntime(jcfg, RunConfig(**kw), ShapeConfig("t", *shape))
    trt = Runtime(tcfg, tc.RunConfig(**kw), tc.ShapeConfig("t", *shape),
                  device="cpu")
    want = janalyze(jbuild(jcfg, jrt), jrt)
    got = analyze(build_model(tcfg, trt), trt)
    assert got.tables() == want.tables()
    assert got.table_methods == want.table_methods
    assert got.table_capacity == want.table_capacity
    assert got.table_alpha == want.table_alpha
    assert (got.alpha, got.capacity, got.embed_method) == \
        (want.alpha, want.capacity, want.embed_method)
    assert got.census() == want.census() and got.methods() == want.methods()
    assert want.bucket_plan is None     # one device: nothing bucketed
    jleaves = named_leaves(want.params)
    assert [n for n, _ in jleaves] == list(got.params)
    for name, jp in jleaves:
        tp = got.params[name]
        assert (tp.name, tp.method, tp.sparse, tp.bytes, tp.capacity,
                tp.stale, tp.est_cost) == \
            (jp.name, jp.method, jp.sparse, jp.bytes, jp.capacity,
             jp.stale, jp.est_cost), name
        assert dtype_name(tp.wire_dtype) == jnp.dtype(jp.wire_dtype).name
        assert tp.placement == tuple(jp.pspec)
    # the runtime reads its capacity and wire dtype from the plan alike
    jrt.plan, trt.plan = want, got
    assert trt.embed_capacity_for("embed") == jrt.embed_capacity_for("embed")
    assert dtype_name(trt.embed_ctx().wire_dtype) == \
        jnp.dtype(jrt.embed_ctx().wire_dtype).name
