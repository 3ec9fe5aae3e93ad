"""Replans on gloo process meshes, against the JAX package on fake XLA
devices (``conftest.distributed_run``):

* a method-flipping replan: reduced parallax-lm at vocab 256 (the vocab at
  which the reference's ``analyze`` flips it; at the reduced default 512
  it does not) on (4, 2), the reference test's knobs (f32, capped 2.0,
  link latency 0): the uniform estimate plans ``ps``, the observed census
  ``ps_gather``; the placements hold; the losses equal the static run's
  and the reference's adaptive run's within 5e-4 + 1e-4·i;
* a replan that moves placements (``ps`` -> the dense all-reduce, the
  flip case on (4, 2)) keeps every state bit, and one that regroups the
  fused buckets of reduced parallax-nmt on (4, 1) migrates the fused
  state bit for bit (fused and per-param runs equal).
"""
import numpy as np
import pytest

import _torch_replan_ranks as RR
from conftest import distributed_run
from repro.configs import RunConfig, ShapeConfig, get_config, reduced
from repro.core.transform import get_runner as jget_runner
from repro.utils.tree import named_leaves
from repro_torch.launch.mesh import spawn

pytestmark = pytest.mark.distributed


def _named(kw: dict) -> dict:
    """The JAX package's seed-0 parameters of the flip case's model."""
    jr = jget_runner(reduced(get_config("parallax-lm"), vocab=RR.FLIP_VOCAB),
                     ShapeConfig("tiny", RR.FLIP_SEQ, RR.FLIP_BATCH,
                                 "train"), RunConfig(**kw), seed=0)
    return {n: np.asarray(a) for n, a in named_leaves(jr.state.params)}


FLIP_CODE = """
from repro.configs import RunConfig, ShapeConfig, get_config, reduced
from repro.core.sparsity import SparsityProfile, observed_census
from repro.core.transform import estimate_census, get_runner
from repro.data import SyntheticLM

cfg = reduced(get_config("parallax-lm"), vocab=256)
shape = ShapeConfig("tiny", seq_len=32, global_batch=8, kind="train")
kw = dict(param_dtype="float32", compute_dtype="float32",
          wire_dtype="float32", capacity_mode="capped", capacity_factor=2.0,
          link_latency=0.0)
ds = SyntheticLM(256, 32, 8)
mesh = make_mesh((4, 2), ("data", "model"))
with use_mesh(mesh):
    run = get_runner(cfg, shape, RunConfig(**kw), mesh=mesh)
    first, prof, losses = run.plan.embed_method, SparsityProfile(), []
    for i in range(8):
        m = run.run(ds.batch(i))
        losses.append(float(m["loss"]))
        prof.update({k: float(v) for k, v in m.items()
                     if getattr(v, "ndim", 0) == 0})
        if i == 3:
            d = run.replan(observed_census(
                prof, estimate_census(run.model, run.rt), 256,
                run.rt.run_cfg))
print("RESULT:" + json.dumps(dict(first=first, last=run.plan.embed_method,
    losses=losses, flips=d["flips"], tables=run.plan.tables())))
"""


def test_method_flipping_replan_preserves_trajectory():
    named = _named(RR.FLIP_KW)
    ref = distributed_run(FLIP_CODE, devices=8, timeout=600)
    ranks = spawn(RR.flip_rank, 8, "gloo", args=(named,), timeout=600)
    st, ad = ranks[0]["static"], ranks[0]["adaptive"]
    assert all(r["adaptive"]["losses"] == ad["losses"] for r in ranks)
    assert st["first"] == st["last"] == "ps"
    assert ref["first"] == "ps" and ref["last"] == "ps_gather", ref
    assert ad["first"] == "ps" and ad["last"] == "ps_gather", ad
    assert [tuple(f) for f in ad["flips"]] == \
        [tuple(f) for f in ref["flips"]] == [("embed", "ps", "ps_gather")]
    assert ad["rebuilt"] and not ad["pspecs_changed"]
    assert ad["tables"] == ref["tables"]
    assert ad["alpha"] < st["alpha"]
    for i, (a, s, j) in enumerate(zip(ad["losses"], st["losses"],
                                      ref["losses"])):
        assert abs(a - s) < 5e-4 + 1e-4 * i, (i, ad["losses"], st["losses"])
        assert abs(a - j) < 5e-4 + 1e-4 * i, (i, ad["losses"], ref["losses"])


def test_replans_that_move_state_keep_every_bit():
    moved = spawn(RR.placement_rank, 8, "gloo", timeout=600)
    for r in moved:
        mv = r["move"]
        assert mv["methods"][0] != mv["methods"][1], mv
        assert mv["pspecs_changed"] and mv["rebuilt"], mv
        assert mv["shards"][0] != mv["shards"][1], mv
        assert mv["bits_equal"]
        for i, (a, s) in enumerate(zip(r["adaptive"], r["static"])):
            assert abs(a - s) < 5e-4 + 1e-4 * i, (r["adaptive"],
                                                  r["static"])
    regroup = spawn(RR.regroup_rank, 4, "gloo", timeout=600)
    for r in regroup:
        f, p = r["True"], r["False"]
        assert f["pre_fused"] and f["post_fused"] and not p["post_fused"]
        assert f["pre_sig"] != f["post_sig"] == p["post_sig"]
        assert f["rebuilt"] and f["wire_flips"] and f["bits_equal"]
        assert p["bits_equal"]
        assert f["losses"] == p["losses"]
        assert all(np.array_equal(f["params"][n], p["params"][n])
                   for n in f["params"])
