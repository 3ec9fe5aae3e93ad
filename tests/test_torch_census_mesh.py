"""The magnitude census (``RunConfig.wire_dtype_auto``) on a gloo mesh
against the JAX package on fake XLA devices (``conftest.distributed_run``):
reduced parallax-nmt on (4, 1) with the two-table knobs, overlap on and
off. ``gbucket0_gmax`` / ``_grms`` and the gatherv table's ``embed_gmax`` /
``_grms`` lie within rtol 1e-5 of the reference's (f32; the gradients
differ in summation order), the census counts are equal, and the
per-table plan a replan from each run's own observed census installs is
equal (nmt's per-table capacities after a replan).
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
    """The JAX package's seed-0 parameters of the reduced nmt."""
    jr = jget_runner(reduced(get_config("parallax-nmt"), vocab=RR.NMT_VOCAB),
                     ShapeConfig("tiny", 32, 4, "train"), RunConfig(**kw),
                     seed=0)
    return {n: np.asarray(a) for n, a in named_leaves(jr.state.params)}


CENSUS_CODE = """
from repro.configs import RunConfig, ShapeConfig, get_config, reduced
from repro.core.sparsity import SparsityProfile, observed_census
from repro.core.transform import estimate_census, get_runner
from repro.data import SyntheticLM

cfg = reduced(get_config("parallax-nmt"), vocab=256)
shape = ShapeConfig("tiny", seq_len=32, global_batch=4, kind="train")
kw = dict(param_dtype="float32", compute_dtype="float32",
          wire_dtype="float32", capacity_mode="capped", capacity_factor=1.5,
          link_latency=0.0, table_zipf=(("embed", 1.3),),
          table_alpha=(("enc_embed", 0.99),), wire_dtype_auto=True,
          overlap={overlap})
ds = SyntheticLM(256, 32, 4, is_encdec=True, src_zipf_a=0.0)
mesh = make_mesh((4, 1), ("data", "model"))
out = []
with use_mesh(mesh):
    run = get_runner(cfg, shape, RunConfig(**kw), mesh=mesh)
    prof = SparsityProfile()
    for i in range(3):
        m = {{k: float(v) for k, v in run.run(ds.batch(i)).items()
              if getattr(v, "ndim", 0) == 0}}
        prof.update(m)
        out.append({{k: v for k, v in m.items()
                    if k.endswith(("_gmax", "_grms", "_unique", "_dropped"))
                    or k == "loss"}})
    d = run.replan(observed_census(prof, estimate_census(run.model, run.rt),
                                   256, run.rt.run_cfg), force=True)
print("RESULT:" + json.dumps(dict(metrics=out, tables=run.plan.tables(),
                                  table_capacity=d["table_capacity"])))
"""


@pytest.mark.parametrize("overlap", [True, False])
def test_magnitude_census_and_nmt_replan_match_reference(overlap):
    kw = dict(RR.F32, **RR.TWO_TABLE)
    named = _named(kw)
    ref = distributed_run(CENSUS_CODE.format(overlap=overlap), devices=4,
                          timeout=600)
    ranks = spawn(RR.census_rank, 4, "gloo", args=(named, overlap),
                  timeout=600)
    got = ranks[0]
    assert all(r["metrics"] == got["metrics"] for r in ranks)
    for i, (g, w) in enumerate(zip(got["metrics"], ref["metrics"])):
        assert set(g) == set(w), (set(g) ^ set(w))
        assert {"gbucket0_gmax", "gbucket0_grms", "embed_gmax",
                "embed_grms"} <= set(g)
        for k, v in w.items():
            if k.endswith(("_unique", "_dropped")):
                assert g[k] == v, (i, k)
            else:
                np.testing.assert_allclose(g[k], v, rtol=1e-5,
                                           err_msg=f"step {i} {k}")
    assert got["tables"] == ref["tables"]
    assert list(got["table_capacity"]) == ref["table_capacity"]
    assert np.isfinite(got["loss_after"])
