"""The ranks of tests/test_torch_encdec_mesh.py: spawned processes
(``launch/mesh.py::spawn``) that train reduced seamless-m4t-medium (the
encoder-decoder, family ``audio``) on a gloo process mesh. They import the
port alone, not the JAX package."""
import dataclasses

import repro_torch.configs as tc
from repro_torch.core.transform import estimate_census, get_runner
from repro_torch.data import SyntheticLM
from repro_torch.launch.mesh import make_mesh
from repro_torch.optim.optimizer import is_fused
from repro_torch.weights import load_reference_params

ARCH = "seamless-m4t-medium"
SEQ, STEPS = 32, 3
# the reference correctness test's RunConfig
KW = dict(attention_impl="naive", remat="none", param_dtype="float32",
          compute_dtype="float32", wire_dtype="float32")
FLAG_SETS = {
    "hybrid": {"comm_mode": "hybrid"},
    "ps": {"comm_mode": "ps"},
    "mpi": {"comm_mode": "mpi"},
    "no_la": {"comm_mode": "hybrid", "local_agg": False},
    "no_opau": {"comm_mode": "hybrid", "opau": False},
    "no_opsw": {"comm_mode": "hybrid", "opsw": False},
}


def cfg():
    return tc.reduced(tc.get_config(ARCH))


def dataset(batch: int) -> SyntheticLM:
    """The reference's seamless batches: stub frames (B, 8, d)."""
    c = cfg()
    return SyntheticLM(c.vocab_size, SEQ, batch, is_encdec=True,
                       frames_dim=c.d_model, frames_len=8)


def shape(batch: int):
    return tc.ShapeConfig("tiny", SEQ, batch, "train")


def mesh_rank(rank, world, named, names):
    """Each flag set's 3 steps at global batch 4 on this rank of (2, 2),
    from the reference's parameters."""
    m = make_mesh((2, 2), ("data", "model"), device="cpu")
    ds = dataset(4)
    out = {}
    for name in names:
        r = get_runner(cfg(), shape(4), tc.RunConfig(**KW, **FLAG_SETS[name]),
                       mesh=m, params=load_reference_params(named, "cpu"))
        out[name] = {"loss": [float(r.run(ds.batch(i))["loss"])
                              for i in range(STEPS)],
                     "method": r.plan.table_methods["embed"],
                     "bucketed": r.plan.bucket_plan is not None}
    return out


def _sig(plan) -> list:
    return [[list(b.idx), b.key[1]] for b in plan.bucket_plan.buckets]


def regroup_rank(rank, world):
    """The reference's tests/test_fused_apply.py regroup case on (8, 1):
    comm_mode mpi (the decoder table keeps its gatherv row buffer beside
    the fused buckets), buckets of 256 KB; 2 steps, a forced replan at a
    quarter of the bucket budget (more, smaller buckets: the fused
    optimizer memory migrates), 2 more; fused apply on and off."""
    m = make_mesh((8, 1), ("data", "model"), device="cpu")
    kw = dict(KW, comm_mode="mpi", bucket_bytes=256 * 1024)
    ds = dataset(8)
    out = {}
    for fused in (True, False):
        r = get_runner(cfg(), shape(8), tc.RunConfig(**kw, fused_apply=fused),
                       mesh=m, seed=0)
        losses = [float(r.run(ds.batch(i))["loss"]) for i in range(2)]
        rec = {"pre_sig": _sig(r.plan), "pre_fused": is_fused(r.live_state),
               "pre_flag": bool(r.plan.fused_apply)}
        r.rt.run_cfg = dataclasses.replace(r.rt.run_cfg,
                                           bucket_bytes=64 * 1024)
        diff = r.replan(estimate_census(r.model, r.rt), force=True)
        losses += [float(r.run(ds.batch(i))["loss"]) for i in range(2, 4)]
        rec.update(losses=losses, post_sig=_sig(r.plan),
                   post_fused=is_fused(r.live_state),
                   post_flag=bool(r.plan.fused_apply),
                   rebuilt=bool(diff.get("rebuilt")),
                   method=r.plan.table_methods["embed"])
        out[str(fused)] = rec
    return out


def bucket_rank(rank, world, hw, named):
    """The reference's tests/test_perf_paths.py bucket case held by values:
    (8, 1), per-tensor exchange (bucket_bytes 0) against the default
    buckets; the dense parameters, the bucket members and stats, and 3
    steps of losses from each, from the reference's parameters
    ``named``. ``hw``: the hardware record the planner
    prices against (the test passes the reference's, so both packages
    route the tables alike)."""
    from repro_torch.core import cost_model
    cost_model.HW = hw
    m = make_mesh((8, 1), ("data", "model"), device="cpu")
    ds = dataset(8)
    out = {}
    for name, extra in (("flat", {"bucket_bytes": 0}), ("fused", {})):
        r = get_runner(cfg(), shape(8), tc.RunConfig(**KW, **extra), mesh=m,
                       params=load_reference_params(named, "cpu"))
        bp = r.plan.bucket_plan
        out[name] = {
            "n_dense": sum(1 for p in r.plan.params.values()
                           if p.method == "allreduce"),
            "embed": r.plan.table_methods["embed"],
            "buckets": None if bp is None else _sig(r.plan),
            "stats": None if bp is None else bp.stats(),
            "losses": [float(r.run(ds.batch(i))["loss"])
                       for i in range(STEPS)]}
    return out
