"""The ranks of tests/test_torch_mesh_correctness.py,
test_torch_nmt_mesh.py and test_torch_fused_apply.py: spawned processes
(``launch/mesh.py::spawn``) that import the port alone, not the JAX
package."""
import repro_torch.configs as tc
from repro_torch.core.transform import get_runner
from repro_torch.data import SyntheticLM
from repro_torch.launch.mesh import make_mesh
from repro_torch.optim.optimizer import is_fused
from repro_torch.utils.tree import named_parameters
from repro_torch.weights import gather_params, load_reference_params

SEQ, BATCH, STEPS = 32, 4, 3
KW = dict(param_dtype="float32", compute_dtype="float32",
          wire_dtype="float32")
FLAG_SETS = {
    "hybrid": {"comm_mode": "hybrid"},
    "ps": {"comm_mode": "ps"},
    "mpi": {"comm_mode": "mpi"},
    "no_la": {"comm_mode": "hybrid", "local_agg": False},
    "no_opau": {"comm_mode": "hybrid", "opau": False},
    "no_opsw": {"comm_mode": "hybrid", "opsw": False},
    # beyond the reference's six: the bucketed exchange after the backward
    # (on (4, 1) the gatherv push deferred past it as well)
    "mpi_no_overlap": {"comm_mode": "mpi", "overlap": False},
}
CENSUS = ("embed_unique", "embed_rows", "embed_dropped")
CLIP_KW = dict(KW, clip_norm=0.05, learning_rate=0.05)


def cfg():
    return tc.reduced(tc.get_config("parallax-lm"))


def shape(seq=SEQ):
    return tc.ShapeConfig("tiny", seq, BATCH, "train")


def batches(seq=SEQ, steps=STEPS):
    ds = SyntheticLM(cfg().vocab_size, seq, BATCH)
    return [ds.batch(i) for i in range(steps)]


def mesh_rank(rank, world, mesh_shape, named):
    """Every flag set's 3 steps on this rank of ``mesh_shape``."""
    m = make_mesh(mesh_shape, ("data", "model"), device="cpu")
    out = {}
    for name, flags in FLAG_SETS.items():
        r = get_runner(cfg(), shape(), tc.RunConfig(**KW, **flags), mesh=m,
                       params=load_reference_params(named, "cpu"))
        ms = [r.run(b) for b in batches()]
        out[name] = {"loss": [float(x["loss"]) for x in ms],
                     "census": [{k: float(x[k]) for k in CENSUS}
                                for x in ms],
                     "method": r.plan.table_methods["embed"],
                     "bucketed": r.plan.bucket_plan is not None,
                     "replicas": r.rt.replicas}
        if name == "ps":
            # the whole parameters after 3 steps (every rank gathers)
            whole = gather_params(named_parameters(r.model), r.plan, m)
            out["ps_params"] = {k: v.detach().numpy()
                                for k, v in whole.items()}
    return out


def clip_rank(rank, world, named):
    """Two clipped steps on a (4, 2) mesh, with OPAU and without."""
    m = make_mesh((4, 2), ("data", "model"), device="cpu")
    out = {}
    for name, flags in (("opau", {}), ("no_opau", {"opau": False})):
        r = get_runner(cfg(), shape(16), tc.RunConfig(**CLIP_KW, **flags),
                       mesh=m, params=load_reference_params(named, "cpu"))
        out[name] = [float(r.run(b)["grad_norm"]) for b in batches(16, 2)]
    return out


def bf16_rank(rank, world):
    """The default bf16 RunConfig (OPSW's bf16 wire) under hybrid and ps on
    a (2, 2) mesh from the seed-0 init: the exchanges, FSDP's
    reduce-scatter included, at bf16."""
    m = make_mesh((2, 2), ("data", "model"), device="cpu")
    out = {}
    for name, flags in (("hybrid", {}), ("ps", {"comm_mode": "ps"})):
        r = get_runner(cfg(), shape(16), tc.RunConfig(**flags), mesh=m,
                       seed=0)
        out[name] = [float(r.run(b)["loss"]) for b in batches(16)]
    return out


# ---------------------------------------------------------------------------
# parallax-nmt: two sparse tables on one plan
# ---------------------------------------------------------------------------

NMT_VOCAB = 256
# the reference's two-table knobs (tests/test_serving.py,
# benchmarks/adaptive_replan.py): on (4, 1) they plan embed on mpi_gatherv
# and enc_embed on the dense all-reduce, in one bucket with the LSTMs
TWO_TABLE = dict(capacity_mode="capped", capacity_factor=1.5,
                 link_latency=0.0, table_zipf=(("embed", 1.3),),
                 table_alpha=(("enc_embed", 0.99),))
NMT_CENSUS = tuple(f"{t}_{k}" for t in ("embed", "enc_embed")
                   for k in ("unique", "rows", "dropped"))


def nmt_cfg():
    return tc.reduced(tc.get_config("parallax-nmt"), vocab=NMT_VOCAB)


def nmt_batches(steps=STEPS):
    """Zipf(1.3) targets, a uniform (near-dense) source stream."""
    ds = SyntheticLM(NMT_VOCAB, SEQ, BATCH, is_encdec=True, src_zipf_a=0.0)
    return [ds.batch(i) for i in range(steps)]


def _nmt_run(r) -> dict:
    ms = [r.run(b) for b in nmt_batches()]
    return {"loss": [float(x["loss"]) for x in ms],
            "census": [{k: float(x[k]) for k in NMT_CENSUS} for x in ms],
            "methods": {t: r.plan.table_methods[t]
                        for t in ("embed", "enc_embed")},
            "buckets": (len(r.plan.bucket_plan.buckets)
                        if r.plan.bucket_plan is not None else 0),
            "fused_apply": r.plan.fused_apply,
            "vocab_shards": r.rt.vocab_shards}


def nmt_mesh_rank(rank, world, mesh_shape, named, flag_sets):
    """Reduced parallax-nmt at f32 with the two-table knobs: each of
    ``flag_sets`` 3 steps on this rank of ``mesh_shape``."""
    m = make_mesh(mesh_shape, ("data", "model"), device="cpu")
    out = {}
    for name in flag_sets:
        r = get_runner(nmt_cfg(), shape(),
                       tc.RunConfig(**KW, **TWO_TABLE, **FLAG_SETS[name]),
                       mesh=m, params=load_reference_params(named, "cpu"))
        out[name] = _nmt_run(r)
    return out


FUSED_CASES = {
    # (optimizer knobs, overlap)
    "adamw": ({}, True),
    "adamw_no_overlap": ({}, False),
    "adamw_wd_ema": ({"weight_decay": 0.1, "ema_decay": 0.9}, True),
    "momentum_ema": ({"optimizer": "momentum", "ema_decay": 0.9,
                      "learning_rate": 1e-2, "clip_norm": 0.05}, False),
}


def fused_rank(rank, world):
    """Reduced parallax-nmt on (4, 1), 3 steps from the seed-0 init with
    fused_apply on and off: losses, final parameters and the canonical
    optimizer state."""
    m = make_mesh((4, 1), ("data", "model"), device="cpu")
    out = {}
    for case, (opt, overlap) in FUSED_CASES.items():
        for fused in (True, False):
            r = get_runner(nmt_cfg(), shape(),
                           tc.RunConfig(**KW, **TWO_TABLE, **opt,
                                        overlap=overlap, fused_apply=fused),
                           mesh=m, seed=0)
            res = _nmt_run(r)
            st = r.state
            res["live_fused"] = is_fused(r.live_state)
            res["params"] = {n: p.detach().numpy().copy()
                             for n, p in named_parameters(r.model).items()}
            res["state"] = {
                f"{part}.{n}": t.numpy().copy()
                for part in ("m", "v", "ema")
                for n, t in (getattr(st, part) or {}).items()}
            out[f"{case}|{fused}"] = res
    return out
