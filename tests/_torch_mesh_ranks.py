"""The ranks of tests/test_torch_mesh_correctness.py: spawned processes
(``launch/mesh.py::spawn``) that import the port alone, not the JAX
package."""
import repro_torch.configs as tc
from repro_torch.core.transform import get_runner
from repro_torch.data import SyntheticLM
from repro_torch.launch.mesh import make_mesh
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
