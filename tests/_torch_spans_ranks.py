"""The ranks of tests/test_torch_spans.py: spawned processes
(``launch/mesh.py::spawn``) that import the port alone."""
from torch.profiler import ProfilerActivity, profile

import repro_torch.configs as tc
from repro_torch.core.transform import get_runner
from repro_torch.data import SyntheticLM
from repro_torch.launch.mesh import make_mesh
from repro_torch.utils.spans import NAMES

SEQ, BATCH, STEPS = 8, 4, 2


def mesh_spans_rank(rank, world, mesh_shape, flags):
    """Two steps of reduced parallax-lm on this rank of ``mesh_shape``
    under the profiler: -> the embedding's method, whether its push was
    deferred past the backward, and {span: [(start, end)]}."""
    m = make_mesh(mesh_shape, ("data", "model"), device="cpu")
    cfg = tc.reduced(tc.get_config("parallax-lm"))
    r = get_runner(cfg, tc.ShapeConfig("tiny", SEQ, BATCH, "train"),
                   tc.RunConfig(param_dtype="float32",
                                compute_dtype="float32", **flags), mesh=m)
    ds = SyntheticLM(cfg.vocab_size, SEQ, BATCH)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(STEPS):
            r.run(ds.batch(i))
    by: dict = {}
    for ev in prof.events():
        if ev.name in NAMES:
            by.setdefault(ev.name, []).append(
                (ev.time_range.start, ev.time_range.end))
    bp = r.plan.bucket_plan
    return {"method": r.plan.table_methods["embed"],
            "deferred": bp is not None and not bp.overlap,
            "spans": by}
