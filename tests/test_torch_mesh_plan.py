"""The port's planner on a mesh against the JAX package's, field for field.

The reference plans on 8 fake XLA devices in a subprocess
(``conftest.distributed_run``); the port plans on a ``MeshShape`` of the
same axes and sizes, with no process group. Both price against the
reference's TPU record (the port's default record is the H100's, which
moves the latency-bound argmins of the reduced model) and the same memory
budget. Compared: the resolved dense strategy, every table's method,
capacity and wire dtype, each parameter's method, placement, optimizer
placement and wire dtype, the per-device bytes of the escalation, and the
bucket plan (members, sizes, dtypes, placement keys, order, schedule).
"""
import pytest

from conftest import distributed_run
from repro.utils import roofline as jroof
import repro_torch.configs as tc
from repro_torch.core import cost_model as tcm
from repro_torch.core.plan import per_device_bytes
from repro_torch.core.runtime import Runtime
from repro_torch.core.transform import analyze
from repro_torch.launch.mesh import MeshShape
from repro_torch.models.layers import flatten_specs
from repro_torch.models.model import build_model
from repro_torch.utils import roofline as troof
from repro_torch.utils.dtypes import dtype_name

MESHES = [(2, 4), (4, 2), (2, 2), (4, 1), (1, 4)]
MODES = {"hybrid": {}, "ps": {"comm_mode": "ps"}, "mpi": {"comm_mode": "mpi"},
         "no_opsw": {"opsw": False},
         # a near-dense table: ps where the Zipf estimate plans ps_gather
         "ps_alpha": {"comm_mode": "ps", "table_alpha": (("embed", 0.9),)}}
WIDTHS = {
    # reduced parallax-lm at f32, the exit test's shape
    "reduced": (True, ("tiny", 32, 4, "train"),
                dict(param_dtype="float32", compute_dtype="float32",
                     wire_dtype="float32")),
    # the paper's width and per-GPU batch, default RunConfig (bf16)
    "full": (False, ("lm1b", 20, 128, "train"), {}),
}
CASES = [(w, m, mode) for w in WIDTHS for m in MESHES for mode in MODES]
BUDGET = 0.9 * jroof.HW.hbm_bytes

_REF = """
from repro.configs import get_config, reduced, RunConfig, ShapeConfig
from repro.core.plan import per_device_bytes
from repro.core.runtime import Runtime
from repro.core.transform import analyze
from repro.models.layers import ParamSpec
from repro.models.model import build_model
from repro.utils.tree import named_leaves

def entry(e):
    return None if e is None else (e if isinstance(e, str) else list(e))

def pspec(p):
    return [entry(e) for e in tuple(p)]

out = {{}}
for width, mesh_shape, mode, red, shape, kw in {cases}:
    cfg = get_config("parallax-lm")
    if red:
        cfg = reduced(cfg)
    mesh = make_mesh(tuple(mesh_shape), ("data", "model"))
    rt = Runtime(cfg, RunConfig(**kw), ShapeConfig(*shape), mesh=mesh)
    model = build_model(cfg, rt)
    plan = analyze(model, rt, memory_budget={budget})
    leaves = [p for _, p in named_leaves(plan.params)]
    specs = [s for _, s in named_leaves(model.specs())]
    bp = plan.bucket_plan
    out["|".join((width, "x".join(map(str, mesh_shape)), mode))] = {{
        "strategy": rt.resolved_strategy,
        "batch_axes": list(rt.batch_axes), "replicas": rt.replicas,
        "padded_vocab": rt.padded_vocab,
        "tables": plan.tables(), "capacity": plan.capacity,
        "alpha": plan.alpha, "zero_stage": plan.zero_stage,
        "embed_method": plan.embed_method,
        "params": [[p.name, p.method, pspec(p.pspec), pspec(p.opt_pspec),
                    jnp.dtype(p.wire_dtype).name, p.bytes, p.capacity,
                    p.est_cost] for p in leaves],
        "per_device_bytes": per_device_bytes(model.specs(), rt.rules,
                                             plan.params),
        "buckets": None if bp is None else {{
            "batch_axes": list(bp.batch_axes), "replicas": bp.replicas,
            "n_params": bp.n_params, "wire_bytes": bp.wire_bytes,
            "bucket_bytes": bp.bucket_bytes, "hosts": bp.hosts,
            "overlap": bp.overlap, "n_sparse_push": bp.n_sparse_push,
            "list": [[list(b.idx), list(b.sizes), b.key[0], b.key[1],
                      [entry(e) for e in b.key[2]], b.nbytes, b.schedule]
                     for b in bp.buckets]}},
    }}
print("RESULT:" + json.dumps(out))
"""


def _entry(e):
    return e if e is None or isinstance(e, str) else tuple(e)


def _pspec(p) -> tuple:
    return tuple(_entry(e) for e in p)


@pytest.fixture(scope="module")
def reference_plans():
    cases = [(w, m, mode, WIDTHS[w][0], WIDTHS[w][1],
              dict(WIDTHS[w][2], **MODES[mode])) for w, m, mode in CASES]
    code = "import jax.numpy as jnp\n" + _REF.format(cases=repr(cases),
                                                     budget=BUDGET)
    return distributed_run(code, devices=8, timeout=300)


def _tpu_hw_for_port():
    h = jroof.HW
    return troof.Hardware(name=h.name, peak_flops=h.peak_flops,
                          hbm_bw=h.hbm_bw, link_bw=h.link_bw,
                          hbm_bytes=h.hbm_bytes, smem_bytes=h.vmem_bytes,
                          link_latency=h.link_latency,
                          inter_bw=h.inter_bw,
                          inter_latency=h.inter_latency)


@pytest.mark.distributed
@pytest.mark.parametrize("width,mesh,mode", CASES,
                         ids=["-".join((w, "x".join(map(str, m)), mode))
                              for w, m, mode in CASES])
def test_mesh_plan_matches_reference(reference_plans, monkeypatch, width,
                                     mesh, mode):
    want = reference_plans["|".join((width, "x".join(map(str, mesh)),
                                     mode))]
    monkeypatch.setattr(tcm, "HW", _tpu_hw_for_port())
    red, shape, kw = WIDTHS[width]
    cfg = tc.get_config("parallax-lm")
    if red:
        cfg = tc.reduced(cfg)
    ms = MeshShape(mesh, ("data", "model"))
    rt = Runtime(cfg, tc.RunConfig(**kw, **MODES[mode]),
                 tc.ShapeConfig(*shape), mesh=ms, device="cpu")
    model = build_model(cfg, rt)
    got = analyze(model, rt, memory_budget=BUDGET)

    assert rt.resolved_strategy == want["strategy"]
    assert list(rt.batch_axes) == want["batch_axes"]
    assert (rt.replicas, rt.padded_vocab) == (want["replicas"],
                                              want["padded_vocab"])
    assert got.tables() == want["tables"]
    assert (got.capacity, got.alpha, got.zero_stage, got.embed_method) == \
        (want["capacity"], want["alpha"], want["zero_stage"],
         want["embed_method"])
    assert [n for n, *_ in want["params"]] == list(got.params)
    for name, method, pspec, opt, wire, nbytes, cap, cost in want["params"]:
        p = got.params[name]
        assert (p.method, p.placement, p.opt_placement) == \
            (method, _pspec(pspec), _pspec(opt)), name
        assert (dtype_name(p.wire_dtype), p.bytes, p.capacity) == \
            (wire, nbytes, cap), name
        assert p.est_cost == cost, name
    assert per_device_bytes(flatten_specs(model.specs()), rt.rules,
                            list(got.params.values())) == \
        want["per_device_bytes"]
    bp, wb = got.bucket_plan, want["buckets"]
    assert (bp is None) == (wb is None)
    if bp is not None:
        assert (list(bp.batch_axes), bp.replicas, bp.n_params,
                bp.wire_bytes, bp.bucket_bytes, bp.hosts, bp.overlap,
                bp.n_sparse_push) == \
            (wb["batch_axes"], wb["replicas"], wb["n_params"],
             wb["wire_bytes"], wb["bucket_bytes"], wb["hosts"],
             wb["overlap"], wb["n_sparse_push"])
        got_list = [(list(b.idx), list(b.sizes), b.key[0], b.key[1],
                     _pspec(b.key[2]), b.nbytes, b.schedule)
                    for b in bp.buckets]
        want_list = [(i, s, m, d, _pspec(k), nb, sc)
                     for i, s, m, d, k, nb, sc in wb["list"]]
        assert got_list == want_list
