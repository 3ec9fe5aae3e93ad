"""The port's planner on a mesh against the JAX package's, field for field,
for parallax-lm and for parallax-nmt (two sparse tables on one plan).

The reference plans on 8 fake XLA devices in a subprocess
(``conftest.distributed_run``); the port plans on a ``MeshShape`` of the
same axes and sizes, with no process group. Both price against the
reference's TPU record (the port's default record is the H100's, which
moves the latency-bound argmins of the reduced model) and the same memory
budget. Compared: the resolved dense strategy, every table's method,
capacity and wire dtype, each parameter's method, placement, optimizer
placement and wire dtype, the per-device bytes of the escalation, the
bucket plan (members, sizes, dtypes, placement keys, order, schedule) and
the fused-apply stamp. parallax-nmt plans with and without the reference's
two-table knobs (its tests' capped capacity × 1.5, zero link latency,
``embed`` declared Zipf 1.3 and ``enc_embed`` α 0.99), and at decode
shapes with the serve pricing (``test_serve_plan_flips_method_per_table``).
"""
import math

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
TWO_TABLE = dict(capacity_mode="capped", capacity_factor=1.5,
                 link_latency=0.0, table_zipf=(("embed", 1.3),),
                 table_alpha=(("enc_embed", 0.99),))
NMT_WIDTHS = {
    # the reference's two-table tests' size, at f32
    "reduced": (256, ("tiny", 32, 4, "train"),
                dict(param_dtype="float32", compute_dtype="float32",
                     wire_dtype="float32")),
    # the published width at GNMT's batch 128 and length 50 (bf16)
    "full": (None, ("wmt", 50, 128, "train"), {}),
}
NMT_MODES = {"default": {}, "two_table": TWO_TABLE}
NMT_CASES = [(w, m, mode) for w in NMT_WIDTHS for m in MESHES
             for mode in NMT_MODES]
# the dense transformer (phi3; command-r, tied): reduced at f32 with the
# exit test's shape, and the published width at launch/train.py's default
# shape (bf16), whose memory escalation reaches ZeRO-1 and ZeRO-3
DENSE_ARCHS = ("phi3-medium-14b", "command-r-35b")
DENSE_WIDTHS = {
    "reduced": (True, ("tiny", 32, 4, "train"),
                dict(param_dtype="float32", compute_dtype="float32",
                     wire_dtype="float32")),
    "full": (False, ("train", 512, 8, "train"), {}),
}
DENSE_MODES = {"hybrid": {}, "ps": {"comm_mode": "ps"},
               "mpi": {"comm_mode": "mpi"},
               "auto": {"dense_strategy": "auto"}}
DENSE_CASES = [(a, w, m, mode) for a in DENSE_ARCHS for w in DENSE_WIDTHS
               for m in MESHES for mode in DENSE_MODES]
# seamless-m4t-medium (the encoder-decoder: encoder and decoder stacks, the
# decoder's 256,206-row table, an untied head): reduced at f32 and the
# published width at launch/train.py's default shape (bf16)
ENCDEC = "seamless-m4t-medium"
ENCDEC_MODES = {"hybrid": {}, "ps": {"comm_mode": "ps"},
                "mpi": {"comm_mode": "mpi"}}
ENCDEC_CASES = [(w, m, mode) for w in DENSE_WIDTHS for m in MESHES
                for mode in ENCDEC_MODES]
# the reference's test_serve_plan_flips_method_per_table
SERVE_KW = dict(NMT_WIDTHS["reduced"][2], **TWO_TABLE)
SERVE_KINDS = ("decode", "train")

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
for key, arch, mesh_shape, red, shape, kw in {cases}:
    cfg = get_config(arch)
    if red is not None:
        cfg = reduced(cfg, **red)
    mesh = make_mesh(tuple(mesh_shape), ("data", "model"))
    rt = Runtime(cfg, RunConfig(**kw), ShapeConfig(*shape), mesh=mesh)
    model = build_model(cfg, rt)
    plan = analyze(model, rt, memory_budget={budget})
    leaves = [p for _, p in named_leaves(plan.params)]
    specs = [s for _, s in named_leaves(model.specs())]
    bp = plan.bucket_plan
    out[key] = {{
        "strategy": rt.resolved_strategy,
        "batch_axes": list(rt.batch_axes), "replicas": rt.replicas,
        "padded_vocab": rt.padded_vocab,
        "tables": plan.tables(), "capacity": plan.capacity,
        "alpha": plan.alpha, "zero_stage": plan.zero_stage,
        "embed_method": plan.embed_method,
        "fused_apply": plan.fused_apply,
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


def _key(*parts) -> str:
    return "|".join(p if isinstance(p, str) else "x".join(map(str, p))
                    for p in parts)


def _reference(cases: list) -> dict:
    code = "import jax.numpy as jnp\n" + _REF.format(cases=repr(cases),
                                                     budget=BUDGET)
    return distributed_run(code, devices=8, timeout=300)


@pytest.fixture(scope="module")
def reference_plans():
    return _reference([(_key(w, m, mode), "parallax-lm", m,
                        {} if WIDTHS[w][0] else None, WIDTHS[w][1],
                        dict(WIDTHS[w][2], **MODES[mode]))
                       for w, m, mode in CASES])


@pytest.fixture(scope="module")
def reference_nmt_plans():
    cases = [(_key("nmt", w, m, mode), "parallax-nmt", m,
              {"vocab": NMT_WIDTHS[w][0]} if NMT_WIDTHS[w][0] else None,
              NMT_WIDTHS[w][1], dict(NMT_WIDTHS[w][2], **NMT_MODES[mode]))
             for w, m, mode in NMT_CASES]
    cases += [(_key("serve", kind), "parallax-nmt", (4, 2), {"vocab": 256},
               ("probe", 64, 8, kind), SERVE_KW) for kind in SERVE_KINDS]
    return _reference(cases)


@pytest.fixture(scope="module")
def reference_dense_plans():
    return _reference([(_key(a, w, m, mode), a, m,
                        {} if DENSE_WIDTHS[w][0] else None,
                        DENSE_WIDTHS[w][1],
                        dict(DENSE_WIDTHS[w][2], **DENSE_MODES[mode]))
                       for a, w, m, mode in DENSE_CASES])


@pytest.fixture(scope="module")
def reference_encdec_plans():
    return _reference([(_key(ENCDEC, w, m, mode), ENCDEC, m,
                        {} if DENSE_WIDTHS[w][0] else None,
                        DENSE_WIDTHS[w][1],
                        dict(DENSE_WIDTHS[w][2], **ENCDEC_MODES[mode]))
                       for w, m, mode in ENCDEC_CASES])


def _tpu_hw_for_port():
    h = jroof.HW
    return troof.Hardware(name=h.name, peak_flops=h.peak_flops,
                          hbm_bw=h.hbm_bw, link_bw=h.link_bw,
                          hbm_bytes=h.hbm_bytes, smem_bytes=h.vmem_bytes,
                          link_latency=h.link_latency,
                          inter_bw=h.inter_bw,
                          inter_latency=h.inter_latency)


def _port_plan(cfg, mesh, shape, kw, device="cpu") -> tuple:
    ms = MeshShape(mesh, ("data", "model"))
    rt = Runtime(cfg, tc.RunConfig(**kw), tc.ShapeConfig(*shape), mesh=ms,
                 device=device)
    model = build_model(cfg, rt)
    return rt, model, analyze(model, rt, memory_budget=BUDGET)


@pytest.mark.distributed
@pytest.mark.parametrize("width,mesh,mode", CASES,
                         ids=["-".join((w, "x".join(map(str, m)), mode))
                              for w, m, mode in CASES])
def test_mesh_plan_matches_reference(reference_plans, monkeypatch, width,
                                     mesh, mode):
    want = reference_plans[_key(width, mesh, mode)]
    monkeypatch.setattr(tcm, "HW", _tpu_hw_for_port())
    red, shape, kw = WIDTHS[width]
    cfg = tc.get_config("parallax-lm")
    if red:
        cfg = tc.reduced(cfg)
    rt, model, got = _port_plan(cfg, mesh, shape, dict(kw, **MODES[mode]))
    _assert_plan_matches(want, rt, model, got)


@pytest.mark.distributed
@pytest.mark.parametrize("width,mesh,mode", NMT_CASES,
                         ids=["-".join((w, "x".join(map(str, m)), mode))
                              for w, m, mode in NMT_CASES])
def test_nmt_mesh_plan_matches_reference(reference_nmt_plans, monkeypatch,
                                         width, mesh, mode):
    want = reference_nmt_plans[_key("nmt", width, mesh, mode)]
    monkeypatch.setattr(tcm, "HW", _tpu_hw_for_port())
    vocab, shape, kw = NMT_WIDTHS[width]
    cfg = tc.get_config("parallax-nmt")
    if vocab:
        cfg = tc.reduced(cfg, vocab=vocab)
    rt, model, got = _port_plan(cfg, mesh, shape,
                                dict(kw, **NMT_MODES[mode]))
    assert set(got.tables()) == {"embed", "enc_embed"}
    _assert_plan_matches(want, rt, model, got)
    if mode == "two_table" and mesh == (4, 1):
        # one analyze(), the skewed table and the near-dense one on
        # different methods, the fused apply on
        t = got.tables()
        assert (t["embed"]["method"], t["enc_embed"]["method"]) == \
            ("mpi_gatherv", "allreduce")
        assert got.fused_apply and got.bucket_plan is not None


@pytest.mark.distributed
@pytest.mark.parametrize("arch,width,mesh,mode", DENSE_CASES,
                         ids=["-".join((a, w, "x".join(map(str, m)), mode))
                              for a, w, m, mode in DENSE_CASES])
def test_dense_mesh_plan_matches_reference(reference_dense_plans,
                                           monkeypatch, arch, width, mesh,
                                           mode):
    """phi3 and command-r plans, field for field: the placements of the
    q / KV heads and the MLP over ``model``, the tied table's method,
    buckets, the memory escalation and the resolved dense strategy. The
    port's model sits on the meta device: planning reads only the specs,
    and the published widths hold 14.7 and 35 B parameters."""
    want = reference_dense_plans[_key(arch, width, mesh, mode)]
    monkeypatch.setattr(tcm, "HW", _tpu_hw_for_port())
    red, shape, kw = DENSE_WIDTHS[width]
    cfg = tc.get_config(arch)
    if red:
        cfg = tc.reduced(cfg)
    rt, model, got = _port_plan(cfg, mesh, shape,
                                dict(kw, **DENSE_MODES[mode]),
                                device="meta")
    _assert_plan_matches(want, rt, model, got)
    # held: the port executes the reference's placement on every leaf
    # (the q heads, the MLP's d_ff and the vocab rows over model)
    for name, p in got.params.items():
        assert p.held == p.placement, (name, p.held, p.placement)


@pytest.mark.distributed
@pytest.mark.parametrize("width,mesh,mode", ENCDEC_CASES,
                         ids=["-".join((w, "x".join(map(str, m)), mode))
                              for w, m, mode in ENCDEC_CASES])
def test_encdec_mesh_plan_matches_reference(reference_encdec_plans,
                                            monkeypatch, width, mesh, mode):
    """seamless-m4t-medium's plans, field for field: the encoder's and the
    decoder's stacks (``enc_layers.*``, ``dec_layers.*``, the cross
    attention), the decoder table's method and capacity, the buckets over
    the reversed flatten order, and the memory escalation at the published
    width (on the meta device)."""
    want = reference_encdec_plans[_key(ENCDEC, width, mesh, mode)]
    monkeypatch.setattr(tcm, "HW", _tpu_hw_for_port())
    red, shape, kw = DENSE_WIDTHS[width]
    cfg = tc.get_config(ENCDEC)
    if red:
        cfg = tc.reduced(cfg)
    rt, model, got = _port_plan(cfg, mesh, shape,
                                dict(kw, **ENCDEC_MODES[mode]),
                                device="meta")
    assert set(got.tables()) == {"embed"}
    assert any(n.startswith("dec_layers.cross.") for n in got.params)
    _assert_plan_matches(want, rt, model, got)


@pytest.mark.distributed
def test_serve_plan_flips_method_per_table(reference_nmt_plans,
                                           monkeypatch):
    """The port of the reference's test of the same name: one analyze() at
    decode shapes on a (4 data x 2 model) mesh serves the Zipf-skewed
    table row-sharded (ps_gather, a nonzero per-token price) and the
    near-dense one replicated (free pulls); the serve pricing rides
    ``Plan.tables()`` only at decode. Both plans equal the reference's."""
    monkeypatch.setattr(tcm, "HW", _tpu_hw_for_port())
    cfg = tc.reduced(tc.get_config("parallax-nmt"), vocab=256)
    out = {}
    for kind in SERVE_KINDS:
        rt, model, plan = _port_plan(cfg, (4, 2), ("probe", 64, 8, kind),
                                     SERVE_KW)
        want = reference_nmt_plans[_key("serve", kind)]
        _assert_plan_matches(want, rt, model, plan)
        out[kind] = plan.tables()
    serve, train = out["decode"], out["train"]
    assert serve["embed"]["method"] == "ps_gather", serve
    assert serve["enc_embed"]["method"] == "allreduce", serve
    assert serve["embed"]["serve"]["s_per_token"] > 0.0, serve
    assert serve["embed"]["serve"]["pull_bytes"] > 0.0
    assert serve["enc_embed"]["serve"]["s_per_token"] == 0.0
    assert math.isfinite(serve["embed"]["serve"]["pull_s"])
    assert train["embed"]["serve"] is None
    assert train["enc_embed"]["serve"] is None


def _assert_plan_matches(want: dict, rt, model, got) -> None:
    assert rt.resolved_strategy == want["strategy"]
    assert list(rt.batch_axes) == want["batch_axes"]
    assert (rt.replicas, rt.padded_vocab) == (want["replicas"],
                                              want["padded_vocab"])
    assert got.tables() == want["tables"]
    assert (got.capacity, got.alpha, got.zero_stage, got.embed_method) == \
        (want["capacity"], want["alpha"], want["zero_stage"],
         want["embed_method"])
    assert got.fused_apply == want["fused_apply"]
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
