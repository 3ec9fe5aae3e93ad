"""The fused bucket-apply (``optim/optimizer.py::update_fused`` and the
fused m/v/EMA layout): bit-identical to the per-parameter update, as the
JAX package's ``tests/test_fused_apply.py`` asserts for the reference.

On a hand-built ``BucketPlan`` (no process group): ``fuse_state`` then
``unfuse_state`` is the identity, and ``update_fused`` on the exchange's
flat buffers equals ``update`` on the sliced-back gradients bit for bit
over 3 steps, for adamw (clipping that acts, weight decay with a
per-parameter mask, with and without EMA) and momentum, at f32 and bf16
parameters and f32 and bf16 wires. On gloo (4, 1): reduced parallax-nmt
with the two-table knobs, 3 steps with ``fused_apply`` on and off, with the
bucketed exchange issued from the gradient hooks and after the backward:
losses, every final parameter and the canonical optimizer state equal bit
for bit. And the stamp: ``Plan.fused_apply`` only where the reference
stamps it.
"""
import numpy as np
import pytest
import torch

import _torch_mesh_ranks as R
import repro_torch.configs as tc
from repro_torch.core import buckets
from repro_torch.core.runtime import Runtime
from repro_torch.core.transform import analyze, make_train_step
from repro_torch.launch.mesh import MeshShape, spawn
from repro_torch.models.model import build_model
from repro_torch.optim.optimizer import (adamw, fuse_state, is_fused,
                                         momentum, sgd, unfuse_state)

SHAPES = {"a": (3, 5), "b": (7,), "c": (2, 2, 2), "d": (4, 3),
          "table": (16, 4)}
NAMES = list(SHAPES)
# buckets over the reversed order, the table left to its own exchange
BUCKET_IDX = [(3, 2), (1, 0)]
WD_MASK = {"a": 1.0, "b": 0.0, "c": 0.5, "d": 1.0, "table": 0.0}
OPTIMIZERS = {
    "adamw_clip_wd_mask": lambda: adamw(1e-2, weight_decay=0.1,
                                        clip_norm=0.05, wd_mask=WD_MASK),
    "adamw_clip_wd_mask_ema": lambda: adamw(1e-2, weight_decay=0.1,
                                            clip_norm=0.05, ema_decay=0.9,
                                            wd_mask=WD_MASK),
    "adamw_wd_no_clip": lambda: adamw(1e-2, weight_decay=0.1,
                                      clip_norm=None),
    "momentum_clip_ema": lambda: momentum(1e-2, clip_norm=0.05,
                                          ema_decay=0.9),
    "momentum": lambda: momentum(1e-2),
}
DTYPES = {"f32_f32": (torch.float32, torch.float32),
          "f32_bf16_wire": (torch.float32, torch.bfloat16),
          "bf16_bf16": (torch.bfloat16, torch.bfloat16)}


def _bucket_plan(wire: torch.dtype) -> buckets.BucketPlan:
    name = "float32" if wire == torch.float32 else "bfloat16"
    bs = []
    for idx in BUCKET_IDX:
        sizes = tuple(int(np.prod(SHAPES[NAMES[i]])) for i in idx)
        bs.append(buckets.Bucket(key=("allreduce", name, ()), idx=idx,
                                 sizes=sizes, nbytes=sum(sizes) * 2))
    return buckets.BucketPlan(
        buckets=bs, batch_axes=("data",), replicas=4,
        n_params=sum(len(b.idx) for b in bs),
        wire_bytes=sum(b.nbytes for b in bs), bucket_bytes=1 << 20)


def _params(dtype, seed=0) -> dict:
    gen = torch.Generator().manual_seed(seed)
    return {n: torch.nn.Parameter(torch.randn(s, generator=gen).to(dtype))
            for n, s in SHAPES.items()}


def _exchange(bp, step: int, dtype) -> tuple:
    """One step's post-all-reduce flat buffers and the per-parameter
    gradients the unfused step would hand the optimizer (sliced back from
    the same buffers; the table's arrives on its own)."""
    gen = torch.Generator().manual_seed(100 + step)
    local = {n: torch.randn(s, generator=gen).to(dtype)
             for n, s in SHAPES.items()}
    bufs, grads = [], {"table": local["table"]}
    for b in bp.buckets:
        members = [local[NAMES[i]] for i in b.idx]
        buf = buckets._flat_wire(b, members, 1.0)
        bufs.append(buf)
        for i, g in zip(b.idx, buckets._slice_back(b, buf, members)):
            grads[NAMES[i]] = g
    return bufs, {n: grads[n] for n in NAMES}


def _bits(t: torch.Tensor) -> np.ndarray:
    t = t.detach().contiguous()
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32
                  ).numpy()


def _state_bits(state) -> dict:
    return {f"{part}.{n}": _bits(t) for part in ("m", "v", "ema")
            for n, t in (getattr(state, part) or {}).items()}


@pytest.mark.parametrize("opt", list(OPTIMIZERS))
def test_fuse_then_unfuse_is_the_identity(opt):
    bp = _bucket_plan(torch.float32)
    state = OPTIMIZERS[opt]().init(_params(torch.float32))
    gen = torch.Generator().manual_seed(7)
    for part in ("m", "v", "ema"):
        for t in (getattr(state, part) or {}).values():
            t.copy_(torch.randn(t.shape, generator=gen))
    want = _state_bits(state)
    fused = fuse_state(state, bp)
    assert is_fused(fused)
    assert [tuple(b.shape) for b in fused.m["bucket"]] == \
        [(sum(b.sizes),) for b in bp.buckets]
    assert [n for n, t in fused.m["leaf"].items() if t is not None] == \
        ["table"]
    back = unfuse_state(fused, bp)
    assert not is_fused(back)
    got = _state_bits(back)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # the same plan fuses once: a fused state passes through unchanged
    assert fuse_state(fused, bp) is fused
    assert unfuse_state(back, bp) is back


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("opt", list(OPTIMIZERS))
def test_update_fused_is_bit_identical_to_update(opt, dt):
    pdt, wire = DTYPES[dt]
    bp = _bucket_plan(wire)
    o = OPTIMIZERS[opt]()
    per = o.init(_params(pdt))
    fused = fuse_state(o.init(_params(pdt)), bp)
    for step in range(3):
        bufs, grads = _exchange(bp, step, pdt)
        per, m1 = o.update(per, grads)
        fused, m2 = o.update_fused(fused, grads, bufs, bp)
        assert set(m1) == set(m2)
        if "grad_norm" in m1:
            assert _bits(m1["grad_norm"]) == _bits(m2["grad_norm"])
            assert float(m1["grad_norm"]) > 0.05     # clipping acts
    assert per.step == fused.step == 3
    for n in NAMES:
        np.testing.assert_array_equal(_bits(fused.params[n]),
                                      _bits(per.params[n]), err_msg=n)
    got, want = _state_bits(unfuse_state(fused, bp)), _state_bits(per)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_unfused_view_is_the_live_memory():
    """``unfuse_state`` hands out views of the flat buffers: what the
    runner's canonical state shows is what the next fused step reads."""
    bp = _bucket_plan(torch.float32)
    fused = fuse_state(adamw(1e-2).init(_params(torch.float32)), bp)
    view = unfuse_state(fused, bp)
    view.m["a"].fill_(3.0)
    k, off, sz = 1, 7, 15            # "a": bucket 1 after "b" (7 values)
    assert torch.all(fused.m["bucket"][k][off:off + sz] == 3.0)


# ---------------------------------------------------------------------------
# on a gloo (4, 1) mesh
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ranks():
    return spawn(R.fused_rank, 4, "gloo", timeout=600)


@pytest.mark.distributed
@pytest.mark.parametrize("case", list(R.FUSED_CASES))
def test_fused_apply_bit_exact_on_a_mesh(ranks, case):
    for r in ranks:
        f, p = r[f"{case}|True"], r[f"{case}|False"]
        assert f["fused_apply"] and f["live_fused"], case
        assert not p["fused_apply"] and not p["live_fused"], case
        # two tables on different methods, the LSTMs, the head, attn_mix
        # and the dense-routed table in the buckets
        assert f["methods"] == {"embed": "mpi_gatherv",
                                "enc_embed": "allreduce"}
        assert f["buckets"] >= 1
        assert f["loss"] == p["loss"], (case, f["loss"], p["loss"])
        assert list(f["params"]) == list(p["params"])
        for n in f["params"]:
            np.testing.assert_array_equal(f["params"][n], p["params"][n],
                                          err_msg=n)
        assert list(f["state"]) == list(p["state"])
        for k in f["state"]:
            np.testing.assert_array_equal(f["state"][k], p["state"][k],
                                          err_msg=k)
    # every rank applied the same update
    for r in ranks[1:]:
        for n, a in ranks[0][f"{case}|True"]["params"].items():
            np.testing.assert_array_equal(r[f"{case}|True"]["params"][n], a)


# ---------------------------------------------------------------------------
# the stamp
# ---------------------------------------------------------------------------

def _plan(mesh=(4, 1), **kw):
    cfg = R.nmt_cfg()
    ms = MeshShape(mesh, ("data", "model"))
    rt = Runtime(cfg, tc.RunConfig(**R.KW, **R.TWO_TABLE, **kw),
                 R.shape(), mesh=ms, device="cpu")
    return analyze(build_model(cfg, rt), rt)


@pytest.mark.parametrize("kw,mesh,want", [
    ({}, (4, 1), True),
    ({"optimizer": "momentum"}, (4, 1), True),
    ({"optimizer": "sgd"}, (4, 1), False),
    ({"zero_stage": 1}, (4, 1), False),
    ({"opau": False}, (4, 1), False),
    ({"fused_apply": False}, (4, 1), False),
    ({"bucket_bytes": 0}, (4, 1), False),          # no bucket plan
    ({}, (2, 2), False),                           # a model axis: none
], ids=["adamw", "momentum", "sgd", "zero1", "no_opau", "off",
        "no_buckets", "2x2"])
def test_plan_stamps_fused_apply_only_where_eligible(kw, mesh, want):
    plan = _plan(mesh, **kw)
    assert plan.fused_apply is want
    if plan.bucket_plan is None:
        assert not plan.fused_apply


def test_an_optimizer_without_a_fused_path_drops_the_stamp():
    """The reference's make_train_step drops ``fused_apply`` for sgd,
    whatever the plan says."""
    cfg = R.nmt_cfg()
    rt = Runtime(cfg, tc.RunConfig(**R.KW), R.shape(), device="cpu")
    model = build_model(cfg, rt)
    plan = analyze(model, rt)
    plan.fused_apply = True
    make_train_step(model, sgd(1e-2), rt, plan)
    assert plan.fused_apply is False
