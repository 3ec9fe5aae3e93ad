"""The port's per-parameter optimizers against the JAX package's: adamw,
momentum and sgd, with clipping engaged and not, EMA on and off, over two
updates (bias correction moves). Agreement within 1e-6 at f32: the same
elementwise chain, evaluated by two libraries that may contract or round
one product differently."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import optimizer as jopt
from repro_torch.kernels import _build, ops
from repro_torch.kernels import ref as tref
from repro_torch.optim import optimizer as topt
from repro_torch.weights import load_reference_params, to_numpy

SHAPES = {"embed": (32, 8), "head": (32, 8), "layers.bias": (2, 16),
          "layers.w_x": (2, 8, 16)}


def _tree(flat: dict) -> dict:
    """{'a.b': x} -> {'a': {'b': x}} (the reference's pytree)."""
    out: dict = {}
    for name, v in flat.items():
        node = out
        *path, leaf = name.split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def _flat(tree: dict, prefix="") -> dict:
    out = {}
    for k in sorted(tree):
        v = tree[k]
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flat(v, name + "."))
        else:
            out[name] = v
    return out


def _draw(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {n: (rng.standard_normal(s) * scale).astype(np.float32)
            for n, s in SHAPES.items()}


def _make(kind, clip, ema):
    if kind == "adamw":
        return (jopt.adamw(1e-3, weight_decay=0.01, clip_norm=clip,
                           ema_decay=ema),
                topt.adamw(1e-3, weight_decay=0.01, clip_norm=clip,
                           ema_decay=ema))
    if kind == "momentum":
        return (jopt.momentum(1e-2, clip_norm=clip, ema_decay=ema),
                topt.momentum(1e-2, clip_norm=clip, ema_decay=ema))
    return jopt.sgd(1e-2, clip_norm=clip), topt.sgd(1e-2, clip_norm=clip)


CLIPS = {"noclip": None, "clip_engaged": 0.5, "clip_idle": 1e6}
CASES = [(kind, clip, ema) for kind in ("adamw", "momentum", "sgd")
         for clip in CLIPS
         for ema in ((0.0, 0.9) if kind != "sgd" else (0.0,))]


@pytest.mark.parametrize("kind,clip,ema", CASES, ids=str)
def test_update_matches_reference(kind, clip, ema):
    clip = CLIPS[clip]
    params = _draw(0)
    jo, to = _make(kind, clip, ema)
    jstate = jo.init(_tree({n: jnp.asarray(a) for n, a in params.items()}))
    tparams = {n: torch.nn.Parameter(t) for n, t in
               load_reference_params(params, "cpu").items()}
    tstate = to.init(tparams)
    for step in range(2):
        grads = _draw(10 + step, scale=0.3)
        jstate, jm = jo.update(
            jstate, _tree({n: jnp.asarray(a) for n, a in grads.items()}))
        tstate, tm = to.update(tstate,
                               load_reference_params(grads, "cpu"))
        assert tstate.step == int(jstate.step)
        if clip is not None:
            np.testing.assert_allclose(float(tm["grad_norm"]),
                                       float(jm["grad_norm"]), rtol=1e-6)
        for field in ("params", "m", "v", "ema"):
            want = getattr(jstate, field)
            got = getattr(tstate, field)
            if want is None:
                assert got is None, field
                continue
            for n, a in _flat(want).items():
                np.testing.assert_allclose(to_numpy(got[n]), np.asarray(a),
                                           rtol=1e-6, atol=1e-6,
                                           err_msg=f"{field}:{n}")


def test_clip_order_and_norm_match_reference():
    """The global norm sums per-parameter partials in flatten order."""
    grads = _draw(3)
    want = jopt.global_norm(_tree({n: jnp.asarray(a)
                                   for n, a in grads.items()}))
    got = topt.global_norm(load_reference_params(grads, "cpu"))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-7)
    clipped, norm = topt.clip_by_global_norm(
        load_reference_params(grads, "cpu"), 1.0)
    jclipped, jnorm = jopt.clip_by_global_norm(
        _tree({n: jnp.asarray(a) for n, a in grads.items()}), 1.0)
    for n, a in _flat(jclipped).items():
        np.testing.assert_allclose(to_numpy(clipped[n]), np.asarray(a),
                                   rtol=1e-6, atol=1e-7)


def test_bf16_params_keep_dtype_in_place():
    """Updates overwrite the parameters they are given, in their dtype."""
    p = torch.nn.Parameter(torch.ones((4, 4), dtype=torch.bfloat16))
    opt = topt.adamw(1e-2)
    state = opt.init({"w": p})
    before = p.data_ptr()
    state, _ = opt.update(state, {"w": torch.full((4, 4), 0.5,
                                                  dtype=torch.bfloat16)})
    assert p.data_ptr() == before and p.dtype == torch.bfloat16
    assert float(p.detach()[0, 0]) < 1.0 and state.step == 1


# ---------------------------------------------------------------------------
# the AdamW step and the clip's partial norm as kernels/ops.py wraps them
# (csrc/adamw.cu on the card, kernels/ref.py here)
# ---------------------------------------------------------------------------

B1, B2, EPS, LR = 0.9, 0.95, 1e-8, 1e-3
PAIRS = {"bf16_bf16": (torch.bfloat16, torch.bfloat16),
         "bf16_f32": (torch.bfloat16, torch.float32),
         "f32_bf16": (torch.float32, torch.bfloat16),
         "f32_f32": (torch.float32, torch.float32)}
ODD_SHAPES = {"n1": (1,), "n7": (7,), "n1001": (1001,), "3x5x7": (3, 5, 7)}
WDS = {"no_decay": None, "masked_0": 0.0, "wd_0.01": 0.01}


def _corrections(step: int) -> tuple:
    """adamw's f32 bias corrections of ``step``, as Python floats."""
    t = torch.tensor(step, dtype=torch.float32)
    f32 = lambda x: torch.tensor(x, dtype=torch.float32)
    return (float(1.0 - f32(B1) ** t), float(1.0 - f32(B2) ** t))


def _eager_chain_(p, g, m, v, *, scale, bc1, bc2, wd, path):
    """The optimizer's chain as it stood before the wrappers, verbatim:
    ``update`` (``_clipped``, then ``moments_`` and ``write_`` on
    ``gt.float()``) or ``update_fused`` (the wire buffer cast to the
    parameter's dtype, then clipped there: ``_fused_grads``' ``g32``)."""
    if path == "per_leaf":
        gt = g if scale is None else (g.float() * scale).to(g.dtype)
        g32 = gt.float()
    else:
        g32 = g.to(p.dtype).float()
        if scale is not None:
            g32 = (g32 * scale).to(p.dtype).float()
    m.mul_(B1).add_(g32 * (1 - B1))
    v.mul_(B2).add_(torch.square(g32).mul_(1 - B2))
    upd32 = (m / bc1).div_(torch.sqrt(v / bc2).add_(EPS))
    if wd is not None:
        upd32 = upd32 + wd * p.float()
    p.copy_((p.float() - LR * upd32).to(p.dtype))


def _raw(t: torch.Tensor) -> np.ndarray:
    t = t.detach().contiguous()
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32
                  ).numpy()


@pytest.mark.parametrize("path", ["per_leaf", "fused"])
@pytest.mark.parametrize("clip", ["noclip", "clip"])
@pytest.mark.parametrize("wd", list(WDS))
@pytest.mark.parametrize("shape", list(ODD_SHAPES))
@pytest.mark.parametrize("pair", list(PAIRS))
def test_adamw_update_plain_equals_the_eager_chain(pair, shape, wd, clip,
                                                   path):
    """``ops.adamw_update_`` on CPU tensors takes ``adamw_update_ref``,
    which equals the eager chain bit for bit over 3 steps (p, m, v), and
    launches nothing."""
    pdt, gdt = PAIRS[pair]
    shape, wd = ODD_SHAPES[shape], WDS[wd]
    gen = torch.Generator().manual_seed(5)
    p0 = torch.randn(shape, generator=gen).to(pdt)
    mine = [p0.clone(), torch.zeros(shape), torch.zeros(shape)]
    want = [p0.clone(), torch.zeros(shape), torch.zeros(shape)]
    ops.reset_launch_counts()
    for step in range(1, 4):
        g = (torch.randn(shape, generator=gen) * 3.0).to(gdt)
        scale = torch.tensor(0.37) if clip == "clip" else None
        bc1, bc2 = _corrections(step)
        _eager_chain_(*want[:1], g, *want[1:], scale=scale, bc1=bc1,
                      bc2=bc2, wd=wd, path=path)
        ops.adamw_update_(mine[0], g, mine[1], mine[2], scale=scale,
                          bc1=bc1, bc2=bc2, lr=LR, wd=wd, b1=B1, b2=B2,
                          eps=EPS,
                          gdt=pdt if path == "fused" else None)
        for name, a, b in zip("pmv", mine, want):
            np.testing.assert_array_equal(_raw(a), _raw(b),
                                          err_msg=f"step {step}: {name}")
    assert ops.launch_counts()["adamw_update_"] == 0


@pytest.mark.parametrize("shape", list(ODD_SHAPES) + ["2x800"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_grad_sq_norm_plain_is_the_eager_sum(dtype, shape):
    """``ops.grad_sq_norm`` on a CPU tensor is ``global_norm``'s former
    partial, ``torch.sum(torch.square(g.float()))``, bit for bit, 0-d f32,
    with no launch."""
    shape = ODD_SHAPES.get(shape, (2, 800))
    g = torch.randn(shape, generator=torch.Generator().manual_seed(1)).to(
        getattr(torch, dtype))
    ops.reset_launch_counts()
    got = ops.grad_sq_norm(g)
    want = torch.sum(torch.square(g.float()))
    assert got.dtype == torch.float32 and got.dim() == 0
    assert _raw(got) == _raw(want)
    assert ops.launch_counts()["grad_sq_norm"] == 0


def test_adamw_update_meta_route_computes_nothing(monkeypatch):
    """On meta tensors (the dry-run's step) neither the kernel nor the
    plain version runs: the update writes nothing, the norm is an empty
    0-d meta tensor, and both calls are counted."""
    def boom(*a, **k):
        raise AssertionError("a meta call reached a kernel or its plain "
                             "version")
    monkeypatch.setattr(tref, "adamw_update_ref", boom)
    monkeypatch.setattr(tref, "grad_sq_norm_ref", boom)
    monkeypatch.setattr(_build, "load", boom)
    t = torch.empty((4, 3), device="meta", dtype=torch.bfloat16)
    m = torch.empty((4, 3), device="meta")
    with ops.meta_flops() as count:
        norm = ops.grad_sq_norm(t)
        ops.adamw_update_(t, t, m, m.clone(), scale=None, bc1=0.1, bc2=0.05,
                          lr=LR, wd=None, b1=B1, b2=B2, eps=EPS)
    assert norm.device.type == "meta" and norm.dim() == 0
    assert norm.dtype == torch.float32
    assert count == {"flops": 0, "calls": {"grad_sq_norm": 1,
                                           "adamw_update_": 1}}


@pytest.mark.parametrize("bad", ["m_dtype", "shape", "p_dtype",
                                 "scale_shape", "scale_dtype"])
def test_adamw_update_refuses_what_the_kernel_does_not_take(bad):
    p, g = torch.zeros((4, 3), dtype=torch.bfloat16), torch.zeros((4, 3))
    m, v, scale = torch.zeros((4, 3)), torch.zeros((4, 3)), None
    if bad == "m_dtype":
        m = m.to(torch.bfloat16)
    elif bad == "shape":
        v = torch.zeros((3, 4))
    elif bad == "p_dtype":
        p = p.half()
    elif bad == "scale_shape":
        scale = torch.ones((1,))
    else:
        scale = torch.ones((), dtype=torch.float64)
    with pytest.raises(ValueError):
        ops.adamw_update_(p, g, m, v, scale=scale, bc1=0.1, bc2=0.05, lr=LR,
                          wd=None, b1=B1, b2=B2, eps=EPS)


def test_adamw_update_takes_the_wrappers_on_cpu(monkeypatch):
    """The optimizer's every leaf goes through ``ops.grad_sq_norm`` and
    ``ops.adamw_update_``: on the CPU that is the plain chain, and no
    launch is counted."""
    calls = {"norm": 0, "update": 0}
    norm, upd = ops.grad_sq_norm, ops.adamw_update_

    def count_norm(*a, **k):
        calls["norm"] += 1
        return norm(*a, **k)

    def count_update(*a, **k):
        calls["update"] += 1
        return upd(*a, **k)
    monkeypatch.setattr(ops, "grad_sq_norm", count_norm)
    monkeypatch.setattr(ops, "adamw_update_", count_update)
    ops.reset_launch_counts()
    params = {n: torch.nn.Parameter(t) for n, t in
              load_reference_params(_draw(0), "cpu").items()}
    opt = topt.adamw(1e-3, weight_decay=0.01, clip_norm=0.5)
    state = opt.init(params)
    for step in range(2):
        state, _ = opt.update(state, load_reference_params(
            _draw(10 + step, scale=0.3), "cpu"))
    assert calls == {"norm": 2 * len(SHAPES), "update": 2 * len(SHAPES)}
    counts = ops.launch_counts()
    assert counts["adamw_update_"] == counts["grad_sq_norm"] == 0
