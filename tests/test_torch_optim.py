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
