"""The port's ``models/moe.py`` against the JAX package's, at f32 on one
device, from the same parameters (the JAX package's seeded init, carried
through numpy): the counterpart of tests/test_moe.py.

  * The reference's three cases: identical experts equal the plain FFN;
    no drops at ample capacity; drops reported at capacity factor 0.3.
  * ``moe_ffn`` over top-1 and top-2, with and without llama4's shared
    expert, at a capacity that drops and at one that does not, and with
    ``group_tokens`` small enough that the last group is padded with zero
    rows: the output within rtol 1e-5 (atol 1e-5 of its scale), the
    gradient of every parameter and of x within rtol 1e-4 (atol 5e-5 of
    its scale, ``GRAD_ATOL``), ``moe_aux`` within 1e-6, ``moe_dropped``
    equal.
  * The padding rows' router logits tie exactly; ``torch.topk`` breaks
    the tie elsewhere than ``jax.lax.top_k`` and so changes the aux and the
    drops: the port's stable descending sort is needed.
  * The model: reduced grok-1 and llama4-maverick (``layers.moe.*`` under
    the reference's names), loss, every gradient and the summed
    ``moe_aux`` / ``moe_dropped`` within the same bars, under each remat
    (the recompute routes the same tokens to the same slots).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_families as F
from repro.configs import RunConfig, ShapeConfig, get_config, reduced
from repro.core.runtime import Runtime as JRuntime
from repro.models import moe as jmoe
from repro.models.layers import init_tree
from repro.utils.tree import named_leaves
import repro_torch.configs as tc
from repro_torch.core.runtime import Runtime
from repro_torch.models import moe
from repro_torch.weights import to_numpy

GROK, LLAMA4 = "grok-1-314b", "llama4-maverick-400b-a17b"
KW = dict(attention_impl="naive", remat="none", compute_dtype="float32",
          param_dtype="float32", wire_dtype="float32")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    yield from F.one_thread()


def _cfgs(arch=GROK, e=4, k=2, cf=8.0, d=16, f=32):
    jc = reduced(get_config(arch), d_model=d, d_ff=f, experts=e)
    jc = type(jc)(**{**jc.__dict__, "experts_per_token": k,
                     "moe_capacity_factor": cf})
    c = dataclasses.replace(
        tc.reduced(tc.get_config(arch), d_model=d, d_ff=f, experts=e),
        experts_per_token=k, moe_capacity_factor=cf)
    return jc, c


def _setup(arch=GROK, e=4, k=2, cf=8.0, b=2, s=8, seed=1):
    """The JAX package's layer (its seeded init) and x, and the port's
    runtime."""
    jc, c = _cfgs(arch, e, k, cf)
    jrt = JRuntime(jc, RunConfig(**KW), ShapeConfig("t", s, b, "train"))
    params = init_tree(jax.random.key(0), jmoe.moe_specs(jc, "tp"),
                       jnp.float32)
    x = jax.random.normal(jax.random.key(seed), (b, s, jc.d_model),
                          jnp.float32)
    rt = Runtime(c, tc.RunConfig(**KW), tc.ShapeConfig("t", s, b, "train"),
                 device="cpu")
    return jc, jrt, params, x, c, rt


def _port(params, x, c, rt, **kw):
    p = {n: torch.tensor(np.asarray(a), requires_grad=True)
         for n, a in params.items()}
    xt = torch.tensor(np.asarray(x), requires_grad=True)
    out, met = moe.moe_ffn(p, xt, cfg=c, rt=rt, exec_mode="tp", **kw)
    return p, xt, out, met


def _close(got, want, rtol, what, atol=1e-5):
    """Within ``rtol`` and ``atol`` of ``want``'s max-abs scale."""
    want = np.asarray(want)
    scale = float(np.abs(want).max()) or 1.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol * scale,
                               err_msg=what)


# ---------------------------------------------------------------------------
# tests/test_moe.py's three cases
# ---------------------------------------------------------------------------

def test_identical_experts_equal_plain_ffn():
    """Every expert's weights the same: routing cannot matter (capacity
    permitting), MoE(x) == FFN(x)."""
    jc, jrt, params, x, c, rt = _setup(k=2, cf=8.0)
    for key in ("w_gate", "w_up", "w_down"):
        params[key] = jnp.broadcast_to(params[key][0:1], params[key].shape)
    _, _, out, met = _port(params, x, c, rt)
    want = jax.nn.silu(x @ params["w_gate"][0]) * (x @ params["w_up"][0])
    want = want @ params["w_down"][0]
    assert int(met["moe_dropped"]) == 0
    np.testing.assert_allclose(to_numpy(out), np.asarray(want), rtol=1e-4,
                               atol=1e-5)


def test_no_drops_with_ample_capacity():
    jc, jrt, params, x, c, rt = _setup(k=2, cf=16.0, seed=2)
    _, _, _, met = _port(params, x, c, rt)
    assert int(met["moe_dropped"]) == 0


def test_tiny_capacity_drops_and_reports():
    jc, jrt, params, x, c, rt = _setup(k=1, cf=0.3, seed=3)
    _, _, out, met = _port(params, x, c, rt)
    _, jmet = jmoe.moe_ffn(params, x, cfg=jc, rt=jrt, exec_mode="tp")
    assert int(met["moe_dropped"]) > 0
    assert int(met["moe_dropped"]) == int(jmet["moe_dropped"])
    assert bool(torch.isfinite(out).all())


# ---------------------------------------------------------------------------
# moe_ffn against the JAX package's, values and gradients
# ---------------------------------------------------------------------------

# name -> (arch, k, capacity factor, group_tokens, seq); batch 2, 4 experts
CASES = {
    "top2": (GROK, 2, 8.0, 8192, 8),
    "top1-shared": (LLAMA4, 1, 1.25, 8192, 8),
    "top2-drops": (GROK, 2, 0.3, 8192, 8),
    "top1-shared-drops": (LLAMA4, 1, 0.5, 8192, 10),
    # 40 tokens in groups of 24: the second group is padded with 8 zero
    # rows, whose router logits tie exactly
    "top2-padded-groups": (GROK, 2, 1.0, 24, 20),
    "top1-shared-padded-groups": (LLAMA4, 1, 1.25, 16, 20),
}


# at top-1 the router learns through the aux alone: its gradient is small
# and summed over every token, and the JAX package's own f32 gradient lies
# 2.2e-5 of its scale from a float64 evaluation of the same function
GRAD_ATOL = 5e-5


def _reference(params, x, jc, jrt, w, group_tokens):
    def f(p, xx):
        out, met = jmoe.moe_ffn(p, xx, cfg=jc, rt=jrt, exec_mode="tp",
                                group_tokens=group_tokens)
        return jnp.sum(out * w) + met["moe_aux"], (out, met)
    (_, (out, met)), (gp, gx) = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True))(params, x)
    return out, met, gp, gx


@pytest.mark.parametrize("name", list(CASES))
def test_moe_ffn_matches_reference(name):
    arch, k, cf, gt, s = CASES[name]
    jc, jrt, params, x, c, rt = _setup(arch, 4, k, cf, s=s)
    assert ("shared_gate" in params) == (arch == LLAMA4)
    w = np.random.default_rng(0).standard_normal(x.shape).astype(np.float32)
    jout, jmet, jgp, jgx = _reference(params, x, jc, jrt, jnp.asarray(w), gt)
    p, xt, out, met = _port(params, x, c, rt, group_tokens=gt)
    ((out * torch.from_numpy(w)).sum() + met["moe_aux"]).backward()
    _close(to_numpy(out), jout, 1e-5, "output")
    assert abs(float(met["moe_aux"]) - float(jmet["moe_aux"])) < 1e-6
    assert int(met["moe_dropped"]) == int(jmet["moe_dropped"])
    if "drops" in name:
        assert int(met["moe_dropped"]) > 0
    _close(to_numpy(xt.grad), jgx, 1e-4, "x grad", GRAD_ATOL)
    for n, g in jgp.items():
        _close(to_numpy(p[n].grad), g, 1e-4, f"{n} grad", GRAD_ATOL)


@pytest.mark.parametrize("name", [n for n in CASES if "padded" in n])
def test_padding_ties_need_the_lower_index_first(name, monkeypatch):
    """With ``torch.topk`` in place of the stable sort the zero padding
    rows pick other experts than ``jax.lax.top_k`` does: the aux (top-1
    fractions) and the drops leave the reference's."""
    arch, k, cf, gt, s = CASES[name]
    jc, jrt, params, x, c, rt = _setup(arch, 4, k, cf, s=s)
    _, jmet = jmoe.moe_ffn(params, x, cfg=jc, rt=jrt, exec_mode="tp",
                           group_tokens=gt)
    ties = torch.full((3, 4), 0.25)
    assert moe.top_k(ties, 2)[1].tolist() == [[0, 1]] * 3
    assert torch.topk(ties, 2).indices.tolist() != [[0, 1]] * 3
    monkeypatch.setattr(moe, "top_k", lambda p, kk: torch.topk(p, kk))
    with torch.no_grad():
        _, _, _, met = _port(params, x, c, rt, group_tokens=gt)
    assert (abs(float(met["moe_aux"]) - float(jmet["moe_aux"])) > 1e-4
            or int(met["moe_dropped"]) != int(jmet["moe_dropped"]))


def test_dispatch_indices_match_reference():
    """The sort-based dispatch bit for bit: each slot's destination row and
    the dropped count, over expert ids with many collisions."""
    rng = np.random.default_rng(4)
    eids = rng.integers(0, 4, (37, 2)).astype(np.int32)
    for cap in (3, 7, 40):
        jdest, jdrop = jmoe._dispatch_indices(jnp.asarray(eids), None, 4, cap)
        dest, drop = moe._dispatch_indices(torch.from_numpy(eids).long(), 4,
                                           cap)
        np.testing.assert_array_equal(dest.numpy(), np.asarray(jdest))
        assert int(drop) == int(jdrop)


def test_pick_exec_mode_matches_reference():
    """One device: tp; an explicit moe_exec is taken as given."""
    for mode in ("auto", "ep", "tp"):
        jc, c = _cfgs()
        jrt = JRuntime(jc, RunConfig(**KW, moe_exec=mode),
                       ShapeConfig("t", 8, 2, "train"))
        rt = Runtime(c, tc.RunConfig(**KW, moe_exec=mode),
                     tc.ShapeConfig("t", 8, 2, "train"), device="cpu")
        assert moe.pick_exec_mode(c, rt) == jmoe.pick_exec_mode(jc, jrt)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _model_reference(arch: str) -> tuple:
    """The JAX package's loss, metrics and gradients of reduced ``arch``
    at f32 on one batch, and the port's model holding the same
    parameters."""
    jm, jp, tm, _ = F.pair(arch)
    batch = F.dataset(reduced(get_config(arch))).batch(0)
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        jm.loss_fn, has_aux=True))(jp, {k: jnp.asarray(v)
                                        for k, v in batch.items()})
    return tm, batch, float(jloss), jmet, dict(named_leaves(jgrads))


@pytest.mark.parametrize("arch", [GROK, LLAMA4])
@pytest.mark.parametrize("remat", ["none", "block", "full"])
def test_model_loss_and_gradients_match_reference(arch, remat):
    """Reduced grok-1 (top-2) and llama4-maverick (top-1 and the shared
    expert), f32, the reference under no remat, the port under each."""
    tm, batch, jloss, jmet, jgrads = _model_reference(arch)
    tm.rt.run_cfg = dataclasses.replace(tm.rt.run_cfg, remat=remat)
    loss, met, grads = F.loss_and_grads(tm, F.tensors(batch))
    assert list(grads) == list(jgrads)
    np.testing.assert_allclose(float(loss), jloss, rtol=1e-5)
    np.testing.assert_allclose(float(met["xent"]), float(jmet["xent"]),
                               rtol=1e-5)
    assert abs(float(met["moe_aux"]) - float(jmet["moe_aux"])) < 1e-6
    assert int(met["moe_dropped"]) == int(jmet["moe_dropped"])
    for n, g in jgrads.items():
        _close(to_numpy(grads[n]), g, 1e-4, n, GRAD_ATOL)


# ---------------------------------------------------------------------------
# the init: each leaf drawn into its parameter, large ones in slices
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["phi3-medium-14b", GROK, LLAMA4,
                                  "parallax-lm", "rwkv6-7b"])
def test_init_draws_the_old_values_into_the_parameters(arch):
    """``init_params_`` draws straight into the model's parameters; every
    leaf under ``INIT_DRAW_BYTES`` (all of them at the reduced size) holds
    the values of the old whole draw (``init_tree``, one leaf after another
    from the same generator) bit for bit, in f32 and in bf16, and
    ``fresh_state`` draws the same values."""
    from repro_torch.core.transform import _draw_params, init_params_
    from repro_torch.models.layers import init_tree
    from repro_torch.models.model import build_model
    for dtype in ("float32", "bfloat16"):
        cfg = tc.reduced(tc.get_config(arch))
        rt = Runtime(cfg, tc.RunConfig(param_dtype=dtype),
                     tc.ShapeConfig("t", 8, 2, "train"), device="cpu")
        model = build_model(cfg, rt)
        init_params_(model, 7)
        gen = torch.Generator().manual_seed(7)
        old = init_tree(gen, model.specs(), rt.param_dtype)
        own = F.named_parameters(model)
        fresh = _draw_params(model, 7)
        assert list(own) == list(old) == list(fresh)
        for n, t in old.items():
            assert torch.equal(own[n], t) and torch.equal(fresh[n], t), n


def test_only_the_moe_experts_are_drawn_in_slices(monkeypatch):
    """At the published widths the card runs (the serve paths whole or at
    their stated cuts, the training cells), only grok-1's and
    llama4-maverick's expert leaves pass the budget; a sliced leaf is
    drawn one layer (then one expert) at a time, finite and at its
    spec's scale, the same from the same seed."""
    from repro_torch.core import transform
    from repro_torch.core.transform import INIT_DRAW_BYTES, init_params_
    from repro_torch.launch.profile_serve import SERVE_LAYERS, serve_config
    from repro_torch.launch.profile_step import CELLS, cell_config
    from repro_torch.models.model import build_model
    paths = {a: serve_config(a) for a in ("phi3-medium-14b",
                                          "stablelm-12b", "rwkv6-7b",
                                          *SERVE_LAYERS)}
    paths.update({f"{a}/train": cell_config(a) for a in CELLS})
    for name, cfg in paths.items():
        rt = Runtime(cfg, tc.RunConfig(), tc.ShapeConfig("t", 8, 2, "decode"),
                     device="meta")
        big = [n for n, s in build_model(cfg, rt).param_specs()
               if np.prod(s.shape) * 4 > INIT_DRAW_BYTES]
        want = ([f"layers.moe.{w}" for w in ("w_down", "w_gate", "w_up")]
                if cfg.family == "moe" else [])
        assert big == want, (name, big)
    # a sliced draw at the reduced size: a budget below one layer's leaf
    cfg = tc.reduced(tc.get_config(GROK))
    rt = Runtime(cfg, tc.RunConfig(param_dtype="float32"),
                 tc.ShapeConfig("t", 8, 2, "train"), device="cpu")
    a, b = build_model(cfg, rt), build_model(cfg, rt)
    monkeypatch.setattr(transform, "INIT_DRAW_BYTES", 4096)
    init_params_(a, 3)
    init_params_(b, 3)
    w = F.named_parameters(a)["layers.moe.w_gate"].detach()
    assert torch.equal(w, F.named_parameters(b)["layers.moe.w_gate"])
    std = float(w.std())
    assert bool(torch.isfinite(w).all())
    assert abs(std - 1 / np.sqrt(cfg.d_model)) < 0.1 / np.sqrt(cfg.d_model)
