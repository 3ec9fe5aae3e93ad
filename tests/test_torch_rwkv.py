"""The port's rwkv6 (models/rwkv.py and the ssm path of
models/transformer.py) against the JAX package's, from the same parameters:
reduced rwkv6-7b (2 layers, d 64, 4 heads of 16, d_ff 128, vocab 512). The
time mix, channel mix and block, the full forward's logits and final carry,
decode steps and the serve-time plan agree within rtol 1e-5 at f32. At
bf16 the mixes and the block agree within rtol 2e-2 and 2e-2 of the
reference's max-abs scale (the bf16 bar of tests/test_torch_lstm.py: one
bf16 rounding of a residual of size ~3 is already 0.016); the whole
two-layer forward within 5e-2 so scaled, the reference's own bf16 bar for
WKV (tests/test_kernels.py): there rounding differences compound over
layers and tokens, and both packages' bf16 logits lie 0.07-0.08 from the
f32 forward with the same parameters, 0.02-0.03 from each other. The parameters that the seeded init leaves at zero (the token-shift
mixes, the decay LoRA's second factor, w0 and the bonus) are drawn from a
seed here, so the data-dependent decay and the bonus are exercised."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import RunConfig, ShapeConfig, get_config, reduced
from repro.core.runtime import Runtime as JRuntime
from repro.core.transform import analyze as janalyze
from repro.core.transform import make_prefill_step as jprefill_step
from repro.models import rwkv as jrwkv
from repro.models.model import build_model as jbuild
from repro.utils.tree import named_leaves
import repro_torch.configs as tc
from repro_torch.core.runtime import Runtime
from repro_torch.core.transform import (analyze, load_params_,
                                        make_decode_step, make_prefill_step)
from repro_torch.kernels import ops
from repro_torch.models import rwkv, transformer
from repro_torch.models.model import build_model
from repro_torch.utils.tree import named_parameters
from repro_torch.weights import load_reference_params, to_numpy, to_torch

F32 = dict(param_dtype="float32", compute_dtype="float32")
BF16 = dict(param_dtype="bfloat16", compute_dtype="bfloat16")
KW = {"float32": F32, "bfloat16": BF16}
TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
FORWARD_TOL = {"float32": TOL["float32"],
               "bfloat16": dict(rtol=5e-2, atol=5e-2)}
ZERO_INIT = ("tm.mu", "tm.w_lora_b", "tm.w0", "tm.bonus", "cm.mu")


def _named(jp, dtype):
    """The reference's parameters by dotted name, with the zero-initialized
    ones drawn from a seed (at the parameter dtype)."""
    rng = np.random.default_rng(1)
    out = {}
    for n, a in named_leaves(jp):
        a = np.asarray(a)
        if any(n.endswith(z) for z in ZERO_INIT):
            a = np.asarray(jnp.asarray(
                rng.standard_normal(a.shape).astype(np.float32) * 0.3)
                .astype(a.dtype))
        out[n] = a
    return out


def _pair(dtype="float32", batch=2, seq=16, kind="decode"):
    """(jax model, jax params, port model) with identical parameters."""
    kw = KW[dtype]
    jcfg = reduced(get_config("rwkv6-7b"))
    jrt = JRuntime(jcfg, RunConfig(**kw), ShapeConfig("s", seq, batch, kind))
    jm = jbuild(jcfg, jrt)
    jrt.plan = janalyze(jm, jrt)
    jp0 = jm.init(jax.random.key(0))
    named = _named(jp0, dtype)
    order = [n for n, _ in named_leaves(jp0)]
    jp = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(jp0),
                                      [jnp.asarray(named[n]) for n in order])
    tcfg = tc.reduced(tc.get_config("rwkv6-7b"))
    trt = Runtime(tcfg, tc.RunConfig(**kw), tc.ShapeConfig("s", seq, batch,
                                                           kind),
                  device="cpu")
    tm = build_model(tcfg, trt)
    trt.plan = analyze(tm, trt)
    load_params_(tm, load_reference_params(named, "cpu"))
    return jm, jp, tm


def _tokens(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 512, size=shape) \
        .astype(np.int32)


def _close(got, want, dtype, tols=TOL):
    want = np.asarray(want, np.float32)
    tol = dict(tols[dtype])
    if dtype == "bfloat16":
        tol["atol"] *= float(np.abs(want).max()) or 1.0
    np.testing.assert_allclose(to_numpy(got), want, **tol)


def _layer(jp, tm, i=0):
    """Layer i's parameters: the reference's nested dict and the port's."""
    jl = jax.tree.map(lambda a: a[i], jp["layers"])
    return jl, transformer._layer_params(tm.params(), i)


def _activations(dtype, b=2, s=40, d=64, seed=3):
    rng = np.random.default_rng(seed)
    jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    xs = [jnp.asarray(rng.standard_normal(sh).astype(np.float32)).astype(jd)
          for sh in ((b, s, d), (b, d), (b, d))]
    st = jnp.asarray(rng.standard_normal((b, 4, 16, 16)).astype(np.float32)
                     * 0.1)
    return xs, st


def test_param_names_shapes_and_order_match_reference():
    jm, jp, tm = _pair()
    want = [(n, tuple(a.shape)) for n, a in named_leaves(jp)]
    assert [(n, tuple(s.shape)) for n, s in tm.param_specs()] == want
    assert [(n, tuple(p.shape)) for n, p in named_parameters(tm).items()] \
        == want
    assert "layers.tm.w_lora_a" in dict(want)
    assert "layers.cm.w_recv" in dict(want) and "head" in dict(want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_time_and_channel_mix_match_reference(dtype):
    jm, jp, tm = _pair(dtype)
    jl, tl = _layer(jp, tm, 1)
    (x, x_prev, cm_prev), st = _activations(dtype)
    tx, tprev, tcm = (to_torch(np.asarray(a), "cpu") for a in (x, x_prev,
                                                                cm_prev))
    tst = to_torch(np.asarray(st), "cpu")
    cfg = tm.cfg
    jout, (jx, jst) = jrwkv.time_mix(jl["tm"], x, x_prev, st, cfg=jm.cfg,
                                     rt=jm.rt)
    tout, (tx_last, tst_new) = rwkv.time_mix(tl["tm"], tx, tprev, tst,
                                             cfg=cfg)
    assert tout.dtype == tx.dtype and tst_new.dtype == torch.float32
    _close(tout, jout, dtype)
    _close(tst_new, jst, dtype)
    assert torch.equal(tx_last, tx[:, -1])
    jout, jcm = jrwkv.channel_mix(jl["cm"], x, cm_prev, rt=jm.rt)
    tout, tcm_new = rwkv.channel_mix(tl["cm"], tx, tcm)
    _close(tout, jout, dtype)
    assert torch.equal(tcm_new, tx[:, -1])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block_matches_reference(dtype):
    jm, jp, tm = _pair(dtype)
    jl, tl = _layer(jp, tm, 0)
    (x, tm_x, cm_x), st = _activations(dtype, seed=5)
    carry = [to_torch(np.asarray(a), "cpu") for a in (tm_x, st, cm_x)]
    jx, jc = jrwkv.rwkv_block(jl, x, (tm_x, st, cm_x), cfg=jm.cfg, rt=jm.rt)
    tx, tcarry = rwkv.rwkv_block(tl, to_torch(np.asarray(x), "cpu"),
                                 tuple(carry), cfg=tm.cfg)
    _close(tx, jx, dtype)
    for t, j in zip(tcarry, jc):
        _close(t, j, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [1, 40, 70])
def test_forward_logits_and_final_carry_match_reference(dtype, s):
    """The prefill forward from a fresh carry (ragged final chunks at 40
    and 70 tokens, one token at 1): logits and every layer's final carry,
    through ``make_prefill_step`` on both sides."""
    jm, jp, tm = _pair(dtype, kind="prefill")
    toks = _tokens((2, s))
    jl, jc = jprefill_step(jm, jm.rt, jm.rt.plan)(
        jp, {"tokens": jnp.asarray(toks)})
    tl, tcache = make_prefill_step(tm, tm.rt, tm.rt.plan)(
        {"tokens": torch.from_numpy(toks)})
    assert tuple(tl.shape) == (2, s, 512)
    _close(tl, jl, dtype, FORWARD_TOL)
    assert len(tcache) == 3
    for t, j in zip(tcache, jc):
        assert tuple(t.shape) == tuple(j.shape)
        _close(t, j, dtype, FORWARD_TOL)


def test_decode_steps_match_reference():
    """Five decode steps from the cache: logits and the carry, written in
    place into the given tensors; ``cache_len`` is ignored."""
    jm, jp, tm = _pair()
    toks = _tokens((2, 5), seed=2)
    jcache = jm.init_cache(2, 16)
    tcache = tm.init_cache(2, 16)
    ids = [id(c) for c in tcache]
    step = make_decode_step(tm, tm.rt, tm.rt.plan)
    for i in range(5):
        jl, jcache = jm.decode_fn(jp, jcache, jnp.asarray(toks[:, i:i + 1]),
                                  jnp.asarray(i))
        tl, tcache = step(tcache, torch.from_numpy(toks[:, i:i + 1]), 7 * i)
        _close(tl, jl, "float32")
    assert [id(c) for c in tcache] == ids
    for t, j in zip(tcache, jcache):
        _close(t, j, "float32")


def test_chunked_prefill_equals_one_token_steps():
    """The chunked WKV over a 70-token prompt (two chunks of 32 and a ragged
    6) and 70 one-token decode steps compute one recurrence: the last
    logits and every layer's carry agree."""
    _, _, tm = _pair()
    toks = _tokens((1, 70), seed=4)
    logits, carry = make_prefill_step(tm, tm.rt, tm.rt.plan)(
        {"tokens": torch.from_numpy(toks)})
    cache = tm.init_cache(1, 16)
    step = make_decode_step(tm, tm.rt, tm.rt.plan)
    for i in range(70):
        last, cache = step(cache, torch.from_numpy(toks[:, i:i + 1]), i)
    torch.testing.assert_close(last[:, 0], logits[:, -1], rtol=1e-4,
                               atol=1e-4)
    for a, b in zip(carry, cache):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


def test_time_mix_goes_through_the_wkv_wrapper(monkeypatch):
    """The time mix hands its WKV to ``ops.wkv`` at chunk 32, once per layer
    and call, with f32 log-decay, bonus and state."""
    _, _, tm = _pair("bfloat16")
    calls = []
    real = ops.wkv

    def spy(r, k, v, lw, bonus, state, *, chunk):
        calls.append((r.dtype, lw.dtype, bonus.dtype, state.dtype, chunk,
                      tuple(r.shape)))
        return real(r, k, v, lw, bonus, state, chunk=chunk)

    monkeypatch.setattr(ops, "wkv", spy)
    tm.prefill_fn({"tokens": torch.from_numpy(_tokens((2, 9)))})
    assert calls == [(torch.bfloat16, torch.float32, torch.float32,
                      torch.float32, 32, (2, 9, 4, 16))] * 2


def test_carry_layout_matches_reference():
    jm, _, tm = _pair("bfloat16", batch=3)
    jc = jm.init_cache(3, 16)
    tcache = tm.init_cache(3, 16)
    assert [tuple(c.shape) for c in tcache] == [tuple(c.shape) for c in jc]
    assert [c.dtype for c in tcache] == [torch.bfloat16, torch.float32,
                                         torch.bfloat16]
    assert all(not c.any() for c in tcache)


def test_training_rwkv6_is_refused_and_prefill_cache_is_none():
    """rwkv6 has no bucketed prefill. Its training is no longer refused
    (ROADMAP slice 6 item 18): ``loss_fn`` runs through the chunked WKV
    under autograd, held against the reference in
    tests/test_torch_rwkv_train.py."""
    _, _, tm = _pair()
    assert tm.prefill_cache_fn is None
    loss, _ = tm.loss_fn({"tokens": torch.zeros((2, 4), dtype=torch.int32),
                          "labels": torch.zeros((2, 4), dtype=torch.int32)})
    assert torch.isfinite(loss) and loss.requires_grad


@pytest.mark.parametrize("shape", [("serve", 2048, 4, "decode"),
                                   ("prefill", 2048, 1, "prefill"),
                                   ("serve", 32, 2, "decode")])
def test_plan_tables_match_reference(shape):
    """``analyze()`` for rwkv6 at the serve shape and a prefill shape, full
    width and reduced: the same per-table plan, serve pricing included. The
    full-width port model lies on the meta device: planning reads only its
    specs, and nothing is allocated."""
    for red in (True, False):
        jcfg = get_config("rwkv6-7b")
        tcfg = tc.get_config("rwkv6-7b")
        if red:
            jcfg, tcfg = reduced(jcfg), tc.reduced(tcfg)
        jrt = JRuntime(jcfg, RunConfig(), ShapeConfig(*shape))
        want = janalyze(jbuild(jcfg, jrt), jrt).tables()
        trt = Runtime(tcfg, tc.RunConfig(), tc.ShapeConfig(*shape),
                      device="cpu" if red else "meta")
        got = analyze(build_model(tcfg, trt), trt).tables()
        assert got == want
