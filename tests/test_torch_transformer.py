"""The port's dense transformer (models/transformer.py) against the JAX
package's, from the same parameters: reduced phi3-medium-14b (2 layers,
d 64, 4 q and 2 KV heads of 16, vocab 512) at f32. Prefill logits and the
collected K/V agree within rtol 1e-5 for every attention implementation
(the JAX side runs its Pallas kernel in interpret mode); decode steps with a
per-slot or a scalar cache length write the same cache rows — a slot whose
length is past the cache writes nowhere — and give the same logits."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import RunConfig, ShapeConfig, get_config, reduced
from repro.core.runtime import Runtime as JRuntime
from repro.core.transform import analyze as janalyze
from repro.models.model import build_model as jbuild
from repro.utils.tree import named_leaves
import repro_torch.configs as tc
from repro_torch.core.runtime import Runtime
from repro_torch.core.transform import analyze, load_params_
from repro_torch.models import transformer
from repro_torch.models.layers import init_tree
from repro_torch.models.model import build_model
from repro_torch.utils.tree import named_parameters
from repro_torch.weights import load_reference_params, to_numpy

F32 = dict(param_dtype="float32", compute_dtype="float32")
TOL = dict(rtol=1e-5, atol=1e-5)


def _pair(impl="naive", batch=2, seq=16, kw=F32):
    """(jax model, jax params, port model) with identical parameters."""
    shape = ShapeConfig("serve", seq, batch, "decode")
    jcfg = reduced(get_config("phi3-medium-14b"))
    jrt = JRuntime(jcfg, RunConfig(attention_impl=impl, **kw), shape)
    jm = jbuild(jcfg, jrt)
    jrt.plan = janalyze(jm, jrt)
    jp = jm.init(jax.random.key(0))
    named = {n: np.asarray(a) for n, a in named_leaves(jp)}
    tcfg = tc.reduced(tc.get_config("phi3-medium-14b"))
    trt = Runtime(tcfg, tc.RunConfig(attention_impl=impl, **kw),
                  tc.ShapeConfig("serve", seq, batch, "decode"),
                  device="cpu")
    tm = build_model(tcfg, trt)
    trt.plan = analyze(tm, trt)
    load_params_(tm, load_reference_params(named, "cpu"))
    return jm, jp, tm


def _tokens(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 512, size=shape) \
        .astype(np.int32)


def test_param_names_shapes_and_order_match_reference():
    """Stacked leaves under the reference's dotted names, in JAX's flatten
    order, for the spec tree and for a seeded init."""
    jm, jp, tm = _pair()
    want = [(n, tuple(a.shape)) for n, a in named_leaves(jp)]
    assert [(n, tuple(s.shape)) for n, s in tm.param_specs()] == want
    assert [(n, tuple(p.shape)) for n, p in named_parameters(tm).items()] \
        == want
    gen = torch.Generator().manual_seed(0)
    drawn = init_tree(gen, tm.specs(), torch.float32)
    assert [(n, tuple(t.shape)) for n, t in drawn.items()] == want
    assert "layers.attn.wq" in drawn and drawn["layers.attn.wq"].shape[0] == 2
    assert torch.equal(drawn["layers.ln1"], torch.ones(2, 64))


@pytest.mark.parametrize("impl", ["naive", "chunked", "pallas"])
def test_prefill_cache_fn_matches_reference(impl):
    jm, jp, tm = _pair(impl)
    toks = _tokens((2, 12))
    jl, jkv = jm.prefill_cache_fn(jp, jnp.asarray(toks))
    tl, tkv = tm.prefill_cache_fn(torch.from_numpy(toks))
    assert tuple(tl.shape) == (2, 12, 512)
    np.testing.assert_allclose(to_numpy(tl), np.asarray(jl), **TOL)
    for t, j in zip(tkv, jkv):
        assert tuple(t.shape) == (2, 2, 12, 2, 16)
        np.testing.assert_allclose(to_numpy(t), np.asarray(j), **TOL)


def test_prefill_fn_matches_reference():
    jm, jp, tm = _pair("chunked")
    toks = _tokens((2, 9), seed=1)
    jl, _, jmet = jm.prefill_fn(jp, {"tokens": jnp.asarray(toks)})
    tl, cache, tmet = tm.prefill_fn({"tokens": torch.from_numpy(toks)})
    assert cache is None
    np.testing.assert_allclose(to_numpy(tl), np.asarray(jl), **TOL)
    assert float(tmet["embed_rows"]) == float(jmet["embed_rows"])


def _random_cache(seed, batch, seq):
    rng = np.random.default_rng(seed)
    shape = (2, batch, seq, 2, 16)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for _ in range(2))


@pytest.mark.parametrize("lens", [[3, 15, 16], [0, 7, 40]])
def test_per_slot_decode_step_matches_reference(lens):
    """Each slot writes at its own length; a slot at len >= S writes
    nowhere (its rows keep their bits) and attends over the whole cache."""
    jm, jp, tm = _pair(batch=3)
    init = _random_cache(2, 3, 16)
    toks = _tokens((3, 1), seed=3)
    jl, jcache = jm.decode_fn(jp, tuple(jnp.asarray(c) for c in init),
                              jnp.asarray(toks), jnp.asarray(lens, jnp.int32))
    tcache = tuple(torch.from_numpy(c.copy()) for c in init)
    tl, out = tm.decode_fn(tcache, torch.from_numpy(toks),
                           torch.tensor(lens, dtype=torch.int32))
    assert out[0] is tcache[0] and out[1] is tcache[1]      # in place
    np.testing.assert_allclose(to_numpy(tl), np.asarray(jl), **TOL)
    for t, j, c in zip(tcache, jcache, init):
        np.testing.assert_allclose(to_numpy(t), np.asarray(j), **TOL)
        for b, n in enumerate(lens):
            keep = np.ones(16, bool)
            if n < 16:
                keep[n] = False
            np.testing.assert_array_equal(to_numpy(t)[:, b, keep],
                                          c[:, b, keep])


@pytest.mark.parametrize("cache_len,s", [(5, 1), (14, 3), (16, 1)])
def test_scalar_decode_matches_reference(cache_len, s):
    """The homogeneous-batch write, start clamped into [0, S - s] as
    dynamic_update_slice clamps it."""
    jm, jp, tm = _pair(batch=2)
    init = _random_cache(4, 2, 16)
    toks = _tokens((2, s), seed=5)
    jl, jcache = jm.decode_fn(jp, tuple(jnp.asarray(c) for c in init),
                              jnp.asarray(toks), jnp.int32(cache_len))
    tcache = tuple(torch.from_numpy(c.copy()) for c in init)
    tl, _ = tm.decode_fn(tcache, torch.from_numpy(toks), cache_len)
    np.testing.assert_allclose(to_numpy(tl), np.asarray(jl), **TOL)
    for t, j in zip(tcache, jcache):
        np.testing.assert_allclose(to_numpy(t), np.asarray(j), **TOL)


def test_prefill_then_decode_equals_teacher_forcing():
    """Prefill logits of a prompt equal those of feeding it one token at a
    time through the per-slot decode step (port only)."""
    _, _, tm = _pair(batch=1, seq=16)
    toks = _tokens((1, 7), seed=6)
    full, _ = tm.prefill_cache_fn(torch.from_numpy(toks))
    cache = tm.init_cache(1, 16)
    steps = []
    for i in range(7):
        lg, cache = tm.decode_fn(cache, torch.from_numpy(toks[:, i:i + 1]),
                                 torch.tensor([i], dtype=torch.int32))
        steps.append(lg[0, 0])
    np.testing.assert_allclose(to_numpy(torch.stack(steps)),
                               to_numpy(full[0]), **TOL)


def test_dense_training_and_other_families_are_refused():
    # the dense family trains (tests/test_torch_dense_train.py), but not
    # through the flash kernel, which is forward-only as the reference's
    _, _, tm = _pair(impl="pallas")
    with pytest.raises(NotImplementedError, match="pallas.*forward-only"):
        tm.loss_fn({"tokens": torch.zeros((2, 4), dtype=torch.int32),
                    "labels": torch.zeros((2, 4), dtype=torch.int32)})
    # hymba, chameleon and the moe family build now (tests/test_torch_
    # hybrid.py, test_torch_vlm.py, test_torch_moe.py): the moe layers hold
    # the routed experts in place of the MLP
    for arch in ("grok-1-314b", "llama4-maverick-400b-a17b"):
        cfg = tc.reduced(tc.get_config(arch))
        rt = Runtime(cfg, tc.RunConfig(), tc.ShapeConfig("s", 8, 2, "decode"),
                     device="cpu")
        names = {n for n, _ in build_model(cfg, rt).param_specs()}
        assert "layers.moe.w_gate" in names and "layers.mlp.w_gate" not in \
            names
        assert ("layers.moe.shared_gate" in names) == cfg.shared_expert


def test_cache_layout_matches_reference():
    jm, _, tm = _pair(batch=3)
    jc = jm.init_cache(3, 16)
    tcache = tm.init_cache(3, 16)
    assert [tuple(c.shape) for c in tcache] == [tuple(c.shape) for c in jc]
    assert all(c.dtype == torch.float32 and not c.any() for c in tcache)
    assert transformer.init_cache(tm.cfg, tm.rt, 2, 8, torch.bfloat16)[0] \
        .dtype == torch.bfloat16
