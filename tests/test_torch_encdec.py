"""The port's encoder-decoder (models/encdec.py, seamless-m4t-medium, family
``audio``) against the JAX package's, from the same parameters: reduced
seamless (2 encoder + 2 decoder layers, d 64, vocab 512) at f32, batches
with stub ``frames`` (B, S // 4, d).

  * the parameter names, shapes and flatten order; ``input_specs`` and the
    4-tuple cache layout;
  * ``loss_fn``: the loss and every gradient within rtol 1e-5 (atol 1e-6
    for entries near zero), under naive and chunked attention;
  * ``prefill_fn``: logits under naive attention and under ``pallas``
    (the reference's Pallas kernel in interpret mode; the port's flash
    wrapper, whose CPU path is its plain version): the encoder and the
    cross attention are non-causal with Sq != Sk;
  * ``decode_fn`` through the 4-tuple cache, its cross K/V filled from an
    encoder output: logits and the self K/V written in place;
  * ``ToyServer`` greedy tokens (the loop this family serves through; its
    cross K/V stay zero, as the reference's do);
  * a 3-step trajectory through ``get_runner`` within rtol 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_families as F
from repro.configs import RunConfig, ShapeConfig, get_config, reduced
from repro.core.transform import get_runner as jget_runner
from repro.models import encdec as jencdec
from repro.utils.tree import named_leaves
import repro_torch.configs as tc
from repro_torch.core.transform import get_runner
from repro_torch.models import encdec
from repro_torch.utils.tree import named_parameters
from repro_torch.weights import load_reference_params, to_numpy

ARCH = "seamless-m4t-medium"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    yield from F.one_thread()


def _batch(seq=F.SEQ, batch=F.BATCH, seed=1):
    return F.dataset(reduced(get_config(ARCH)), seq, batch, seed).batch(0)


def test_specs_inputs_and_cache_layout_match_reference():
    jm, jp, tm, _ = F.pair(ARCH)
    assert [(n, tuple(p.shape)) for n, p in
            named_parameters(tm).items()] == \
        [(n, tuple(a.shape)) for n, a in named_leaves(jp)]
    assert [n for n, s in tm.param_specs() if s.sparse] == ["embed"]
    specs = tm.input_specs()
    want = jm.input_specs()
    assert sorted(specs) == sorted(want) == ["frames", "labels", "tokens"]
    for k, (shape, _) in specs.items():
        assert tuple(shape) == tuple(want[k].shape), k
    assert tm.prefill_cache_fn is None
    jc, tcache = jm.init_cache(3, 16), tm.init_cache(3, 16)
    assert [tuple(c.shape) for c in tcache] == [tuple(c.shape) for c in jc]
    assert tcache[2].shape[2] == 16 // encdec.enc_ratio(tm.cfg) == 4
    assert all(not c.any() for c in tcache)


@pytest.mark.parametrize("impl", ["naive", "chunked"])
def test_loss_and_gradients_match_reference(impl):
    kw = dict(F.F32, attention_impl=impl, attention_chunk=8)
    jm, jp, tm, _ = F.pair(ARCH, kw)
    F.check_loss_and_grads(jm, jp, tm, _batch())


@pytest.mark.parametrize("impl", ["naive", "pallas"])
def test_prefill_logits_match_reference(impl):
    kw = dict(F.F32, attention_impl=impl)
    jm, jp, tm, _ = F.pair(ARCH, kw, kind="prefill")
    batch = {k: v for k, v in _batch().items() if k != "labels"}
    jl, _, _ = jm.prefill_fn(jp, {k: jnp.asarray(v) for k, v in
                                  batch.items()})
    tl, cache, _ = tm.prefill_fn(F.tensors(batch))
    assert cache is None and tuple(tl.shape) == tuple(jl.shape)
    np.testing.assert_allclose(to_numpy(tl), np.asarray(jl), rtol=1e-5,
                               atol=1e-5)


def test_decode_steps_through_the_cache_match_reference():
    """Four decode steps from a cache whose cross K/V hold an encoder
    output's projections (per layer): logits every step, and the self
    K/V rows written in place into the given tensors."""
    jm, jp, tm, _ = F.pair(ARCH, kind="decode")
    frames = _batch(seed=2)["frames"][:2]                  # (2, 8, d)
    jenc = jencdec.encode(jp, jnp.asarray(frames), cfg=jm.cfg, rt=jm.rt)
    jc = list(jm.init_cache(2, 32))
    for i in range(jm.cfg.n_layers):
        p = jax.tree.map(lambda a: a[i], jp["dec_layers"])["cross"]
        k, v = jencdec._cross_kv(p, jenc, jm.cfg, jm.rt)
        jc[2] = jc[2].at[i].set(k.astype(jc[2].dtype))
        jc[3] = jc[3].at[i].set(v.astype(jc[3].dtype))
    jc = tuple(jc)
    tcache = tm.init_cache(2, 32)
    for t, j in zip(tcache, jc):
        t.copy_(torch.from_numpy(np.array(j)))
    ids = [id(c) for c in tcache]
    toks = np.random.default_rng(3).integers(0, 512, (2, 4)).astype(np.int32)
    for i in range(4):
        jl, jc = jm.decode_fn(jp, jc, jnp.asarray(toks[:, i:i + 1]),
                              jnp.asarray(i, jnp.int32))
        tl, tcache = tm.decode_fn(tcache, torch.from_numpy(toks[:, i:i + 1]),
                                  i)
        np.testing.assert_allclose(to_numpy(tl), np.asarray(jl), rtol=1e-5,
                                   atol=1e-5, err_msg=f"step {i}")
    assert [id(c) for c in tcache] == ids
    for t, j in zip(tcache, jc):
        np.testing.assert_allclose(to_numpy(t), np.asarray(j), rtol=1e-5,
                                   atol=1e-6)


def test_toy_server_greedy_tokens_match_reference():
    """Reduced seamless at f32 through ToyServer, two slots, three
    requests: the reference's tokens and stats. The decoder attends over
    the zero cross K/V that ``init_cache`` leaves (the reference serves
    the family this way; ToyServer never runs the encoder)."""
    want, jstats, got, stats = F.toy_tokens(ARCH, dict(F.F32), [4, 9, 6])
    assert got == want and stats == jstats


def test_three_steps_match_reference():
    kw = dict(F.F32, attention_impl="chunked", attention_chunk=8)
    shape = ("t", F.SEQ, F.BATCH, "train")
    jr = jget_runner(reduced(get_config(ARCH)), ShapeConfig(*shape),
                     RunConfig(**kw), seed=0)
    named = {n: np.asarray(a) for n, a in named_leaves(jr.state.params)}
    tr = get_runner(tc.reduced(tc.get_config(ARCH)), tc.ShapeConfig(*shape),
                    tc.RunConfig(**kw), device="cpu",
                    params=load_reference_params(named, "cpu"))
    assert tr.plan.tables() == jr.plan.tables()
    ds = F.dataset(reduced(get_config(ARCH)))
    for i in range(3):
        jm, tm = jr.run(ds.batch(i)), tr.run(ds.batch(i))
        for k in ("loss", "xent", "grad_norm"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=1e-5, err_msg=f"{k} step {i}")
