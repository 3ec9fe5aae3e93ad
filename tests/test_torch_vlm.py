"""The port's vlm family (chameleon-34b: the dense decoder layers, with the
precomputed frontend ``embeds`` added after the lookup) against the JAX
package's, from the same parameters at f32: reduced chameleon (2 layers,
d 64, vocab 512).

  * ``loss_fn``: the loss and every gradient within rtol 1e-5 (atol 1e-6),
    with and without ``embeds`` in the batch;
  * ``prefill_fn`` logits with and without ``embeds``, and their
    difference (the stub's contribution);
  * the paged engine (chameleon has a positional KV cache, as the
    reference's ``model.py`` says): greedy tokens and the engine's stats
    equal the reference engine's.
"""
import jax.numpy as jnp
import numpy as np
import pytest

import _torch_families as F
from repro.configs import RunConfig, get_config, reduced
from repro.runtime.server import Request as JRequest
from repro.runtime.server import Server as JServer
from repro.runtime.server import ServerConfig as JServerConfig
from repro.utils.tree import named_leaves
import repro_torch.configs as tc
from repro_torch.runtime.server import Request, Server, ServerConfig
from repro_torch.weights import load_reference_params, to_numpy

ARCH = "chameleon-34b"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    yield from F.one_thread()


def _batch(embeds: bool, seed=1):
    batch = F.dataset(reduced(get_config(ARCH)), seed=seed).batch(0)
    if embeds:
        rng = np.random.default_rng(seed)
        batch["embeds"] = (rng.standard_normal((F.BATCH, F.SEQ, 64))
                           * 0.5).astype(np.float32)
    return batch


@pytest.mark.parametrize("embeds", [False, True])
def test_loss_and_gradients_match_reference(embeds):
    jm, jp, tm, _ = F.pair(ARCH)
    F.check_loss_and_grads(jm, jp, tm, _batch(embeds))


def test_prefill_with_and_without_embeds_matches_reference():
    jm, jp, tm, _ = F.pair(ARCH, kind="prefill")
    out = {}
    for embeds in (False, True):
        batch = {k: v for k, v in _batch(embeds).items() if k != "labels"}
        jl, _, _ = jm.prefill_fn(jp, {k: jnp.asarray(v)
                                      for k, v in batch.items()})
        tl, _, _ = tm.prefill_fn(F.tensors(batch))
        np.testing.assert_allclose(to_numpy(tl), np.asarray(jl), rtol=1e-5,
                                   atol=1e-5, err_msg=f"embeds {embeds}")
        out[embeds] = to_numpy(tl)
    assert np.abs(out[True] - out[False]).max() > 1e-2


def test_engine_greedy_tokens_match_reference():
    """Two slots, three requests of mixed length (one slot reused) through
    the paged engine with its bucketed prefill."""
    scfg = dict(max_batch=2, max_seq=32)
    prompts = F.prompts([4, 9, 6], 100)
    jsv = JServer(reduced(get_config(ARCH)), RunConfig(**F.F32),
                  JServerConfig(**scfg), seed=0)
    for i, p in enumerate(prompts):
        jsv.submit(JRequest(i, p, max_new_tokens=6))
    jsv.run_until_drained()
    jsv.close()
    named = {n: np.asarray(a) for n, a in named_leaves(jsv.params)}
    sv = Server(tc.reduced(tc.get_config(ARCH)), tc.RunConfig(**F.F32),
                ServerConfig(**scfg), device="cpu",
                params=load_reference_params(named, "cpu"))
    assert sv.model.prefill_cache_fn is not None
    for i, p in enumerate(prompts):
        sv.submit(Request(i, p, max_new_tokens=6))
    sv.run_until_drained()
    sv.close()
    assert {r.uid: r.out_tokens for r in sv.completed} == \
        {r.uid: r.out_tokens for r in jsv.completed}
    for k in ("prefill_calls", "prefill_traces", "decode_traces", "buckets",
              "cross_slot_mismatches"):
        assert sv.stats[k] == jsv.stats[k], k
