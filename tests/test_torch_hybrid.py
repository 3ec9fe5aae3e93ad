"""The port's hybrid family (hymba-1.5b: attention and the selective SSM of
models/ssm.py on the same normed input, averaged) against the JAX
package's, from the same parameters at f32: reduced hymba (2 layers, d 64,
4 q / 2 KV heads of 16, ``ssm_state`` 8).

  * ``_chunk_ssm`` (the chunked selective scan, clamps at ±80) and its
    gradients against the reference's at a ragged S below the chunk, at
    S > chunk (three chunks of 128, the last ragged) and at chunk 16;
  * ``ssm_mix``: output and new state;
  * ``loss_fn``: the loss and every gradient within rtol 1e-5 (atol 1e-6);
  * the prefill logits, and four decode steps through the (k, v, h) cache:
    logits, K/V written in place, the SSM state carried;
  * ``ToyServer`` greedy tokens (hybrid has no bucketed prefill, as in the
    reference).

Values of order 1 (logits, SSM states) are held to rtol 1e-5 and atol
1e-5: the reference's chunked scan's exp(±cum) factors carry f32
rounding of the cumulative log-decay into its output. Where a chunk's
cumulative decay passes the reference's clamps at 80, the port's scan
(each decay one factor exp(cum_t - cum_i)) is held against the float64
recurrence instead: there the reference's departs from it.

The SSM's ``a_log``, ``dt_bias`` and ``w_b`` / ``w_c`` are redrawn from a
seed, so the decay and the input and output maps are exercised.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_families as F
from repro.configs import get_config, reduced
from repro.models import ssm as jssm
from repro_torch.models import ssm, transformer
from repro_torch.weights import to_numpy

ARCH = "hymba-1.5b"
# (scale, offset) of the redrawn SSM parameters: decays exp(dt * A) with A
# around -0.6, dt around softplus(0.5)
DRAW = {"ssm.a_log": (0.3, -0.5), "ssm.dt_bias": (0.3, 0.5),
        "ssm.w_b": (0.3, 0.0), "ssm.w_c": (0.3, 0.0)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    yield from F.one_thread()


def _scan_inputs(s, d=12, n=5, b=2, seed=0):
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((b, s, d)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, d)))).astype(np.float32)
    bt, ct = (rng.standard_normal((b, s, n)).astype(np.float32)
              for _ in range(2))
    # log-decays dt * a around -0.2: a 128-token chunk stays where the
    # clamps at 80 do not act (the model's regime, exact factorization)
    a = (-0.25 * np.exp(rng.standard_normal(d) * 0.3)).astype(np.float32)
    h0 = (rng.standard_normal((b, d, n)) * 0.1).astype(np.float32)
    return [u, dt, bt, ct, a, h0]


@pytest.mark.parametrize("s,chunk", [(50, 128), (300, 128), (40, 16)])
def test_chunk_ssm_and_its_gradients_match_reference(s, chunk):
    args = _scan_inputs(s)
    rng = np.random.default_rng(1)
    wy = rng.standard_normal((2, s, 12)).astype(np.float32)
    wh = rng.standard_normal((2, 12, 5)).astype(np.float32)

    def jf(*a):
        y, h = jssm._chunk_ssm(*a, chunk)
        return jnp.sum(y * wy) + jnp.sum(h * wh), (y, h)

    (_, (jy, jh)), jg = jax.value_and_grad(jf, argnums=tuple(range(6)),
                                           has_aux=True)(
        *[jnp.asarray(a) for a in args])
    targs = [torch.tensor(a, requires_grad=True) for a in args]
    y, h = ssm._chunk_ssm(*targs, chunk)
    (torch.sum(y * torch.from_numpy(wy))
     + torch.sum(h * torch.from_numpy(wh))).backward()
    np.testing.assert_allclose(to_numpy(y), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(to_numpy(h), np.asarray(jh), rtol=1e-5,
                               atol=1e-5)
    # gradients to 1e-5 of their scale: each package lies within ~1e-6 of a
    # float64 evaluation, a's (summed over the batch and the positions)
    # within 6e-6 at S 300
    for name, t, g in zip(("u", "dt", "b", "c", "a", "h0"), targs, jg):
        g = np.asarray(g)
        np.testing.assert_allclose(to_numpy(t.grad), g, rtol=1e-4,
                                   atol=1e-5 * np.abs(g).max(), err_msg=name)


def _recurrence(u, dt, bt, ct, a, h0):
    """The SSM recurrence token by token in float64 (the oracle)."""
    u, dt, bt, ct, a, h = (np.asarray(x, np.float64)
                           for x in (u, dt, bt, ct, a, h0))
    ys = []
    for t in range(u.shape[1]):
        h = h * np.exp(dt[:, t] * a)[..., None] \
            + (dt[:, t] * u[:, t])[..., None] * bt[:, t, None, :]
        ys.append(np.einsum("bn,bdn->bd", ct[:, t], h))
    return np.stack(ys, 1), h


def test_chunk_ssm_is_the_recurrence_where_the_reference_clamps():
    """Log-decays of ~-1.5 a token: a 128-token chunk spans ~190 of
    cumulative decay, past the reference's clamps at 80. The port's scan
    (each decay one factor exp(cum_t - cum_i) <= 1) is the recurrence's
    within 1e-5 of its scale; the reference's factored form departs from
    it there (ROADMAP Queue 3, a recorded mismatch)."""
    args = _scan_inputs(300)
    args[4] = (args[4] * 6.0).astype(np.float32)          # dt·a ~ -1.5
    want_y, want_h = _recurrence(*args)
    y, h = ssm._chunk_ssm(*[torch.from_numpy(a) for a in args], 128)
    scale = np.abs(want_y).max()
    np.testing.assert_allclose(to_numpy(y), want_y, atol=1e-5 * scale)
    np.testing.assert_allclose(to_numpy(h), want_h,
                               atol=1e-5 * np.abs(want_h).max())
    jy, _ = jssm._chunk_ssm(*[jnp.asarray(a) for a in args], 128)
    jy = np.asarray(jy)
    assert not (np.isfinite(jy).all()
                and np.abs(jy - want_y).max() < 1e-3 * scale)


def test_ssm_mix_matches_reference():
    jm, jp, tm, _ = F.pair(ARCH, draw=DRAW)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 20, 64)).astype(np.float32)
    h0 = (rng.standard_normal((2, 64, 8)) * 0.1).astype(np.float32)
    jl = jax.tree.map(lambda a: a[1], jp["layers"])["ssm"]
    jy, jh = jssm.ssm_mix(jl, jnp.asarray(x), jnp.asarray(h0), cfg=jm.cfg,
                          rt=jm.rt)
    tl = transformer._layer_params(tm.params(), 1)["ssm"]
    with torch.no_grad():
        y, h = ssm.ssm_mix(tl, torch.from_numpy(x), torch.from_numpy(h0),
                           cfg=tm.cfg)
    # the reference scans chunks of 128, the port of 16 (the same
    # recurrence): f32 rounding to 1e-5 of the output's scale
    jy = np.asarray(jy)
    np.testing.assert_allclose(to_numpy(y), jy, rtol=1e-5,
                               atol=1e-5 * np.abs(jy).max())
    np.testing.assert_allclose(to_numpy(h), np.asarray(jh), rtol=1e-5,
                               atol=1e-5)


def test_loss_and_gradients_match_reference():
    jm, jp, tm, _ = F.pair(ARCH, draw=DRAW)
    batch = F.dataset(reduced(get_config(ARCH)), seed=1).batch(0)
    F.check_loss_and_grads(jm, jp, tm, batch)


def test_prefill_and_decode_carry_match_reference():
    """The prefill logits; then four decode steps from ``init_cache``: the
    (k, v, h) cache's tensors are written in place, h carries the SSM
    state, and logits and the whole cache match the reference's."""
    jm, jp, tm, _ = F.pair(ARCH, kind="decode", draw=DRAW)
    toks = np.random.default_rng(3).integers(0, 512, (2, 12)).astype(
        np.int32)
    jl, _, _ = jm.prefill_fn(jp, {"tokens": jnp.asarray(toks)})
    tl, _, _ = tm.prefill_fn({"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(to_numpy(tl), np.asarray(jl), rtol=1e-5,
                               atol=1e-5)
    jc, tcache = jm.init_cache(2, 16), tm.init_cache(2, 16)
    assert [tuple(c.shape) for c in tcache] == [tuple(c.shape) for c in jc]
    assert tcache[2].dtype == torch.float32
    ids = [id(c) for c in tcache]
    for i in range(4):
        jl, jc = jm.decode_fn(jp, jc, jnp.asarray(toks[:, i:i + 1]),
                              jnp.asarray(i, jnp.int32))
        tl, tcache = tm.decode_fn(tcache, torch.from_numpy(toks[:, i:i + 1]),
                                  i)
        np.testing.assert_allclose(to_numpy(tl), np.asarray(jl), rtol=1e-5,
                                   atol=1e-5, err_msg=f"step {i}")
    assert [id(c) for c in tcache] == ids and bool(tcache[2].abs().sum())
    for t, j in zip(tcache, jc):
        np.testing.assert_allclose(to_numpy(t), np.asarray(j), rtol=1e-5,
                                   atol=1e-5)


def test_toy_server_greedy_tokens_match_reference():
    """hymba has no bucketed prefill (its cache carries the SSM state):
    it serves through ToyServer, whose tokens and stats match the
    reference's."""
    assert F.port_model(ARCH).prefill_cache_fn is None
    want, jstats, got, stats = F.toy_tokens(ARCH, dict(F.F32), [4, 9, 6])
    assert got == want and stats == jstats
