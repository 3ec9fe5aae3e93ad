"""Training rwkv6 in the port against the JAX package, from the same
parameters at f32: reduced rwkv6-7b (2 layers, d 64, 4 heads of 16). The
reference trains through the autodiff of its jnp ``_chunk_wkv``
(``repro/models/rwkv.py``), not its Pallas kernel; the port trains through
``models/rwkv.py::chunk_wkv`` under autograd and keeps ``ops.wkv`` (the
forward-only kernel) for serving.

  * ``chunk_wkv`` and its gradients against ``jax.grad`` of the
    reference's ``_chunk_wkv`` at a ragged S (two chunks and a tail) and
    at S below the chunk;
  * ``loss_fn``: the loss within rtol 1e-5 and every gradient within rtol
    1e-4 (atol 1e-5 for entries near zero; the WKV's exp(±cum) factors
    carry f32 rounding of the cumulative log-decay into the gradients);
  * a 3-step trajectory through ``get_runner`` within rtol 1e-5;
  * the routes: ``loss_fn`` never reaches ``ops.wkv``, the serving prefill
    always does.

The parameters the seeded init leaves at zero (token-shift mixes, the
decay LoRA's second factor, w0, the bonus) are redrawn from a seed, so the
data-dependent decay and the bonus are exercised.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_families as F
from repro.configs import RunConfig, ShapeConfig, get_config, reduced
from repro.core.transform import get_runner as jget_runner
from repro.models import rwkv as jrwkv
from repro.utils.tree import named_leaves
import repro_torch.configs as tc
from repro_torch.core.transform import get_runner
from repro_torch.kernels import ops
from repro_torch.models import rwkv
from repro_torch.weights import load_reference_params, to_numpy

ARCH = "rwkv6-7b"
DRAW = {"tm.mu": (0.3, 0.0), "cm.mu": (0.3, 0.0),
        "tm.w_lora_b": (0.01, 0.0), "tm.w0": (0.3, -0.5),
        "tm.bonus": (0.3, 0.0)}
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    yield from F.one_thread()


@pytest.mark.parametrize("s,chunk", [(70, 32), (20, 32)])
def test_chunk_wkv_and_its_gradients_match_reference(s, chunk):
    rng = np.random.default_rng(0)
    b, h, e = 2, 3, 8
    r, k, v = (rng.standard_normal((b, s, h, e)).astype(np.float32) * 0.5
               for _ in range(3))
    lw = -np.exp(rng.standard_normal((b, s, h, e)) * 0.5 - 1.0).astype(
        np.float32)
    bonus = (rng.standard_normal((h, e)) * 0.1).astype(np.float32)
    st = (rng.standard_normal((b, h, e, e)) * 0.1).astype(np.float32)
    args = [r, k, v, lw, bonus, st]
    wo = rng.standard_normal((b, s, h, e)).astype(np.float32)
    ws = rng.standard_normal((b, h, e, e)).astype(np.float32)

    def jf(*a):
        o, sn = jrwkv._chunk_wkv(*a, chunk)
        return jnp.sum(o * wo) + jnp.sum(sn * ws), (o, sn)

    (_, (jo, js)), jg = jax.value_and_grad(jf, argnums=tuple(range(6)),
                                           has_aux=True)(
        *[jnp.asarray(a) for a in args])
    targs = [torch.tensor(a, requires_grad=True) for a in args]
    o, sn = rwkv.chunk_wkv(*targs, chunk)
    (torch.sum(o * torch.from_numpy(wo))
     + torch.sum(sn * torch.from_numpy(ws))).backward()
    np.testing.assert_allclose(to_numpy(o), np.asarray(jo), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(to_numpy(sn), np.asarray(js), rtol=1e-5,
                               atol=1e-5)
    for name, t, g in zip(("r", "k", "v", "lw", "bonus", "state"), targs,
                          jg):
        np.testing.assert_allclose(to_numpy(t.grad), np.asarray(g),
                                   err_msg=name, **GRAD_TOL)


def test_loss_and_gradients_match_reference():
    jm, jp, tm, _ = F.pair(ARCH, draw=DRAW)
    batch = F.dataset(reduced(get_config(ARCH)), seed=1).batch(0)
    F.check_loss_and_grads(jm, jp, tm, batch, grad_tol=GRAD_TOL)


def test_three_steps_match_reference():
    shape = ("t", F.SEQ, F.BATCH, "train")
    jr = jget_runner(reduced(get_config(ARCH)), ShapeConfig(*shape),
                     RunConfig(**F.F32), seed=0)
    named = {n: np.asarray(a) for n, a in named_leaves(jr.state.params)}
    tr = get_runner(tc.reduced(tc.get_config(ARCH)), tc.ShapeConfig(*shape),
                    tc.RunConfig(**F.F32), device="cpu",
                    params=load_reference_params(named, "cpu"))
    assert tr.plan.tables() == jr.plan.tables()
    ds = F.dataset(reduced(get_config(ARCH)))
    for i in range(3):
        jm, tm = jr.run(ds.batch(i)), tr.run(ds.batch(i))
        for k in ("loss", "xent", "grad_norm"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=1e-5, err_msg=f"{k} step {i}")


def test_training_takes_chunk_wkv_and_serving_the_kernel(monkeypatch):
    tm = F.port_model(ARCH)
    calls = []
    real = ops.wkv

    def spy(*a, **kw):
        calls.append(torch.is_grad_enabled())
        return real(*a, **kw)

    monkeypatch.setattr(ops, "wkv", spy)
    batch = F.tensors(F.dataset(tm.cfg).batch(0))
    loss, _ = tm.loss_fn(batch)
    loss.backward()
    assert calls == []
    tm.prefill_fn({"tokens": batch["tokens"]})
    assert calls == [False] * tm.cfg.n_layers
