"""The port's parallax-lm against the JAX package's, from the same
parameters (the reference's init, loaded bit for bit): logits, loss and
every gradient.

Tolerances: at f32 the products run in another summation order (torch's
CPU GEMM against XLA's), so values agree to rtol 1e-5, with atol 1e-6 for
the entries that sit near zero. At bf16 both sides round intermediates at
slightly different places (fused elementwise chains in XLA), so they agree
to 2e-2.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import RunConfig, ShapeConfig, get_config, reduced
from repro.core.runtime import Runtime as JRuntime
from repro.data import SyntheticLM
from repro.models.model import build_model as jbuild
from repro.utils.tree import named_leaves
import repro_torch.configs as tc
from repro_torch.core.runtime import Runtime
from repro_torch.core.transform import load_params_
from repro_torch.models.model import build_model
from repro_torch.utils.tree import named_parameters
from repro_torch.weights import load_reference_params, to_numpy

SEQ, BATCH = 16, 4


def _pair(dtype, layers=2):
    jcfg = reduced(get_config("parallax-lm"), layers=layers)
    rc = RunConfig(param_dtype=dtype, compute_dtype=dtype)
    jrt = JRuntime(jcfg, rc, ShapeConfig("t", SEQ, BATCH, "train"))
    jmodel = jbuild(jcfg, jrt)
    params = jmodel.init(jax.random.key(0))
    named = {n: np.asarray(a) for n, a in named_leaves(params)}

    tcfg = tc.reduced(tc.get_config("parallax-lm"), layers=layers)
    rt = Runtime(tcfg, tc.RunConfig(param_dtype=dtype, compute_dtype=dtype),
                 tc.ShapeConfig("t", SEQ, BATCH, "train"), device="cpu")
    tmodel = build_model(tcfg, rt)
    load_params_(tmodel, load_reference_params(named, "cpu"))
    batch = SyntheticLM(jcfg.vocab_size, SEQ, BATCH, seed=1).batch(0)
    tbatch = {k: torch.from_numpy(np.ascontiguousarray(v))
              for k, v in batch.items()}
    return jmodel, params, tmodel, batch, tbatch


def _tol(dtype):
    return dict(rtol=1e-5, atol=1e-6) if dtype == "float32" \
        else dict(rtol=2e-2, atol=2e-2)


def test_parameter_names_and_order_match_reference():
    jmodel, params, tmodel, _, _ = _pair("float32")
    want = [n for n, _ in named_leaves(params)]
    assert list(named_parameters(tmodel)) == want
    assert [n for n, _ in tmodel.named_parameters()] == want
    assert want == ["embed", "head", "layers.bias", "layers.w_h",
                    "layers.w_proj", "layers.w_x"]
    for n, a in named_leaves(params):
        np.testing.assert_array_equal(
            to_numpy(named_parameters(tmodel)[n]), np.asarray(a, np.float32))


@pytest.mark.parametrize("layers", [1, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_logits_match_reference(dtype, layers):
    jmodel, params, tmodel, batch, tbatch = _pair(dtype, layers)
    want = np.asarray(jmodel.prefill_fn(params, batch)[0], np.float32)
    with torch.no_grad():
        got, (c, h), metrics = tmodel(tbatch)
    assert got.dtype == tmodel.rt.dtype
    assert c.dtype == torch.float32 and h.dtype == tmodel.rt.dtype
    scale = float(np.abs(want).max())
    tol = _tol(dtype)
    np.testing.assert_allclose(to_numpy(got), want, rtol=tol["rtol"],
                               atol=tol["atol"] * (scale if dtype !=
                                                   "float32" else 1.0))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_and_gradients_match_reference(dtype):
    jmodel, params, tmodel, batch, tbatch = _pair(dtype)
    (jloss, jm), jgrads = jax.value_and_grad(jmodel.loss_fn, has_aux=True)(
        params, batch)
    loss, metrics = tmodel.loss_fn(tbatch)
    loss.backward()
    tol = _tol(dtype)
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=tol["rtol"])
    for k in ("embed_rows", "embed_unique", "embed_dropped"):
        assert float(metrics[k]) == float(jm[k]), k
    grads = {n: p.grad for n, p in named_parameters(tmodel).items()}
    for n, g in named_leaves(jgrads):
        want = np.asarray(g, np.float32)
        got = to_numpy(grads[n])
        assert grads[n].dtype == named_parameters(tmodel)[n].dtype, n
        scale = float(np.abs(want).max()) or 1.0
        atol = tol["atol"] if dtype == "float32" else tol["atol"] * scale
        np.testing.assert_allclose(got, want, rtol=tol["rtol"], atol=atol,
                                   err_msg=n)


def test_encdec_and_other_families_are_refused():
    # parallax-nmt trains since its port (tests/test_torch_nmt.py), the
    # dense family since its own (tests/test_torch_dense_train.py), and
    # rwkv6, the moe family and the other slice-6 families since theirs
    # (tests/test_torch_families.py, test_torch_moe.py); none through the
    # forward-only flash kernel
    for arch, kw, match in (
            ("phi3-medium-14b", {"attention_impl": "pallas"},
             "pallas.*forward-only"),
            ("grok-1-314b", {"attention_impl": "pallas"},
             "pallas.*forward-only")):
        cfg = tc.reduced(tc.get_config(arch))
        rt = Runtime(cfg, tc.RunConfig(**kw),
                     tc.ShapeConfig("t", 8, 2, "train"), device="cpu")
        with pytest.raises(NotImplementedError, match=match):
            build_model(cfg, rt).loss_fn(
                {"tokens": torch.zeros((2, 8), dtype=torch.int32),
                 "labels": torch.zeros((2, 8), dtype=torch.int32)})
