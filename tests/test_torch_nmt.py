"""The port's parallax-nmt (the LSTM encoder-decoder with two sparse
tables) against the JAX package's on one device, from the same parameters
(the reference's init, loaded bit for bit through ``weights.py``) and the
same numpy batches: logits, loss, both tables' census, every gradient, a
3-step ``get_runner`` trajectory, and the two-table census and plan.

Tolerances are ``tests/test_torch_lstm.py``'s: at f32 rtol 1e-5 (atol 1e-6
for entries near zero; GEMM summation order differs), at bf16 2e-2 scaled
by the largest value (both sides round intermediates at other places). The
census metrics, the per-table census and the plan are equal.
"""
from dataclasses import asdict

import jax
import numpy as np
import pytest
import torch

from repro.configs import RunConfig, ShapeConfig, get_config, reduced
from repro.core.runtime import Runtime as JRuntime
from repro.core.sparsity import expected_unique_zipf
from repro.core.transform import analyze as janalyze
from repro.core.transform import estimate_census as jestimate
from repro.core.transform import get_runner as jget_runner
from repro.data import SyntheticLM
from repro.models.model import build_model as jbuild
from repro.utils.tree import named_leaves
import repro_torch.configs as tc
from repro_torch.core.runtime import Runtime
from repro_torch.core.transform import (analyze, estimate_census, get_runner,
                                        load_params_)
from repro_torch.models.model import build_model
from repro_torch.utils.tree import named_parameters
from repro_torch.weights import load_reference_params, to_numpy

SEQ, BATCH, STEPS = 16, 4, 3
TABLES = ("embed", "enc_embed")
CENSUS = tuple(f"{t}_{k}" for t in TABLES
               for k in ("rows", "unique", "dropped"))
# the reference's two-table knobs (tests/test_replan.py, test_serving.py)
TWO_TABLE = dict(capacity_mode="capped", capacity_factor=1.5,
                 table_zipf=(("embed", 1.3),),
                 table_alpha=(("enc_embed", 0.99),))
NAMES = ["attn_mix", "embed", "enc_embed", "enc_layers.bias",
         "enc_layers.w_h", "enc_layers.w_proj", "enc_layers.w_x", "head",
         "layers.bias", "layers.w_h", "layers.w_proj", "layers.w_x"]


def _batch(vocab: int, seed: int = 1, i: int = 0) -> dict:
    return SyntheticLM(vocab, SEQ, BATCH, seed=seed, is_encdec=True).batch(i)


def _pair(dtype, layers=2):
    jcfg = reduced(get_config("parallax-nmt"), layers=layers)
    rc = RunConfig(param_dtype=dtype, compute_dtype=dtype)
    jrt = JRuntime(jcfg, rc, ShapeConfig("t", SEQ, BATCH, "train"))
    jmodel = jbuild(jcfg, jrt)
    params = jmodel.init(jax.random.key(0))
    named = {n: np.asarray(a) for n, a in named_leaves(params)}

    tcfg = tc.reduced(tc.get_config("parallax-nmt"), layers=layers)
    rt = Runtime(tcfg, tc.RunConfig(param_dtype=dtype, compute_dtype=dtype),
                 tc.ShapeConfig("t", SEQ, BATCH, "train"), device="cpu")
    tmodel = build_model(tcfg, rt)
    load_params_(tmodel, load_reference_params(named, "cpu"))
    batch = _batch(jcfg.vocab_size)
    tbatch = {k: torch.from_numpy(np.ascontiguousarray(v))
              for k, v in batch.items()}
    return jmodel, params, tmodel, batch, tbatch


def _close(got, want, dtype, what=""):
    want = np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6,
                                   err_msg=what)
    else:
        scale = float(np.abs(want).max()) or 1.0
        np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2 * scale,
                                   err_msg=what)


def test_parameter_names_order_and_load_match_reference():
    _, params, tmodel, _, _ = _pair("float32")
    want = [n for n, _ in named_leaves(params)]
    assert want == NAMES
    assert list(named_parameters(tmodel)) == want
    got = named_parameters(tmodel)
    for n, a in named_leaves(params):
        assert tuple(got[n].shape) == tuple(a.shape), n
        np.testing.assert_array_equal(to_numpy(got[n]),
                                      np.asarray(a, np.float32), err_msg=n)


def test_bf16_parameters_load_bit_for_bit():
    _, params, tmodel, _, _ = _pair("bfloat16")
    got = named_parameters(tmodel)
    for n, a in named_leaves(params):
        assert got[n].dtype == torch.bfloat16, n
        bits = np.asarray(a).view(np.int16)
        assert np.array_equal(got[n].detach().view(torch.int16).numpy(),
                              bits), n


@pytest.mark.parametrize("layers", [1, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_logits_and_census_match_reference(dtype, layers):
    jmodel, params, tmodel, batch, tbatch = _pair(dtype, layers)
    jlogits, _, jm = jmodel.prefill_fn(params, batch)
    with torch.no_grad():
        got, (c, h), metrics = tmodel(tbatch)
    assert got.dtype == tmodel.rt.dtype
    assert c.dtype == torch.float32 and h.dtype == tmodel.rt.dtype
    _close(to_numpy(got), jlogits, dtype)
    assert set(metrics) == set(CENSUS)
    for k in CENSUS:
        assert float(metrics[k]) == float(jm[k]), k


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_and_gradients_match_reference(dtype):
    jmodel, params, tmodel, batch, tbatch = _pair(dtype)
    (jloss, jm), jgrads = jax.value_and_grad(jmodel.loss_fn, has_aux=True)(
        params, batch)
    loss, metrics = tmodel.loss_fn(tbatch)
    loss.backward()
    rtol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=rtol)
    for k in CENSUS:
        assert float(metrics[k]) == float(jm[k]), k
    own = named_parameters(tmodel)
    for n, g in named_leaves(jgrads):
        assert own[n].grad.dtype == own[n].dtype, n
        _close(to_numpy(own[n].grad), g, dtype, n)


def test_encoder_gradient_flows_through_the_attention():
    """The source side reaches the loss only through the dot attention:
    both source-side gradients are nonzero."""
    _, _, tmodel, _, tbatch = _pair("float32")
    loss, _ = tmodel.loss_fn(tbatch)
    loss.backward()
    own = named_parameters(tmodel)
    for n in ("enc_embed", "enc_layers.w_x", "attn_mix"):
        assert torch.count_nonzero(own[n].grad) > 0, n


@pytest.mark.parametrize("kw", [{}, TWO_TABLE], ids=["exact", "two_table"])
def test_three_steps_match_reference(kw):
    """A 3-step f32 ``get_runner`` trajectory, port against the JAX
    package, from the same parameters and batches (the source stream
    uniform, a near-dense table)."""
    f32 = dict(param_dtype="float32", compute_dtype="float32", **kw)
    jcfg = reduced(get_config("parallax-nmt"))
    jr = jget_runner(jcfg, ShapeConfig("t", SEQ, BATCH, "train"),
                     RunConfig(**f32), seed=0)
    named = {n: np.asarray(a) for n, a in named_leaves(jr.state.params)}
    tr = get_runner(tc.reduced(tc.get_config("parallax-nmt")),
                    tc.ShapeConfig("t", SEQ, BATCH, "train"),
                    tc.RunConfig(**f32), device="cpu",
                    params=load_reference_params(named, "cpu"))
    assert tr.plan.tables() == jr.plan.tables()
    ds = SyntheticLM(jcfg.vocab_size, SEQ, BATCH, seed=0, is_encdec=True,
                     src_zipf_a=0.0)
    for i in range(STEPS):
        batch = ds.batch(i)
        jm, tm = jr.run(batch), tr.run(batch)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5, err_msg=f"step {i}")
        for k in CENSUS:
            assert float(tm[k]) == float(jm[k]), (i, k)
        assert tr.state.step == i + 1


def _tiny_pair(rc_kw: dict, kind: str = "train"):
    jcfg = reduced(get_config("parallax-nmt"), vocab=256)
    jrt = JRuntime(jcfg, RunConfig(**rc_kw),
                   ShapeConfig("tiny", 32, 4, kind))
    jmodel = jbuild(jcfg, jrt)
    tcfg = tc.reduced(tc.get_config("parallax-nmt"), vocab=256)
    rt = Runtime(tcfg, tc.RunConfig(**rc_kw),
                 tc.ShapeConfig("tiny", 32, 4, kind), device="cpu")
    return jmodel, jrt, build_model(tcfg, rt), rt


def test_per_table_census_differs_by_declared_skew():
    """The port of the reference's test of the same name: one census call
    gives per-table records, and a declared-Zipf table and a declared
    near-dense table get different alphas and capacities — equal to the
    reference's, record for record."""
    jmodel, jrt, tmodel, rt = _tiny_pair(TWO_TABLE)
    want = jestimate(jmodel, jrt)
    census = estimate_census(tmodel, rt)
    assert set(census.tables) == {"embed", "enc_embed"}
    emb, enc = census.tables["embed"], census.tables["enc_embed"]
    assert emb.alpha == pytest.approx(
        expected_unique_zipf(rt.shape_cfg.tokens, 256, 1.3) / 256)
    assert enc.alpha == pytest.approx(0.99)
    assert emb.alpha < enc.alpha
    assert emb.capacity < enc.capacity
    assert census.alpha_for("embed") == emb.alpha
    assert census.capacity_for("enc_embed") == enc.capacity
    assert census.alpha_for("nope") == census.alpha
    for name in TABLES:
        assert asdict(census.tables[name]) == asdict(want.tables[name]), name
    assert (census.dense_params, census.sparse_params, census.alpha,
            census.local_tokens, census.capacity) == \
        (want.dense_params, want.sparse_params, want.alpha,
         want.local_tokens, want.capacity)


@pytest.mark.parametrize("kw", [{}, TWO_TABLE], ids=["default",
                                                     "two_table"])
@pytest.mark.parametrize("kind", ["train", "decode"])
def test_one_device_plan_tables_match_reference(kw, kind):
    jmodel, jrt, tmodel, rt = _tiny_pair(kw, kind)
    got, want = analyze(tmodel, rt).tables(), janalyze(jmodel, jrt).tables()
    assert set(got) == set(TABLES)
    assert got == want


def test_input_specs_carry_src_tokens():
    _, _, tmodel, _ = _tiny_pair({})
    specs = tmodel.input_specs()
    assert specs["src_tokens"] == ((4, 32), torch.int32)
    assert set(specs) == {"tokens", "labels", "src_tokens"}
    prefill = tc.ShapeConfig("p", 32, 4, "prefill")
    assert "src_tokens" in tmodel.input_specs(prefill)
    lm = tc.reduced(tc.get_config("parallax-lm"))
    lrt = Runtime(lm, tc.RunConfig(), tc.ShapeConfig("t", 8, 2, "train"),
                  device="cpu")
    assert "src_tokens" not in build_model(lm, lrt).input_specs()


def test_forward_without_src_tokens_is_refused():
    _, _, tmodel, _, tbatch = _pair("float32")
    with pytest.raises(ValueError, match="src_tokens"):
        tmodel({"tokens": tbatch["tokens"]})
