"""Training the dense transformer in the port, on one device, against the
JAX package: reduced ``phi3-medium-14b`` and ``command-r-35b`` (tied
embeddings) at f32, from the same parameters (the reference's init, loaded
through ``weights.load_reference_params``).

  * ``DenseLM.loss_fn``: the loss and every parameter's gradient, under
    ``naive`` and ``chunked`` attention (chunk 8 of 32 positions, so the
    online softmax runs over four chunks);
  * ``get_runner(...).run``: a 3-step trajectory; and 6 steps of the
    default bf16 RunConfig at d 1,024, within rtol 2e-2;
  * ``RunConfig.remat`` ``none`` / ``block`` / ``full``: equal values, and
    each recomputes what it should in the backward;
  * refused by name: ``attention_impl="pallas"`` in a training step (the
    flash kernel is forward-only, as the reference's), ``explicit_sp``,
    and the ``dp`` dense strategy on a mesh;
  * the reference's three trainer cases of ``tests/test_system.py`` on
    phi3: the loss falls; a checkpoint resumes bit for bit, and either
    package continues the other's checkpoint; a failed step is retried
    (from the last checkpoint, or from a fresh draw of the seed's init
    when nothing is committed).

Tolerances: f32 products run in another summation order (torch's CPU GEMM
against XLA's), so values agree to rtol 1e-5, with atol 1e-6 for
gradient entries near zero; Adam carries the last bits into the updates,
so trajectories are held to rtol 1e-5 as well.
"""
import dataclasses
from collections import Counter

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.checkpoint import ckpt as jckpt
from repro.configs import RunConfig, ShapeConfig, get_config, reduced
from repro.core.runtime import Runtime as JRuntime
from repro.core.transform import get_runner as jget_runner
from repro.data import SyntheticLM
from repro.models.model import build_model as jbuild
from repro.runtime.trainer import Trainer as JTrainer
from repro.runtime.trainer import TrainerConfig as JTrainerConfig
from repro.utils.tree import named_leaves
import repro_torch.configs as tc
from repro_torch.checkpoint.ckpt import state_leaves
from repro_torch.core.runtime import Runtime
from repro_torch.core.transform import (analyze, build_step, get_runner,
                                        init_params_, load_params_)
from repro_torch.launch.mesh import MeshShape
from repro_torch.models.model import build_model
from repro_torch.optim.optimizer import make_optimizer
from repro_torch.runtime.trainer import Trainer, TrainerConfig
from repro_torch.utils.tree import named_parameters
from repro_torch.weights import load_reference_params, to_numpy

SEQ, BATCH, STEPS = 32, 4, 3
ARCHS = ["phi3-medium-14b", "command-r-35b"]
IMPLS = ["naive", "chunked"]
# f32 end to end, the wire included: at the default bf16 wire the pushed
# rows round to bf16, and a last-bit difference before the cast can land
# one bf16 step apart
F32 = dict(param_dtype="float32", compute_dtype="float32",
           wire_dtype="float32", attention_chunk=8)
TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small eager ops: one intra-op thread beside the other test
    workers, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(arch: str, kw: dict):
    """The reference model with its init, and the port's model holding
    the same parameters; one batch for both."""
    jcfg = reduced(get_config(arch))
    jrt = JRuntime(jcfg, RunConfig(**kw), ShapeConfig("t", SEQ, BATCH,
                                                      "train"))
    jmodel = jbuild(jcfg, jrt)
    params = jmodel.init(jax.random.key(0))
    named = {n: np.asarray(a) for n, a in named_leaves(params)}
    tmodel = _port_model(arch, kw)
    load_params_(tmodel, load_reference_params(named, "cpu"))
    batch = SyntheticLM(jcfg.vocab_size, SEQ, BATCH, seed=1).batch(0)
    return jmodel, params, tmodel, batch, _tensors(batch)


def _port_model(arch: str, kw: dict):
    cfg = tc.reduced(tc.get_config(arch))
    rt = Runtime(cfg, tc.RunConfig(**kw), tc.ShapeConfig("t", SEQ, BATCH,
                                                         "train"),
                 device="cpu")
    return build_model(cfg, rt)


def _tensors(batch: dict) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


def _loss_and_grads(model, batch: dict) -> tuple:
    for p in model.parameters():
        p.grad = None
    loss, metrics = model.loss_fn(batch)
    loss.backward()
    return loss.detach(), metrics, {n: p.grad.clone() for n, p in
                                    named_parameters(model).items()}


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_reference(arch, impl):
    kw = dict(F32, attention_impl=impl, remat="none")
    jmodel, params, tmodel, batch, tbatch = _pair(arch, kw)
    assert list(named_parameters(tmodel)) == \
        [n for n, _ in named_leaves(params)]
    (jloss, jm), jgrads = jax.value_and_grad(jmodel.loss_fn, has_aux=True)(
        params, batch)
    loss, metrics, grads = _loss_and_grads(tmodel, tbatch)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["xent"]), float(jm["xent"]),
                               rtol=1e-5)
    for k in ("embed_rows", "embed_unique", "embed_dropped"):
        assert float(metrics[k]) == float(jm[k]), k
    for n, g in named_leaves(jgrads):
        np.testing.assert_allclose(to_numpy(grads[n]), np.asarray(g),
                                   err_msg=n, **TOL)
    if arch == "command-r-35b":
        # the tied table takes both the lookup's push and the head's part
        assert "head" not in grads and grads["embed"].abs().sum() > 0


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", ARCHS)
def test_three_steps_match_reference(arch, impl):
    kw = dict(F32, attention_impl=impl, remat="none")
    shape = ("t", SEQ, BATCH, "train")
    jr = jget_runner(reduced(get_config(arch)), ShapeConfig(*shape),
                     RunConfig(**kw), seed=0)
    named = {n: np.asarray(a) for n, a in named_leaves(jr.state.params)}
    tr = get_runner(tc.reduced(tc.get_config(arch)), tc.ShapeConfig(*shape),
                    tc.RunConfig(**kw), device="cpu",
                    params=load_reference_params(named, "cpu"))
    assert tr.plan.tables() == jr.plan.tables()
    ds = SyntheticLM(reduced(get_config(arch)).vocab_size, SEQ, BATCH)
    for i in range(STEPS):
        jm, tm = jr.run(ds.batch(i)), tr.run(ds.batch(i))
        for k in ("loss", "xent", "grad_norm"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=1e-5, err_msg=f"{k} step {i}")
    assert tr.state.step == STEPS


WIDE = dict(n_layers=1, d_model=1024, n_heads=8, n_kv_heads=2, d_ff=3584,
            vocab_size=8192, head_dim=128)


def test_bf16_default_trajectory_follows_reference_at_width():
    """The default RunConfig (bf16, AdamW at 1e-3 without warmup, chunked
    attention, remat block) at d 1,024: 6 steps within the bf16 bar of
    test_torch_runner.py, rtol 2e-2, of the reference's. Both rise at step
    2: Adam's first steps move every weight by about lr whatever its
    gradient, so the early loss is not monotone at width, in the
    reference as in the port (the card's dense_train sees the same at d
    5,120)."""
    jcfg = dataclasses.replace(get_config("phi3-medium-14b"), **WIDE)
    tcfg = dataclasses.replace(tc.get_config("phi3-medium-14b"), **WIDE)
    shape = ("t", 64, 4, "train")
    jr = jget_runner(jcfg, ShapeConfig(*shape), RunConfig(), seed=0)
    named = {n: np.asarray(a) for n, a in named_leaves(jr.state.params)}
    tr = get_runner(tcfg, tc.ShapeConfig(*shape), tc.RunConfig(),
                    device="cpu", params=load_reference_params(named, "cpu"))
    ds = SyntheticLM(WIDE["vocab_size"], 64, 4, zipf_a=1.3)
    want, got = [], []
    for i in range(6):
        want.append(float(jr.run(ds.batch(i))["loss"]))
        got.append(float(tr.run(ds.batch(i))["loss"]))
    np.testing.assert_allclose(got, want, rtol=2e-2)
    assert want[2] > want[1] and got[2] > got[1], (want, got)


class _OpCounter(TorchDispatchMode):
    """Counts the aten ops that run, forward and backward."""

    def __init__(self):
        super().__init__()
        self.ops = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[func.overloadpacket.__name__] += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_modes_give_equal_values(arch):
    """``none``, ``block`` and ``full`` give the same loss and gradients,
    bit for bit; ``block`` recomputes attention's batched products in
    the backward but no weight matmul (they are saved), ``full``
    recomputes the weight matmuls too."""
    tbatch = _tensors(SyntheticLM(512, SEQ, BATCH, seed=1).batch(0))
    runs = {}
    for mode in ("none", "block", "full"):
        model = _port_model(arch, dict(F32, attention_impl="chunked",
                                       remat=mode))
        torch.manual_seed(0)
        with torch.no_grad():
            for p in model.parameters():
                p.copy_(torch.randn_like(p) * 0.05 + (p.dim() == 1))
        with _OpCounter() as count:
            loss, _, grads = _loss_and_grads(model, tbatch)
        runs[mode] = (loss, grads, count.ops)
    loss0, grads0, ops0 = runs["none"]
    for mode in ("block", "full"):
        loss, grads, _ = runs[mode]
        assert torch.equal(loss, loss0), mode
        for n, g in grads0.items():
            assert torch.equal(grads[n], g), (mode, n)
    block, full = runs["block"][2], runs["full"][2]
    layers = tc.reduced(tc.get_config(arch)).n_layers
    assert block["mm"] == ops0["mm"]
    assert block["bmm"] > ops0["bmm"]
    # full re-runs each layer's weight matmuls up to the last output the
    # backward reads (the recompute stops there: w_down's is not read)
    assert full["mm"] == ops0["mm"] + 6 * layers


def test_pallas_attention_is_refused_in_training():
    model = _port_model("phi3-medium-14b", dict(F32, attention_impl="pallas",
                                                 remat="none"))
    init_params_(model, 0)
    tbatch = _tensors(SyntheticLM(512, SEQ, BATCH).batch(0))
    with pytest.raises(NotImplementedError, match="pallas.*forward-only"):
        model.loss_fn(tbatch)
    # serving keeps the kernel (its plain version on the CPU)
    logits, _, _ = model.prefill_fn(tbatch)
    assert torch.isfinite(logits).all()


def test_explicit_sp_and_dp_are_refused_by_name():
    """Neither is refused any more. ``explicit_sp`` runs (its mesh cases:
    tests/test_torch_tp_mesh.py): off a mesh it changes nothing. The
    ``dp`` step builds on a ``MeshShape``-planned runtime (the model axis
    a batch axis, every leaf whole: its mesh cases are
    tests/test_torch_dp_mesh.py) and off a mesh runs as ``tp`` does."""
    cfg = tc.reduced(tc.get_config("phi3-medium-14b"))
    shape = tc.ShapeConfig("t", SEQ, BATCH, "train")
    batch = SyntheticLM(cfg.vocab_size, SEQ, BATCH).batch(0)
    losses = [float(get_runner(cfg, shape, tc.RunConfig(
        explicit_sp=sp, **F32), device="cpu").run(batch)["loss"])
        for sp in (False, True)]
    assert losses[0] == losses[1]
    rt = Runtime(cfg, tc.RunConfig(dense_strategy="dp"), shape,
                 mesh=MeshShape((2, 2), ("data", "model")), device="cpu")
    model = build_model(cfg, rt)
    plan = analyze(model, rt)            # planned as the reference plans
    assert rt.resolved_strategy == "dp" and plan.params
    assert rt.batch_axes == ("data", "model") and rt.vocab_shards == 1
    step, state = build_step(model, make_optimizer(rt), rt, plan)
    assert callable(step)
    for n, spec in model.param_specs():
        assert plan.params[n].held == plan.params[n].placement
        assert tuple(state.params[n].shape) == tuple(spec.shape)
    dp = [float(get_runner(cfg, shape, tc.RunConfig(
        dense_strategy=s, **F32), device="cpu").run(batch)["loss"])
        for s in ("tp", "dp")]
    assert dp[0] == dp[1] == losses[0]


# ---------------------------------------------------------------------------
# the reference's trainer cases (tests/test_system.py) on phi3
# ---------------------------------------------------------------------------

SYS_KW = dict(attention_impl="naive", remat="none")
TINY = ("tiny", 32, 4, "train")


def test_train_loss_decreases():
    cfg = tc.reduced(tc.get_config("phi3-medium-14b"))
    runner = get_runner(cfg, tc.ShapeConfig(*TINY),
                        tc.RunConfig(**SYS_KW, learning_rate=3e-3),
                        device="cpu")
    ds = SyntheticLM(cfg.vocab_size, 32, 4)
    losses = [float(runner.run(ds.batch(i))["loss"]) for i in range(20)]
    assert all(np.isfinite(losses))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.2, losses


def _trainer(tcfg: TrainerConfig, layers=2):
    cfg = tc.reduced(tc.get_config("phi3-medium-14b"), layers=layers)
    return Trainer(cfg, tc.ShapeConfig(*TINY), tc.RunConfig(**SYS_KW, **F32),
                   tcfg, SyntheticLM(cfg.vocab_size, 32, 4), device="cpu")


def _jax_trainer(tcfg: JTrainerConfig):
    cfg = reduced(get_config("phi3-medium-14b"))
    return JTrainer(cfg, ShapeConfig(*TINY), RunConfig(**SYS_KW, **F32),
                    tcfg, SyntheticLM(cfg.vocab_size, 32, 4))


def _run(t) -> list:
    out = []
    t.run(on_metrics=lambda s, m: out.append(m["loss"]))
    return out


def _bits(state) -> dict:
    return {p: (t.detach().clone() if isinstance(t, torch.Tensor) else t)
            for p, t in state_leaves(state)}


def test_trainer_checkpoint_resume_bit_for_bit(tmp_path):
    """6 steps straight against 3, a checkpoint, and a fresh trainer's
    restore + 3: equal losses and every parameter and moment bit for
    bit."""
    ref = _trainer(TrainerConfig(total_steps=6))
    want = _run(ref)
    d = str(tmp_path)
    first = _run(_trainer(TrainerConfig(total_steps=3, ckpt_dir=d,
                                        ckpt_every=3)))
    b = _trainer(TrainerConfig(total_steps=6, ckpt_dir=d, ckpt_every=100))
    b.maybe_restore()
    assert b.step == 3
    assert first + _run(b) == want
    got, exp = _bits(b._canonical_state()), _bits(ref._canonical_state())
    assert got.keys() == exp.keys()
    for k, v in exp.items():
        assert (torch.equal(got[k], v) if isinstance(v, torch.Tensor)
                else got[k] == v), k


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_either_package_continues_the_others_checkpoint(tmp_path, writer):
    """A step-3 checkpoint written by one package, continued to step 6 by
    the other: within rtol 1e-5 of the writer's uninterrupted run. The
    port starts from the JAX package's init (its step-0 checkpoint)."""
    d0, d3 = str(tmp_path / "init"), str(tmp_path / "ckpt")
    straight = _jax_trainer(JTrainerConfig(total_steps=6))
    jckpt.save_checkpoint(d0, 0, straight._canonical_state())
    want = _run(straight)
    if writer == "jax":
        _run(_jax_trainer(JTrainerConfig(total_steps=3, ckpt_dir=d3,
                                         ckpt_every=3)))
        t = _trainer(TrainerConfig(total_steps=6, ckpt_dir=d3,
                                   ckpt_every=100))
    else:
        a = _trainer(TrainerConfig(total_steps=3, ckpt_dir=d0,
                                   ckpt_every=3))
        a.maybe_restore()
        assert a.step == 0
        np.testing.assert_allclose(_run(a), want[:3], rtol=1e-5)
        a.ckpt.wait()
        t = _jax_trainer(JTrainerConfig(total_steps=6, ckpt_dir=d0,
                                        ckpt_every=100))
    t.maybe_restore()
    assert t.step == 3
    np.testing.assert_allclose(_run(t), want[3:], rtol=1e-5)


def test_trainer_retries_after_failure(tmp_path):
    """The reference's case: a one-layer phi3 trainer warms its
    checkpoints, then a step fails once; the trainer restores and
    finishes."""
    tcfg = TrainerConfig(total_steps=4, ckpt_dir=str(tmp_path / "c"),
                         ckpt_every=1, max_retries=2)
    t = _trainer(tcfg, layers=1)
    real_step = t.train_step
    boom = {"armed": False}

    def flaky(state, batch):
        if boom["armed"]:
            boom["armed"] = False
            raise RuntimeError("injected node failure")
        return real_step(state, batch)

    t.train_step = flaky
    t.run()           # warms checkpoints
    boom["armed"] = True
    t.tcfg = dataclasses.replace(tcfg, total_steps=8)
    losses = _run(t)  # hits the failure, restores, finishes
    assert t.step == 8 and not boom["armed"]
    assert all(np.isfinite(losses))


def test_retry_with_nothing_committed_redraws_the_seed_init(tmp_path):
    """A step that fails after half-writing the live state, with no
    checkpoint yet: the trainer draws the seed's init afresh
    (``transform.fresh_state``) and retrains from step 1, ending on the
    uninterrupted run's state bit for bit."""
    ref = _trainer(TrainerConfig(total_steps=4), layers=1)
    _run(ref)
    t = _trainer(TrainerConfig(total_steps=4, ckpt_dir=str(tmp_path),
                               ckpt_every=100), layers=1)
    real_step, fired = t.train_step, []

    def poisoned(state, batch):
        if t.step == 2 and not fired:
            fired.append(1)
            with torch.no_grad():
                for p in state.params.values():
                    p.add_(1.0)
            raise RuntimeError("injected step failure")
        return real_step(state, batch)

    t.train_step = poisoned
    steps = []
    t.run(on_metrics=lambda s, m: steps.append(s))
    assert fired and steps == [1, 2, 1, 2, 3, 4]
    got, exp = _bits(t._canonical_state()), _bits(ref._canonical_state())
    for k, v in exp.items():
        assert (torch.equal(got[k], v) if isinstance(v, torch.Tensor)
                else got[k] == v), k
