"""Shared helpers of the slice-6 family tests (tests/test_torch_{encdec,
hybrid,vlm,rwkv_train,families}.py): the reference model with its seeded
init and the port's model holding the same parameters, one batch for both,
the loss and every gradient on each side, the ToyServer's greedy tokens on
each side. They import both packages (test code only)."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import RunConfig, ShapeConfig, get_config, reduced
from repro.core.runtime import Runtime as JRuntime
from repro.core.transform import analyze as janalyze
from repro.data import SyntheticLM
from repro.models.model import build_model as jbuild
from repro.runtime.server import Request as JRequest
from repro.runtime.server import ServerConfig as JServerConfig
from repro.runtime.server import ToyServer as JToyServer
from repro.utils.tree import named_leaves
import repro_torch.configs as tc
from repro_torch.core.runtime import Runtime
from repro_torch.core.transform import analyze, load_params_
from repro_torch.models.model import build_model
from repro_torch.runtime.server import Request, ServerConfig, ToyServer
from repro_torch.utils.tree import named_parameters
from repro_torch.weights import load_reference_params, to_numpy

SEQ, BATCH = 32, 4
# f32 end to end (the wire too), the reference correctness test's plain
# attention and no remat
F32 = dict(param_dtype="float32", compute_dtype="float32",
           wire_dtype="float32", attention_impl="naive", remat="none")
# f32 products in another summation order (torch's CPU GEMM against XLA's)
TOL = dict(rtol=1e-5, atol=1e-6)


def one_thread():
    """A module fixture's body: one intra-op thread beside the other test
    workers, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def dataset(cfg, seq=SEQ, batch=BATCH, seed=0) -> SyntheticLM:
    """The reference smoke test's data: ``frames`` (B, seq // 4, d) for the
    audio family."""
    audio = cfg.family == "audio"
    return SyntheticLM(cfg.vocab_size, seq, batch, seed=seed,
                       is_encdec=cfg.is_encdec,
                       frames_dim=cfg.d_model if audio else 0,
                       frames_len=max(seq // 4, 1))


def pair(arch: str, kw: dict = F32, seq=SEQ, batch=BATCH, kind="train",
         draw=None):
    """(reference model, its params, port model, {name: numpy}) with the
    same parameters. ``draw``: {name suffix: (scale, offset)} of parameters
    redrawn from a seed (those the init leaves constant)."""
    jcfg = reduced(get_config(arch))
    jrt = JRuntime(jcfg, RunConfig(**kw), ShapeConfig("t", seq, batch, kind))
    jm = jbuild(jcfg, jrt)
    jrt.plan = janalyze(jm, jrt)
    jp = jm.init(jax.random.key(0))
    named = {n: np.asarray(a) for n, a in named_leaves(jp)}
    if draw:
        rng = np.random.default_rng(1)
        for n, a in named.items():
            for suffix, (scale, off) in draw.items():
                if n.endswith(suffix):
                    named[n] = np.asarray(jnp.asarray(
                        rng.standard_normal(a.shape).astype(np.float32)
                        * scale + off).astype(a.dtype))
        order = [n for n, _ in named_leaves(jp)]
        jp = jax.tree_util.tree_unflatten(
            jax.tree_util.tree_structure(jp),
            [jnp.asarray(named[n]) for n in order])
    tm = port_model(arch, kw, seq, batch, kind)
    load_params_(tm, load_reference_params(named, "cpu"))
    return jm, jp, tm, named


def port_model(arch: str, kw: dict = F32, seq=SEQ, batch=BATCH,
               kind="train"):
    cfg = tc.reduced(tc.get_config(arch))
    rt = Runtime(cfg, tc.RunConfig(**kw), tc.ShapeConfig("t", seq, batch,
                                                         kind),
                 device="cpu")
    tm = build_model(cfg, rt)
    rt.plan = analyze(tm, rt)
    return tm


def tensors(batch: dict) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


def loss_and_grads(model, batch: dict) -> tuple:
    for p in model.parameters():
        p.grad = None
    loss, metrics = model.loss_fn(batch)
    loss.backward()
    return loss.detach(), metrics, {n: p.grad.clone() for n, p in
                                    named_parameters(model).items()}


def check_loss_and_grads(jm, jp, tm, batch: dict, *, loss_rtol=1e-5,
                         grad_tol=TOL) -> None:
    """The reference's loss, xent, census and every gradient against the
    port's, from the same parameters and batch."""
    assert list(named_parameters(tm)) == [n for n, _ in named_leaves(jp)]
    (jloss, jmet), jgrads = jax.value_and_grad(jm.loss_fn, has_aux=True)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, metrics, grads = loss_and_grads(tm, tensors(batch))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=loss_rtol)
    np.testing.assert_allclose(float(metrics["xent"]), float(jmet["xent"]),
                               rtol=loss_rtol)
    for k in ("embed_rows", "embed_unique", "embed_dropped"):
        assert float(metrics[k]) == float(jmet[k]), k
    for n, g in named_leaves(jgrads):
        np.testing.assert_allclose(to_numpy(grads[n]), np.asarray(g),
                                   err_msg=n, **grad_tol)


def prompts(lens, vocab: int, seed=0) -> list:
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, size=n).astype(np.int32) for n in lens]


def toy_tokens(arch: str, kw: dict, lens, new=6, max_batch=2, max_seq=32):
    """Greedy tokens and stats of the reference's ToyServer and the port's
    from the same parameters: two slots, so a request is admitted into a
    reused slot while the other decodes."""
    jcfg = reduced(get_config(arch))
    ps = prompts(lens, min(jcfg.vocab_size, 100), seed=2)
    jsv = JToyServer(jcfg, RunConfig(**kw),
                     JServerConfig(max_batch=max_batch, max_seq=max_seq),
                     seed=0)
    for i, p in enumerate(ps):
        jsv.submit(JRequest(i, p, max_new_tokens=new))
    jsv.run_until_drained()
    named = {n: np.asarray(a) for n, a in named_leaves(jsv.params)}
    sv = ToyServer(tc.reduced(tc.get_config(arch)), tc.RunConfig(**kw),
                   ServerConfig(max_batch=max_batch, max_seq=max_seq),
                   device="cpu", params=load_reference_params(named, "cpu"))
    for i, p in enumerate(ps):
        sv.submit(Request(i, p, max_new_tokens=new))
    sv.run_until_drained()
    return ({r.uid: r.out_tokens for r in jsv.completed}, jsv.stats,
            {r.uid: r.out_tokens for r in sv.completed}, sv.stats)
