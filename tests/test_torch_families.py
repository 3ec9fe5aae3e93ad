"""Every architecture of the zoo through the port, and the forward-only
kernels' guard.

  * The port's counterpart of tests/test_models_smoke.py over
    ``ALL_ARCHS + PAPER_ARCHS``, reduced, the reference smoke test's
    ``RunConfig(attention_impl="naive", remat="none")``: two training steps
    with finite losses, the first equal to the JAX package's from the same
    parameters within the bf16 bar rtol 2e-2 (the smoke test runs the
    default bf16); the prefill logits' shape and finiteness; one decode
    step against a small cache. The two moe archs (grok-1,
    llama4-maverick) are loss, prefill and decode cases like the others.
  * The moe archs through the paged engine against the JAX package's, at
    f32 from the same parameters: the bucket-padded prefill's logits
    (the pad tokens are routed too) within 1e-4 of their scale, and at
    most 2 of 8 greedy tokens different (the reference's allowance for
    argmax near-ties; the engines' decode steps route one token a slot).
  * Reduced grok-1 trains through ``launch/train.py`` and serves through
    ``launch/serve.py`` on the CPU.
  * ``ops.flash_route`` gives a route to every zoo config's full-width
    head dim, in bf16 and in f32, and the wrapper accepts it.
  * ``ops.flash_attention`` and ``ops.wkv`` refuse, on every device, an
    input that requires grad under autograd (on the card their outputs
    would carry no ``grad_fn``), and compute under ``torch.no_grad()``.
  * The training steps of the dense, moe, vlm, hybrid, ssm and audio
    families reach neither wrapper.
"""
import numpy as np
import pytest
import torch

import _torch_families as F
from repro.configs import ALL_ARCHS, PAPER_ARCHS
from repro.configs import RunConfig, ShapeConfig, get_config, reduced
from repro.core.transform import get_runner as jget_runner
from repro.runtime.server import Request as JRequest
from repro.runtime.server import Server as JServer
from repro.runtime.server import ServerConfig as JServerConfig
from repro.utils.tree import named_leaves
import repro_torch.configs as tc
from repro_torch.core.runtime import Runtime
from repro_torch.core.transform import get_runner, init_params_
from repro_torch.kernels import ops
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models.model import build_model
from repro_torch.runtime.server import Request, Server, ServerConfig
from repro_torch.weights import load_reference_params, to_numpy

MOE = ["grok-1-314b", "llama4-maverick-400b-a17b"]
RC = dict(attention_impl="naive", remat="none")
SHAPE = ("tiny", 32, 2, "train")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    yield from F.one_thread()


def _dataset(cfg):
    return F.dataset(cfg, SHAPE[1], SHAPE[2])


@pytest.mark.parametrize("arch", ALL_ARCHS + PAPER_ARCHS)
def test_train_step_smoke(arch):
    cfg = tc.reduced(tc.get_config(arch))
    jr = jget_runner(reduced(get_config(arch)), ShapeConfig(*SHAPE),
                     RunConfig(**RC), seed=0)
    named = {n: np.asarray(a) for n, a in named_leaves(jr.state.params)}
    runner = get_runner(cfg, tc.ShapeConfig(*SHAPE), tc.RunConfig(**RC),
                        device="cpu", params=load_reference_params(named,
                                                                   "cpu"))
    ds = _dataset(cfg)
    m = runner.run(ds.batch(0))
    want = float(jr.run(ds.batch(0))["loss"])
    assert np.isfinite(float(m["loss"])), (arch, m)
    np.testing.assert_allclose(float(m["loss"]), want, rtol=2e-2)
    m = runner.run(ds.batch(1))
    assert np.isfinite(float(m["loss"])), (arch, m)


def _model(arch, kind="train", seq=SHAPE[1]):
    cfg = tc.reduced(tc.get_config(arch))
    rt = Runtime(cfg, tc.RunConfig(**RC), tc.ShapeConfig("t", seq, SHAPE[2],
                                                         kind),
                 device="cpu")
    model = build_model(cfg, rt)
    init_params_(model, 0)
    return cfg, model


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_forward_shapes(arch):
    cfg, model = _model(arch)
    batch = F.tensors(_dataset(cfg).batch(0))
    logits, _, _ = model.prefill_fn(batch)
    assert logits.shape[0] == SHAPE[2] and logits.shape[1] == SHAPE[1]
    assert logits.shape[2] >= cfg.vocab_size
    assert bool(torch.isfinite(logits.float()).all()), arch


@pytest.mark.parametrize("arch", ["phi3-medium-14b", "rwkv6-7b",
                                  "hymba-1.5b", "grok-1-314b",
                                  "llama4-maverick-400b-a17b",
                                  "seamless-m4t-medium", "chameleon-34b"])
def test_decode_step_smoke(arch):
    """One decode step against a small cache: shapes, finiteness, the
    cache's structure kept."""
    _, model = _model(arch, "decode")
    cache = model.init_cache(2, 32)
    shapes = [tuple(c.shape) for c in cache]
    logits, new_cache = model.decode_fn(
        cache, torch.zeros((2, 1), dtype=torch.int32), 3)
    assert tuple(logits.shape[:2]) == (2, 1)
    assert bool(torch.isfinite(logits.float()).all()), arch
    assert [tuple(c.shape) for c in new_cache] == shapes


@pytest.mark.parametrize("arch", ALL_ARCHS + PAPER_ARCHS)
def test_flash_route_covers_every_zoo_head_dim(arch):
    """Every full-width head dim of the zoo has a kernel on each route
    ``ops.flash_route`` names: bf16 on the tensor cores where the head is
    64, 128 or 160 wide, f32 on the scalar kernel."""
    cfg = tc.get_config(arch)
    if cfg.family in ("lstm", "ssm"):
        return                        # no attention: nothing to route
    d = cfg.head_dim
    assert d in ops._FLASH_DIMS, (arch, d)
    assert ops.flash_route(torch.float32, d) == "scalar"
    assert ops.flash_route(torch.bfloat16, d) == (
        "tc" if d in (64, 128, 160) else "scalar")
    q = torch.randn((1, 3, 2, d))
    out = ops.flash_attention(q, q, q)
    assert out.shape == q.shape


def _wkv_args(requires_grad: bool):
    g = torch.Generator().manual_seed(0)
    r, k, v = (torch.randn((1, 5, 2, 16), generator=g) for _ in range(3))
    lw = -torch.rand((1, 5, 2, 16), generator=g)
    return [r.requires_grad_(requires_grad), k, v, lw,
            torch.zeros((2, 16)), torch.zeros((1, 2, 16, 16))]


@pytest.mark.parametrize("kernel", ["flash_attention", "wkv"])
def test_forward_only_kernels_refuse_inputs_that_require_grad(kernel):
    if kernel == "flash_attention":
        q = torch.randn((1, 4, 2, 16), requires_grad=True)
        call = lambda: ops.flash_attention(q, q.detach(), q.detach())
        route = "naive' or 'chunked"
    else:
        args = _wkv_args(True)
        call = lambda: ops.wkv(*args)
        route = "chunk_wkv"
    with pytest.raises(RuntimeError, match=f"forward-only.*{route}"):
        call()
    with torch.no_grad():
        out = call()
    assert not (out if kernel == "flash_attention" else out[0]).requires_grad
    if kernel == "wkv":           # nothing requires grad: computed as before
        assert ops.wkv(*_wkv_args(False))[0].shape == (1, 5, 2, 16)


@pytest.mark.parametrize("arch", ["phi3-medium-14b", "chameleon-34b",
                                  "hymba-1.5b", "rwkv6-7b",
                                  "seamless-m4t-medium", "grok-1-314b",
                                  "llama4-maverick-400b-a17b"])
def test_training_steps_never_reach_the_forward_only_kernels(arch,
                                                             monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError(f"a training step of {arch} reached a "
                             "forward-only kernel")

    monkeypatch.setattr(ops, "flash_attention", refuse)
    monkeypatch.setattr(ops, "wkv", refuse)
    for impl in ("naive", "chunked"):
        cfg = tc.reduced(tc.get_config(arch))
        runner = get_runner(cfg, tc.ShapeConfig(*SHAPE),
                            tc.RunConfig(attention_impl=impl), device="cpu")
        assert np.isfinite(float(runner.run(_dataset(cfg).batch(0))["loss"]))


@pytest.mark.parametrize("arch", MOE)
def test_moe_engine_matches_reference(arch):
    """The paged engine on reduced ``arch`` at f32, the JAX package's and
    the port's from the same parameters: one prompt's bucket-padded
    prefill logits (13 tokens in a 16-token bucket: the 3 pad tokens are
    routed and raise the capacity, as in the reference) within 1e-4 of
    their scale; then three requests of 8 greedy tokens through two slots,
    at most 2 of 8 tokens different in each."""
    scfg = dict(max_batch=2, max_seq=32)
    rc = dict(RC, param_dtype="float32", compute_dtype="float32")
    jsv = JServer(reduced(get_config(arch)), RunConfig(**rc),
                  JServerConfig(**scfg), seed=0)
    named = {n: np.asarray(a) for n, a in named_leaves(jsv.params)}
    sv = Server(tc.reduced(tc.get_config(arch)), tc.RunConfig(**rc),
                ServerConfig(**scfg), device="cpu",
                params=load_reference_params(named, "cpu"))
    prompts = F.prompts([13, 5, 9], 100)
    toks = np.zeros((1, 16), np.int32)
    toks[0, :13] = prompts[0]
    jl, _ = jsv.model.prefill_cache_fn(jsv.params, toks)
    tl, _ = sv.model.prefill_cache_fn(torch.from_numpy(toks))
    scale = float(np.abs(np.asarray(jl)).max())
    np.testing.assert_allclose(to_numpy(tl), np.asarray(jl), rtol=1e-4,
                               atol=1e-4 * scale)
    for server, req in ((jsv, JRequest), (sv, Request)):
        for i, p in enumerate(prompts):
            server.submit(req(i, p, max_new_tokens=8))
        server.run_until_drained()
        server.close()
    want = {r.uid: r.out_tokens for r in jsv.completed}
    got = {r.uid: r.out_tokens for r in sv.completed}
    assert sorted(got) == sorted(want)
    for uid, out in got.items():
        differ = sum(a != b for a, b in zip(out, want[uid]))
        assert len(out) == 8 and differ <= 2, (uid, out, want[uid])
    assert sv.stats["cross_slot_mismatches"] == 0


def test_launchers_train_and_serve_grok_on_the_cpu(capsys):
    rec = launch_train.main(["--arch", "grok-1-314b", "--reduced", "--seq",
                             "32", "--batch", "4", "--steps", "3",
                             "--log-every", "1"], device="cpu")
    assert len(rec["losses"]) == 3
    assert all(np.isfinite(rec["losses"]))
    assert all(h["moe_dropped"] >= 0 for h in rec["history"])
    done = launch_serve.main(["--arch", "grok-1-314b", "--requests", "3",
                              "--max-new", "4"], device="cpu")
    assert len(done) == 3 and all(len(r.out_tokens) == 4 for r in done)
    assert "[paged] served 3 requests" in capsys.readouterr().out
