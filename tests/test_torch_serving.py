"""The port's serving engine (runtime/server.py) against the JAX package's:
the same parameters and prompts give the same greedy tokens; the bucket
helpers, slot reuse, the per-bucket first-call count, the refusal of
recurrent families, the serve pricing and the serve-time plan match the
reference. Reduced phi3-medium-14b at f32, sequences of 32 or less; the
toy loop also on reduced rwkv6."""
import numpy as np
import pytest
import torch

from repro.configs import RunConfig, ShapeConfig, get_config, reduced
from repro.core import cost_model as jcm
from repro.runtime.server import Request as JRequest
from repro.runtime.server import Server as JServer
from repro.runtime.server import ServerConfig as JServerConfig
from repro.utils.tree import named_leaves
import repro_torch.configs as tc
from repro_torch.core import cost_model as tcm
from repro_torch.core.runtime import Runtime
from repro_torch.launch import serve as serve_cli
from repro_torch.runtime.server import (Request, Server, ServerConfig,
                                        ToyServer, bucket_len,
                                        prefill_buckets)
from repro_torch.weights import load_reference_params

F32 = dict(param_dtype="float32", compute_dtype="float32")


def _cfg(layers=2):
    return tc.reduced(tc.get_config("phi3-medium-14b"), layers=layers)


def _prompts(lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 100, size=n).astype(np.int32) for n in lens]


def _serve(sv, prompts, new=6):
    for i, p in enumerate(prompts):
        sv.submit(Request(i, p, max_new_tokens=new))
    sv.run_until_drained()
    sv.close()
    return {r.uid: r.out_tokens for r in sv.completed}


@pytest.mark.parametrize("impl", ["naive", "pallas"])
def test_engine_greedy_tokens_match_reference(impl):
    """Concurrent mixed-length requests, two slots, one slot reused: the
    port's engine emits the reference engine's greedy tokens."""
    scfg = dict(max_batch=2, max_seq=32)
    prompts = _prompts([4, 9, 6])
    jsv = JServer(reduced(get_config("phi3-medium-14b")),
                  RunConfig(attention_impl=impl, **F32),
                  JServerConfig(**scfg), seed=0)
    for i, p in enumerate(prompts):
        jsv.submit(JRequest(i, p, max_new_tokens=6))
    jsv.run_until_drained()
    jsv.close()
    want = {r.uid: r.out_tokens for r in jsv.completed}
    named = {n: np.asarray(a) for n, a in named_leaves(jsv.params)}
    sv = Server(_cfg(), tc.RunConfig(attention_impl=impl, **F32),
                ServerConfig(**scfg), device="cpu",
                params=load_reference_params(named, "cpu"))
    got = _serve(sv, prompts)
    assert got == want
    for k in ("prefill_calls", "prefill_traces", "decode_traces",
              "buckets", "cross_slot_mismatches"):
        assert sv.stats[k] == jsv.stats[k], k


def test_bucket_helpers():
    assert [bucket_len(n, 64) for n in (1, 8, 9, 16, 17, 40, 63)] == \
        [8, 8, 16, 16, 32, 64, 64]
    assert prefill_buckets(64) == [8, 16, 32, 64]
    assert prefill_buckets(8) == [8]
    assert prefill_buckets(2048)[-2:] == [1024, 2048]


def test_same_bucket_prompts_share_one_first_call():
    """Two same-bucket prompts cost two prefill calls but one first call
    of that shape (the reference's one trace)."""
    sv = Server(_cfg(layers=1), tc.RunConfig(attention_impl="naive"),
                ServerConfig(max_batch=2, max_seq=32), device="cpu")
    out = _serve(sv, _prompts([5, 7, 20]), new=3)   # buckets 8, 8, 32
    assert sv.stats["prefill_calls"] == 3
    assert sv.stats["buckets"] == {8, 32}
    assert sv.stats["prefill_traces"] == 2
    assert sv.stats["decode_traces"] == 1
    assert all(len(t) == 3 for t in out.values())


def test_slot_reuse_equals_a_fresh_server():
    """A request admitted into a freed slot whose cache still holds a longer
    previous tenant's rows decodes exactly as on a fresh server."""
    rc = tc.RunConfig(attention_impl="pallas", **F32)
    scfg = ServerConfig(max_batch=2, max_seq=32)
    sv = Server(_cfg(layers=1), rc, scfg, device="cpu")
    long_a, long_b, short = _prompts([20, 12, 5])
    sv.submit(Request(0, long_a, max_new_tokens=4))
    sv.submit(Request(1, long_b, max_new_tokens=4))
    sv.run_until_drained()
    r = Request(2, short, max_new_tokens=8)
    sv.submit(r)
    sv.run_until_drained()
    sv.close()
    fresh = Server(_cfg(layers=1), rc, scfg, device="cpu", params=sv.params)
    ref = Request(2, short, max_new_tokens=8)
    fresh.submit(ref)
    fresh.run_until_drained()
    fresh.close()
    assert r.out_tokens == ref.out_tokens
    assert sv.stats["cross_slot_mismatches"] == 0
    assert sv.stats["prefill_calls"] == 3


def test_engine_matches_toy_server_drained_one_at_a_time():
    rc = tc.RunConfig(attention_impl="naive", **F32)
    scfg = ServerConfig(max_batch=2, max_seq=32)
    eng = Server(_cfg(layers=1), rc, scfg, device="cpu", seed=3)
    prompts = _prompts([4, 9, 6], seed=1)
    a = _serve(eng, prompts)
    toy = ToyServer(_cfg(layers=1), rc, scfg, device="cpu",
                    params=eng.params)
    for i, p in enumerate(prompts):
        toy.submit(Request(i, p, max_new_tokens=6))
        toy.run_until_drained()
    b = {r.uid: r.out_tokens for r in toy.completed}
    assert a == b


def test_temperature_sampling_is_seeded_and_in_range():
    scfg = ServerConfig(max_batch=2, max_seq=32, greedy=False,
                        temperature=0.7)
    outs = []
    for _ in range(2):
        sv = Server(_cfg(layers=1), tc.RunConfig(attention_impl="naive"),
                    scfg, device="cpu", seed=5)
        outs.append(_serve(sv, _prompts([6]), new=8))
    assert outs[0] == outs[1]
    (toks,) = outs[0].values()
    assert len(toks) == 8 and all(0 <= t < 512 for t in toks)


def test_recurrent_families_are_refused():
    """The lstm and rwkv6 LMs are ported but have no positional KV cache:
    the engine refuses both with the reference's ValueError naming
    ToyServer."""
    rc = tc.RunConfig()
    for arch in ("parallax-lm", "rwkv6-7b"):
        with pytest.raises(ValueError, match="ToyServer"):
            Server(tc.reduced(tc.get_config(arch), layers=1), rc,
                   ServerConfig(max_batch=2, max_seq=16), device="cpu")


def test_toy_server_greedy_tokens_match_reference_on_rwkv6():
    """Reduced rwkv6 at f32, two slots, three requests: the third is
    admitted into a reused slot while the other slot decodes, so admission
    during decode (the other slot stepping with token 0) and a carry that
    is not reset are covered, as the reference does them."""
    from repro.runtime.server import ToyServer as JToyServer
    scfg = dict(max_batch=2, max_seq=32)
    prompts = _prompts([4, 9, 6], seed=2)
    jsv = JToyServer(reduced(get_config("rwkv6-7b")), RunConfig(**F32),
                     JServerConfig(**scfg), seed=0)
    for i, p in enumerate(prompts):
        jsv.submit(JRequest(i, p, max_new_tokens=6))
    jsv.run_until_drained()
    want = {r.uid: r.out_tokens for r in jsv.completed}
    named = {n: np.asarray(a) for n, a in named_leaves(jsv.params)}
    sv = ToyServer(tc.reduced(tc.get_config("rwkv6-7b")), tc.RunConfig(**F32),
                   ServerConfig(**scfg), device="cpu",
                   params=load_reference_params(named, "cpu"))
    for i, p in enumerate(prompts):
        sv.submit(Request(i, p, max_new_tokens=6))
    sv.run_until_drained()
    assert {r.uid: r.out_tokens for r in sv.completed} == want
    assert sv.stats == jsv.stats
    assert [r.uid for r in sv.completed] == [r.uid for r in jsv.completed]


def test_toy_server_for_rwkv6_defaults_to_the_card():
    """Without a device the rwkv6 ToyServer's runtime is the card's (its
    parameters are allocated there, so only the runtime is built here)."""
    rt = Runtime(tc.reduced(tc.get_config("rwkv6-7b"), layers=1),
                 tc.RunConfig(), tc.ShapeConfig("serve", 16, 2, "decode"))
    assert rt.device == torch.device("cuda")


def test_toy_server_serves_the_lstm_family():
    sv = ToyServer(tc.reduced(tc.get_config("parallax-lm")),
                   tc.RunConfig(**F32), ServerConfig(max_batch=2, max_seq=16),
                   device="cpu")
    for i, p in enumerate(_prompts([3, 5])):
        sv.submit(Request(i, p, max_new_tokens=4))
    done = sv.run_until_drained()
    assert sorted(len(r.out_tokens) for r in done) == [4, 4]


@pytest.mark.parametrize("arch,batch", [("phi3-medium-14b", 4),
                                        ("parallax-lm", 8),
                                        ("command-r-35b", 2)])
def test_serve_plan_tables_match_reference(arch, batch):
    """``analyze()`` at a decode ShapeConfig: the same per-table plan,
    serve pricing included."""
    from repro.core.runtime import Runtime as JRuntime
    from repro.core.transform import analyze as janalyze
    from repro.models.model import build_model as jbuild
    from repro_torch.core.transform import analyze
    from repro_torch.models.model import build_model
    jcfg = reduced(get_config(arch))
    jrt = JRuntime(jcfg, RunConfig(), ShapeConfig("serve", 32, batch,
                                                  "decode"))
    want = janalyze(jbuild(jcfg, jrt), jrt).tables()
    trt = Runtime(tc.reduced(tc.get_config(arch)), tc.RunConfig(),
                  tc.ShapeConfig("serve", 32, batch, "decode"), device="cpu")
    got = analyze(build_model(trt.model_cfg, trt), trt).tables()
    assert got == want
    assert all(t["serve"] is not None for t in got.values())


@pytest.mark.parametrize("method", ["ps", "ps_gather", "allreduce",
                                    "mpi_gatherv", "dense"])
@pytest.mark.parametrize("model,data", [(4, 2), (1, 8), (2, 1)])
def test_serve_pricing_matches_reference(method, model, data):
    jd = jcm.MeshDims(model=model, data=data, pod=1, hosts=1)
    td = tcm.MeshDims(model=model, data=data, pod=1, hosts=1)
    assert tcm.serve_pull_bytes(1024.0, 0.1, method, td) == \
        jcm.serve_pull_bytes(1024.0, 0.1, method, jd)
    assert tcm.serve_pull_messages(method, td) == \
        jcm.serve_pull_messages(method, jd)
    got = tcm.serve_table_pricing(b=1024.0, alpha=0.1, method=method,
                                  dims=td, batch_tokens=8)
    want = jcm.serve_table_pricing(b=1024.0, alpha=0.1, method=method,
                                   dims=jd, batch_tokens=8)
    assert got.keys() == want.keys()
    for k in got:            # the H100 record's link constants vs the TPU's
        assert (got[k] == 0.0) == (want[k] == 0.0), k
    assert got["pull_bytes"] == want["pull_bytes"]


def test_decode_runtime_disables_census():
    cfg = _cfg(layers=1)
    serve = Runtime(cfg, tc.RunConfig(), tc.ShapeConfig("s", 64, 4, "decode"),
                    device="cpu")
    train = Runtime(cfg, tc.RunConfig(), tc.ShapeConfig("t", 64, 4, "train"),
                    device="cpu")
    assert serve.embed_ctx().census is False
    assert train.embed_ctx().census is True


def test_server_defaults_to_the_card():
    rt = Runtime(_cfg(layers=1), tc.RunConfig(),
                 tc.ShapeConfig("s", 8, 2, "decode"))
    assert rt.device == torch.device("cuda")


@pytest.mark.parametrize("engine", ["paged", "toy"])
def test_launcher_serves_on_the_cpu(engine, capsys):
    done = serve_cli.main(["--requests", "3", "--max-new", "2",
                           "--max-seq", "32", "--engine", engine],
                          device="cpu")
    assert len(done) == 3 and all(len(r.out_tokens) == 2 for r in done)
    assert f"[{engine}] served 3 requests" in capsys.readouterr().out
    # both engines serve on a process mesh: every rank the same requests
    ranks = serve_cli.main(["--requests", "3", "--max-new", "2",
                            "--max-seq", "32", "--engine", engine,
                            "--devices", "2", "--mesh", "1x2"],
                           device="cpu")
    assert len(ranks) == 2 and ranks[0] == ranks[1]
    assert len(ranks[0]) == 3 and all(len(t) == 2 for *_, t in ranks[0])


def test_launcher_serves_rwkv6_through_the_toy_loop(capsys):
    """``--arch rwkv6-7b --engine toy`` serves; the default paged engine
    refuses the recurrent family as the reference's does."""
    done = serve_cli.main(["--arch", "rwkv6-7b", "--engine", "toy",
                           "--requests", "3", "--max-new", "2",
                           "--max-seq", "32"], device="cpu")
    assert len(done) == 3 and all(len(r.out_tokens) == 2 for r in done)
    assert "[toy] served 3 requests" in capsys.readouterr().out
    with pytest.raises(ValueError, match="ToyServer"):
        serve_cli.main(["--arch", "rwkv6-7b", "--requests", "1"],
                       device="cpu")


def test_plain_prefill_and_decode_steps_match_the_model():
    """``make_prefill_step`` / ``make_decode_step`` (the toy loop's steps)
    return what the model's prefill and decode functions return."""
    from repro_torch.core.transform import make_decode_step, make_prefill_step
    sv = ToyServer(_cfg(layers=1), tc.RunConfig(**F32),
                   ServerConfig(max_batch=2, max_seq=16), device="cpu")
    toks = torch.from_numpy(np.stack(_prompts([6, 6])))
    logits, cache = make_prefill_step(sv.model, sv.rt, sv.plan)(
        {"tokens": toks})
    want, _ = sv.model.prefill_cache_fn(toks)
    assert cache is None and torch.equal(logits, want)
    step = make_decode_step(sv.model, sv.rt, sv.plan)
    c = sv.model.init_cache(2, 16)
    for i in range(6):
        lg, c = step(c, toks[:, i:i + 1], i)
    torch.testing.assert_close(lg[:, 0], want[:, -1], rtol=1e-5, atol=1e-5)
