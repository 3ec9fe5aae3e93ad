"""The port's serving benchmark (repro_torch/benchmarks/serve_bench.py)
and its batched-serving example on the CPU.

``serve_bench`` at ``full=False`` (the reference's reduced phi3: 2 layers,
vocab 512, ``ServerConfig(4, 128)``, naive attention) meets the
reference's five asserts: one prefill call a request at each load, a
finite p99 TTFT, the engine faster than the toy loop, no token crossing
slots, one prefill trace a length bucket. At f32 on the JAX package's
weights, the bench's greedy tokens at every load equal the JAX package's
``Server``'s, and the toy loop's its ``ToyServer``'s, on the reference's
own ``benchmarks/serve_bench.py`` workload. ``examples/serve_batched.py``
serves its 12 requests."""
import numpy as np
import pytest
import torch

from repro.configs import RunConfig, get_config, reduced
from repro.runtime.server import Request as JRequest
from repro.runtime.server import Server as JServer
from repro.runtime.server import ServerConfig as JServerConfig
from repro.runtime.server import ToyServer as JToyServer
from repro.utils.tree import named_leaves
import repro_torch.configs as tc
from repro_torch.benchmarks import serve_bench
from repro_torch.examples import serve_batched
from repro_torch.weights import load_reference_params

F32 = dict(param_dtype="float32", compute_dtype="float32")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_serve_bench_reduced_meets_the_reference_asserts():
    res = serve_bench.run("cpu", full=False)
    serve_bench.check(res)
    assert res["loads"] == [2, 6, 12] and not res["full"]
    for n, r in res["engine"].items():
        assert r["requests"] == int(n)
        assert r["tokens"] == int(n) * serve_bench.MAX_NEW
        assert r["ttft_s"]["p50"] <= r["ttft_s"]["p99"]
    assert res["stats"]["buckets"] == [8, 16, 32, 64]
    assert res["speedup_vs_toy"] > 1.0


def _jax_tokens(jsv, prompts) -> list:
    reqs = [JRequest(i, p, max_new_tokens=serve_bench.MAX_NEW)
            for i, p in enumerate(prompts)]
    for r in reqs:
        jsv.submit(r)
    jsv.run_until_drained()
    return [list(map(int, r.out_tokens)) for r in reqs]


def test_serve_bench_tokens_equal_jax_server_at_f32():
    jcfg = reduced(get_config("phi3-medium-14b"), layers=2, vocab=512)
    jsv = JServer(jcfg, RunConfig(attention_impl="naive", **F32),
                  JServerConfig(max_batch=4, max_seq=128), seed=0)
    _jax_tokens(jsv, serve_bench._workload(4, seed=123))
    want = {n: _jax_tokens(jsv, serve_bench._workload(n))
            for n in serve_bench.LOADS}
    jsv.close()
    jtoy = JToyServer(jcfg, RunConfig(attention_impl="naive", **F32),
                      JServerConfig(max_batch=4, max_seq=128),
                      params=jsv.params, seed=0)
    _jax_tokens(jtoy, serve_bench._workload(2, seed=123))
    want_toy = _jax_tokens(jtoy, serve_bench._workload(
        max(serve_bench.LOADS)))
    named = {n: np.asarray(a) for n, a in named_leaves(jsv.params)}
    res = serve_bench.run(
        "cpu", full=False,
        cfg=tc.reduced(tc.get_config("phi3-medium-14b"), layers=2,
                       vocab=512),
        run_cfg=tc.RunConfig(attention_impl="naive", **F32),
        params=load_reference_params(named, "cpu"))
    for n in serve_bench.LOADS:
        assert res["engine"][str(n)]["out_tokens"] == want[n], n
    # the toy loop, its slots' carries not reset between requests as in
    # the reference's: the JAX package's toy loop's tokens
    assert res["toy"]["out_tokens"] == want_toy


def test_serve_batched_example_serves_twelve_requests(capsys):
    done = serve_batched.main(device="cpu")
    assert len(done) == 12
    assert all(len(r.out_tokens) == 16 for r in done)
    out = capsys.readouterr().out
    assert "served 12 requests / 192 tokens" in out
    assert "12 prefill dispatches" in out
