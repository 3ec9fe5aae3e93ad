"""``ToyServer`` on gloo process meshes: the teacher-forced loop that serves
the recurrent families and seamless, run as the paged ``Server`` runs on a
mesh (slots over the batch axes, one host schedule on every rank with one
shared ``cache_len``, greedy tokens over the vocab shards, every block
tensor-parallel over ``model``).

Reduced rwkv6, hymba, parallax-lm and seamless at f32 on (1, 2) and
(2, 2), 5 prompts of 3 to 40 tokens through 4 slots (a request admitted
into a reused slot while the others decode), the parameters one device's
seeded draw with every constant leaf redrawn (so a rank's slice of a
replicated per-channel leaf is checked): every rank's greedy tokens equal
one device's ``ToyServer``'s, every decode step's logits within 1e-4 of
their scale, and each rank's carry at its share (the LSTM's ``c`` at H/M
units, the SSM state at D/M channels, the WKV state at H/M heads, the K/V
positions at S/M; seamless's cross K/V whole over ``model``). And
``launch/serve.py --engine toy --devices 4 --mesh 2x2`` serves 3
requests, every rank the same tokens.
"""
import numpy as np
import pytest
import torch

import _torch_recurrent_tp_ranks as R
import repro_torch.configs as tc
from repro_torch.launch import serve as serve_cli
from repro_torch.launch.mesh import spawn
from repro_torch.runtime.server import ServerConfig, ToyServer

pytestmark = pytest.mark.distributed

SEAMLESS = "seamless-m4t-medium"
ARCHS = (R.RWKV, R.HYMBA, R.LM, SEAMLESS)
MESHES = [(1, 2), (2, 2)]
CASES = [(m, a) for m in MESHES for a in ARCHS]
SCFG = dict(max_batch=4, max_seq=64)
LENS, NEW = (3, 17, 40, 8, 25), 4


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _params(arch: str) -> dict:
    """One device's seeded draw, every zeros / ones leaf redrawn around
    its constant."""
    sv = ToyServer(R.toy_cfg(arch), tc.RunConfig(**R.KW),
                   ServerConfig(**SCFG), device="cpu")
    rng = np.random.default_rng(3)
    out = {}
    for n, spec in sv.model.param_specs():
        a = sv.params[n].detach().numpy().copy()
        if spec.init in ("zeros", "ones"):
            a = a + 0.1 * rng.standard_normal(a.shape).astype(a.dtype)
        out[n] = a
    return out


def _prompts():
    rng = np.random.default_rng(4)
    return [rng.integers(1, 500, size=n).astype(np.int32).tolist()
            for n in LENS]


@pytest.fixture(scope="module")
def runs():
    named = {a: _params(a) for a in ARCHS}
    one = {a: R.toy_serve(a, named[a], SCFG, _prompts(), NEW)
           for a in ARCHS}
    out = {}
    for mesh in MESHES:
        ranks = spawn(R.toy_rank, mesh[0] * mesh[1], "gloo",
                      args=([(mesh, a) for a in ARCHS], named, SCFG,
                            _prompts(), NEW), timeout=600)
        for a in ARCHS:
            out[(mesh, a)] = [r[(mesh, a)] for r in ranks]
    return one, out


def _carry_shapes(arch: str, mesh) -> list:
    """Each cache tensor's shape on a rank of ``mesh``."""
    c = R.toy_cfg(arch)
    d, m = mesh
    b, s, L = SCFG["max_batch"] // d, SCFG["max_seq"], c.n_layers
    if arch == R.LM:
        return [(L, b, c.d_ff // m), (L, b, c.d_model)]
    if arch == R.RWKV:
        e = c.head_dim
        return [(L, b, c.d_model), (L, b, c.n_heads // m, e, e),
                (L, b, c.d_model)]
    kv = (L, b, s // m, c.n_kv_heads, c.head_dim)
    if arch == R.HYMBA:
        return [kv, kv, (L, b, c.d_model // m, c.ssm_state)]
    cross = (L, b, s // 4, c.n_kv_heads, c.head_dim)
    return [kv, kv, cross, cross]


@pytest.mark.parametrize("mesh,arch", CASES,
                         ids=["x".join(map(str, m)) + "-" + a
                              for m, a in CASES])
def test_toy_server_on_the_mesh_serves_as_one_device(runs, mesh, arch):
    one, out = runs
    want = one[arch]
    assert len(want["tokens"]) == len(LENS)
    assert all(len(t) == NEW for t in want["tokens"].values())
    for r in out[(mesh, arch)]:
        assert r["tokens"] == want["tokens"], (arch, r["tokens"])
        assert r["stats"] == want["stats"]
        assert len(r["logits"]) == len(want["logits"])
        for i, (a, b) in enumerate(zip(r["logits"], want["logits"])):
            scale = float(np.abs(b).max())
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4 * scale,
                                       err_msg=f"{arch} step {i}")
        assert r["cache"] == _carry_shapes(arch, mesh), r["cache"]


def test_one_device_carry_is_whole():
    for arch in ARCHS:
        assert [tuple(c.shape) for c in ToyServer(
            R.toy_cfg(arch), tc.RunConfig(**R.KW), ServerConfig(**SCFG),
            device="cpu").cache] == _carry_shapes(arch, (1, 1)), arch


def test_launcher_serves_the_toy_loop_on_a_2x2_mesh(capsys):
    """The launcher's default bf16: every rank serves the same 3
    requests and tokens (a bf16 near-tie may flip a token against one
    device's, so the f32 cases above hold the values)."""
    ranks = serve_cli.main(["--arch", "rwkv6-7b", "--engine", "toy",
                            "--requests", "3", "--max-new", "2",
                            "--max-seq", "32", "--devices", "4", "--mesh",
                            "2x2"], device="cpu")
    assert "spawning 4 ranks on a 2x2 mesh over gloo" in \
        capsys.readouterr().out
    assert len(ranks) == 4 and all(r == ranks[0] for r in ranks)
    assert len(ranks[0]) == 3 and all(len(t) == 2 for *_, t in ranks[0])
