"""The serve mesh: the paged ``Server`` on gloo process meshes, (2, 2) and
(1, 4), for reduced phi3-medium-14b and command-r-35b (the tied head) at
f32, ``max_seq`` 64, prompts of 2 to 40 tokens, so that positions cross
the boundaries between the ranks' blocks of the decode cache.

The same script of admissions and decode steps drives the engine's own
prefill and decode steps on the mesh, on one device in the port and, for
the JAX package, through its model's ``prefill_cache_fn`` / ``decode_fn``
with the engine's cache insertion. The prefill and decode logits (gathered
over the vocab shards and the data ranks) must lie within rtol 1e-4 of the
one-device port's and of the JAX package's (scaled by the logits' largest
magnitude: the tensor-parallel products and the sequence-sharded merge sum
in another order), the greedy tokens must be equal, and a fresh engine's
drained tokens must equal the one-device engines' and the JAX package's
``Server`` on a (2, 2) mesh of fake devices. Each rank's cache is
(n_layers, B/D, S/M, KV, hd); a slot whose prompt lies wholly on other
ranks' blocks leaves a rank with no valid position, and its output stays
finite. ``launch/serve.py --devices 4 --mesh 2x2`` serves on the CPU.
"""
import numpy as np
import pytest

import _torch_tp_ranks as R
from conftest import distributed_run
from repro.configs import RunConfig, get_config, reduced
from repro.runtime.server import Request as JRequest
from repro.runtime.server import Server as JServer
from repro.runtime.server import ServerConfig as JServerConfig
from repro.utils.tree import named_leaves
import repro_torch.configs as tc
from repro_torch.launch import serve as serve_cli
from repro_torch.launch.mesh import spawn
from repro_torch.runtime.server import Request, Server, ServerConfig
from repro_torch.weights import load_reference_params

pytestmark = pytest.mark.distributed

PHI3, COMMAND_R = "phi3-medium-14b", "command-r-35b"
SCFG = dict(max_batch=4, max_seq=64)
MESHES = ((2, 2), (1, 4))
RTOL = 1e-4
NEW = 5


def _prompt(n: int, seed: int) -> list:
    return np.random.default_rng(seed).integers(1, 500, n).tolist()


# slot 0 holds 3 positions (on the first rank's block only), slot 2 crosses
# into the second (and, at 16 positions a rank, the third) block
SCRIPT = [("prefill", 0, _prompt(3, 1)), ("prefill", 2, _prompt(37, 2)),
          ("decode", (0, 2)), ("decode", (0, 2)), ("decode", (0, 2)),
          ("prefill", 1, _prompt(20, 3)),
          ("decode", (0, 1, 2)), ("decode", (0, 1, 2)),
          ("prefill", 3, _prompt(9, 4)),
          *[("decode", (0, 1, 2, 3))] * 4]
PROMPTS = [_prompt(n, 10 + i) for i, n in enumerate((2, 17, 33, 40, 9, 25))]


def _jax_drive(jsv, script) -> dict:
    """``R.drive`` on the JAX package's model: its prefill_cache_fn and
    decode_fn with the engine's insertion and greedy bookkeeping."""
    import jax
    import jax.numpy as jnp
    model, params = jsv.model, jsv.params
    prefill, decode = jax.jit(model.prefill_cache_fn), jax.jit(model.decode_fn)
    b, s = SCFG["max_batch"], SCFG["max_seq"]
    cache = model.init_cache(b, s)
    lens = jnp.zeros((b,), jnp.int32)
    tok = jnp.zeros((b, 1), jnp.int32)
    out = {"prefill": {}, "decode": [], "tokens": []}
    for op in script:
        if op[0] == "prefill":
            _, slot, prompt = op
            lb = 8
            while lb < len(prompt):
                lb *= 2
            padded = np.zeros((1, lb), np.int32)
            padded[0, :len(prompt)] = prompt
            logits, kv = prefill(params, jnp.asarray(padded))
            cache = tuple(c.at[:, slot, :lb].set(p[:, 0].astype(c.dtype))
                          for c, p in zip(cache, kv))
            lens = lens.at[slot].set(len(prompt))
            tok = tok.at[slot, 0].set(jnp.argmax(logits[0, len(prompt) - 1]))
            out["prefill"][slot] = np.asarray(logits[0, :len(prompt)])
            out["tokens"].append(np.asarray(tok[:, 0]).tolist())
        else:
            active = np.zeros(b, bool)
            active[list(op[1])] = True
            logits, cache = decode(params, cache, tok, lens)
            nxt = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)
            act = jnp.asarray(active) & (lens > 0)
            tok = jnp.where(act[:, None], nxt[:, None], tok)
            lens = jnp.where(act, jnp.minimum(lens + 1, s), lens)
            out["decode"].append(np.asarray(logits[:, 0]))
            out["tokens"].append(np.asarray(
                jnp.where(act, nxt, -1)).tolist())
    return out


def _served(sv, prompts) -> dict:
    for i, p in enumerate(prompts):
        sv.submit(sv_request(sv, i, p))
    sv.run_until_drained()
    sv.close()
    return {r.uid: list(r.out_tokens) for r in sv.completed}


def sv_request(sv, uid, prompt):
    cls = JRequest if isinstance(sv, JServer) else Request
    return cls(uid, np.asarray(prompt, np.int32), max_new_tokens=NEW)


JAX_MESH = """
from repro.configs import get_config, reduced, RunConfig
from repro.runtime.server import Request, Server, ServerConfig
mesh = make_mesh((2, 2), ("data", "model"))
out = {}
for arch in __ARCHS__:
    sv = Server(reduced(get_config(arch)),
                RunConfig(attention_impl="naive", param_dtype="float32",
                          compute_dtype="float32"),
                ServerConfig(max_batch=4, max_seq=64), mesh=mesh, seed=0)
    for i, p in enumerate(__PROMPTS__):
        sv.submit(Request(i, np.asarray(p, np.int32),
                          max_new_tokens=__NEW__))
    sv.run_until_drained()
    sv.close()
    out[arch] = {str(r.uid): r.out_tokens for r in sv.completed}
print("RESULT:" + json.dumps(out))
"""
ARCHS = (PHI3, COMMAND_R)
CASES = [(a, m) for a in ARCHS for m in MESHES]
IDS = ["-".join((a, "x".join(map(str, m)))) for a, m in CASES]


@pytest.fixture(scope="module")
def served():
    """Per arch: the JAX package's one-device engine (its parameters, its
    drained tokens, its script logits) and its (2, 2) mesh engine's
    tokens; the port's one-device engine on those parameters; every
    (mesh, arch) on four gloo ranks (one spawn)."""
    rc = dict(attention_impl="naive", param_dtype="float32",
              compute_dtype="float32")
    jax_mesh = distributed_run(
        JAX_MESH.replace("__ARCHS__", repr(ARCHS)).replace(
            "__PROMPTS__", repr(PROMPTS)).replace("__NEW__", str(NEW)),
        devices=4, timeout=300)
    refs, named = {}, {}
    for arch in ARCHS:
        jsv = JServer(reduced(get_config(arch)), RunConfig(**rc),
                      JServerConfig(**SCFG), seed=0)
        named[arch] = {n: np.asarray(a) for n, a in named_leaves(jsv.params)}
        ref = {"jax": _jax_drive(jsv, SCRIPT),
               "jax_served": _served(jsv, PROMPTS),
               "jax_mesh_served": {int(k): v
                                   for k, v in jax_mesh[arch].items()}}
        mk = lambda: Server(  # noqa: E731
            R.cfg(arch), tc.RunConfig(**R.KW), ServerConfig(**SCFG),
            device="cpu", params=load_reference_params(named[arch], "cpu"))
        ref["port"] = R.drive(mk(), SCRIPT)
        ref["port_served"] = _served(mk(), PROMPTS)
        refs[arch] = ref
    runs = [(m, a) for a, m in CASES]
    ranks = spawn(R.serve_rank, 4, "gloo",
                  args=(runs, named, SCFG, SCRIPT, PROMPTS, NEW),
                  timeout=300)
    for arch, mesh in CASES:
        refs[arch][mesh] = [r[(mesh, arch)] for r in ranks]
    return refs


def _close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= RTOL * float(np.abs(want).max()), (what, err)


@pytest.mark.parametrize("arch,mesh", CASES, ids=IDS)
def test_serve_mesh_logits_equal_one_device(served, arch, mesh):
    ref = served[arch]
    for want in (ref["port"], ref["jax"]):
        for rank in ref[mesh]:
            for slot, logits in rank["prefill"].items():
                _close(logits, want["prefill"][slot], (arch, mesh, slot))
            for i, (a, b) in enumerate(zip(rank["decode"], want["decode"])):
                _close(a, b, (arch, mesh, "decode", i))
            assert len(rank["decode"]) == len(want["decode"])
    # every slot admitted on some data rank
    owned = set().union(*(r["prefill"] for r in ref[mesh]))
    assert owned == {0, 1, 2, 3}


@pytest.mark.parametrize("arch,mesh", CASES, ids=IDS)
def test_serve_mesh_greedy_tokens_equal_one_device(served, arch, mesh):
    ref = served[arch]
    for rank in ref[mesh]:
        assert rank["tokens"] == ref["port"]["tokens"] == \
            ref["jax"]["tokens"]
        assert rank["lens"] == ref["port"]["lens"]
        assert rank["served"] == ref["port_served"] == ref["jax_served"] \
            == ref["jax_mesh_served"]
        assert rank["stats"] == {"prefill_calls": len(PROMPTS),
                                 "cross_slot_mismatches": 0}


@pytest.mark.parametrize("arch,mesh", CASES, ids=IDS)
def test_serve_mesh_cache_blocks(served, arch, mesh):
    """(n_layers, B/D, S/M, KV, hd) on every rank; a rank that holds none
    of a slot's positions still gives finite merged output."""
    cfg = R.cfg(arch)
    d, m = mesh
    want = (cfg.n_layers, SCFG["max_batch"] // d, SCFG["max_seq"] // m,
            cfg.n_kv_heads, cfg.head_dim)
    for rank in served[arch][mesh]:
        assert rank["cache_shape"] == [want, want]
        assert rank["finite"]


def test_launcher_serves_on_a_cpu_mesh(capsys):
    """``--devices 4 --mesh 2x2``: four gloo ranks, the report on rank 0,
    every rank the one-device launcher's tokens."""
    argv = ["--requests", "4", "--max-new", "3", "--max-seq", "32"]
    one = serve_cli.main(argv, device="cpu")
    ranks = serve_cli.main(argv + ["--devices", "4", "--mesh", "2x2"],
                           device="cpu")
    want = [(r.uid, r.prompt.tolist(), r.out_tokens) for r in one]
    assert len(ranks) == 4
    for got in ranks:
        assert sorted(got) == sorted(want)
    assert "over gloo" in capsys.readouterr().out
