"""Tensor-parallel execution of the attention and SwiGLU MLP over
``model``, and ``core/sp.py``'s explicit sequence-parallel blocks: the port
of the reference's ``tests/test_perf_paths.py::test_perf_paths_exact`` for
its explicit-SP cases (reduced phi3 and command-r, the tied table; phi3
under ``dense_strategy="auto"``, which resolves to ``tp`` at this size) on
(2, 4), and plain tensor parallelism on (2, 2). Reduced configs at f32,
the reference test's ``RunConfig``, ``ShapeConfig("tiny", 32, 8)``, 3
steps from the JAX package's seeded init: every step's loss within the
reference test's bar, 2e-5, of the JAX package's one-device run and of the
port's.

Also: each rank's attention and MLP leaves hold 1/M of the whole and its
parameter bytes equal the plan's parameter term (``held == placement`` for
the dense family); 6 q heads padded to 8 on a model axis of 4 under
``explicit_sp``; both branches of ``sp.kv_local_favorable`` (the branch
the H100 record picks at the reduced width, and the sequence-local K/V
one under a record that makes it cheaper), and where the two records put
the published widths.
"""
import types

import numpy as np
import pytest

import _torch_dense_ranks as D
import _torch_tp_ranks as R
from repro.configs import RunConfig, ShapeConfig, get_config, reduced
from repro.core import sp as jsp
from repro.core.transform import get_runner as jget_runner
from repro.utils.tree import named_leaves
import repro_torch.configs as tc
from repro_torch.core import sp
from repro_torch.core.transform import get_runner
from repro_torch.launch.mesh import MeshShape, spawn
from repro_torch.weights import load_reference_params

pytestmark = pytest.mark.distributed

PHI3, COMMAND_R = "phi3-medium-14b", "command-r-35b"
BAR = 2e-5
SP = {"explicit_sp": True}
# (mesh) -> [(key, arch, flags, cfg overrides, local K/V forced)]
RUNS = {
    (2, 4): [("phi3/sp", PHI3, SP, {}, False),
             ("command-r/sp", COMMAND_R, SP, {}, False),
             ("phi3/sp-auto", PHI3, dict(SP, dense_strategy="auto"), {},
              False),
             ("phi3/sp-local-kv", PHI3, SP, {}, True),
             ("phi3/sp-padded", PHI3, SP,
              {"heads": D.PAD_HEADS, "kv_heads": D.PAD_KV}, False)],
    (2, 2): [("phi3/tp", PHI3, {}, {}, False),
             ("command-r/tp", COMMAND_R, {}, {}, False),
             ("command-r/sp-local-kv", COMMAND_R, SP, {}, True)],
}
CASES = [(mesh, key) for mesh, runs in RUNS.items() for key, *_ in runs]


def _jax_run(arch: str, **over):
    cfg = reduced(get_config(arch), **over)
    jr = jget_runner(cfg, ShapeConfig("tiny", R.SEQ, R.BATCH, "train"),
                     RunConfig(**R.KW), seed=0)
    named = {n: np.asarray(a) for n, a in named_leaves(jr.state.params)}
    return named, [float(jr.run(b)["loss"])
                   for b in R.batches(cfg.vocab_size)]


def _port_run(arch: str, named: dict, **over):
    cfg = R.cfg(arch, **over)
    r = get_runner(cfg, tc.ShapeConfig("tiny", R.SEQ, R.BATCH, "train"),
                   tc.RunConfig(**R.KW), device="cpu",
                   params=load_reference_params(named, "cpu"))
    return [float(r.run(b)["loss"]) for b in R.batches(cfg.vocab_size)]


def _over(key):
    for runs in RUNS.values():
        for k, _, _, over, _ in runs:
            if k == key:
                return over
    raise KeyError(key)


@pytest.fixture(scope="module")
def reference():
    """The JAX package's one-device losses and parameters, and the
    port's one-device losses from them; the padded case's parameters are
    the unpadded model's, padded with zero q-head columns."""
    out = {}
    for arch, over in ((PHI3, {}), (COMMAND_R, {}),
                       (PHI3, {"heads": D.PAD_HEADS,
                               "kv_heads": D.PAD_KV})):
        named, want = _jax_run(arch, **over)
        out[(arch, tuple(over.items()))] = (named, want,
                                            _port_run(arch, named, **over))
    return out


def _named(reference, arch, over, mesh):
    named = reference[(arch, tuple(over.items()))][0]
    if over:
        hd = R.cfg(arch, **over).head_dim
        pad = -(-D.PAD_HEADS // mesh[1]) * mesh[1]
        named = D.pad_q_heads(named, D.PAD_HEADS, pad, hd)
    return named


@pytest.fixture(scope="module")
def meshes(reference):
    out = {}
    for mesh, runs in RUNS.items():
        cases = [(key, arch, flags, _named(reference, arch, over, mesh),
                  over, local) for key, arch, flags, over, local in runs]
        out[mesh] = spawn(R.train_rank, mesh[0] * mesh[1], "gloo",
                          args=(mesh, cases), timeout=400)
    return out


@pytest.mark.parametrize("mesh,key", CASES,
                         ids=["-".join(("x".join(map(str, m)), k))
                              for m, k in CASES])
def test_tp_steps_equal_one_device(reference, meshes, mesh, key):
    arch = key.split("/")[0]
    arch = PHI3 if arch == "phi3" else COMMAND_R
    _, want, port = reference[(arch, tuple(_over(key).items()))]
    ranks = [r[key] for r in meshes[mesh]]
    got = ranks[0]["loss"]
    assert all(r["loss"] == got for r in ranks), [r["loss"] for r in ranks]
    for i, (a, b, c) in enumerate(zip(got, want, port)):
        assert abs(a - b) < BAR and abs(a - c) < BAR, (key, i, got, want,
                                                       port)
    assert ranks[0]["strategy"] == "tp"
    assert ranks[0]["kv_local"] == key.endswith("local-kv")


@pytest.mark.parametrize("mesh", list(RUNS), ids=["2x4", "2x2"])
def test_each_rank_holds_its_shards(meshes, mesh):
    """Every attention and MLP leaf is 1/M of the whole on every rank, a
    rank's parameter bytes are the plan's parameter term, and the state
    gathered whole and cut again is the rank's state."""
    for rank in meshes[mesh]:
        for key, r in rank.items():
            assert r["held_is_placement"], key
            # gathered whole and cut again (a checkpoint's save and restore)
            assert r["round_trip"], key
            assert r["bytes"] == r["plan_bytes"], (key, r["bytes"],
                                                   r["plan_bytes"])
            assert set(r["shares"]) >= {
                f"layers.{n}" for n in ("attn.wq", "attn.wo", "mlp.w_gate",
                                        "mlp.w_up", "mlp.w_down")}
            assert all(s == 1 / mesh[1] for s in r["shares"].values()), \
                (key, r["shares"])


def test_kv_local_favorable_prices_on_each_record():
    """The port prices on the H100 record, the reference on its TPU's: at
    the reduced width both keep K/V on the gathered activation; at
    phi3-medium-14b's published width (d 5,120) the H100 record takes the
    sequence-local branch and the reference's does not; at
    command-r-35b's (d 8,192) both do."""
    mesh = MeshShape((2, 4), ("data", "model"))
    rt = types.SimpleNamespace(mesh=mesh)
    for arch, port, ref in ((PHI3, True, False), (COMMAND_R, True, True)):
        assert sp.kv_local_favorable(rt, R.cfg(arch)) is False
        assert jsp.kv_local_favorable(rt, reduced(get_config(arch))) is False
        assert sp.kv_local_favorable(rt, tc.get_config(arch)) is port
        assert jsp.kv_local_favorable(rt, get_config(arch)) is ref
