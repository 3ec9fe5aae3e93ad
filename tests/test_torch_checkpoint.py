"""Checkpoints of the port (checkpoint/ckpt.py): the round trip, atomicity,
garbage collection, the async snapshot's isolation from later in-place
steps, retries; a checkpoint written by the JAX package restores into the
port and the reverse, every leaf bit for bit (bf16 included), with the
manifest's plan record equal to the reference's ``Plan.tables()``; and a
gloo restore across meshes (``distributed``).
"""
import json
import os

import numpy as np
import pytest
import torch

import _torch_replan_ranks as RR
from repro.checkpoint import ckpt as jckpt
from repro.configs import RunConfig, ShapeConfig, get_config, reduced
from repro.data import SyntheticLM
from repro.runtime.trainer import Trainer as JTrainer
from repro.runtime.trainer import TrainerConfig as JTrainerConfig
from repro.utils.tree import named_leaves
import repro_torch.configs as tc
from repro_torch.checkpoint import ckpt
from repro_torch.checkpoint.ckpt import (AsyncCheckpointer, gc_checkpoints,
                                         latest_step, restore_checkpoint,
                                         save_checkpoint, state_leaves)
from repro_torch.launch.mesh import spawn
from repro_torch.optim.optimizer import TrainState
from repro_torch.runtime.trainer import Trainer, TrainerConfig


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tests run many small eager ops; beside the other test workers,
    torch's default of a thread per core oversubscribes the host many
    times over. One intra-op thread for this module, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _state(seed=0) -> TrainState:
    g = torch.Generator().manual_seed(seed)
    params = {"emb": torch.randn(16, 4, generator=g).to(torch.bfloat16),
              "w": torch.randn(8, 4, generator=g)}
    return TrainState(step=3, params=params,
                      m={n: torch.randn(p.shape, generator=g)
                         for n, p in params.items()},
                      v=None, ema=None)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def _same(a: TrainState, b: TrainState) -> bool:
    la, lb = state_leaves(a), state_leaves(b)
    if [p for p, _ in la] != [p for p, _ in lb] or a.step != b.step:
        return False
    return all(torch.equal(_bits(x), _bits(y)) and x.dtype == y.dtype
               for (_, x), (_, y) in zip(la[1:], lb[1:]))


def test_roundtrip(tmp_path):
    s = _state()
    save_checkpoint(str(tmp_path), 3, s, extra={"hello": 1})
    got, step, extra = restore_checkpoint(str(tmp_path), _state(1))
    assert step == 3 and extra == {"hello": 1}
    assert _same(got, s)


def test_atomicity_tmp_never_visible(tmp_path):
    s = _state()
    save_checkpoint(str(tmp_path), 1, s)
    os.makedirs(tmp_path / "step_00000002.tmp")     # a crashed writer
    assert latest_step(str(tmp_path)) == 1
    _, step, _ = restore_checkpoint(str(tmp_path), s)
    assert step == 1


def test_gc_keeps_latest_and_ignores_strays(tmp_path):
    s = _state()
    for i in (1, 2, 3, 4):
        save_checkpoint(str(tmp_path), i, s)
    (tmp_path / "notes.txt").write_text("hi")
    (tmp_path / "step_7").mkdir()                 # not this writer's name
    gc_checkpoints(str(tmp_path), keep=2)
    kept = sorted(d for d in os.listdir(tmp_path)
                  if d.startswith("step_0"))
    assert kept == ["step_00000003", "step_00000004"]
    assert (tmp_path / "step_7").exists()
    assert latest_step(str(tmp_path)) == 4


def test_async_snapshot_is_isolated_from_later_steps(tmp_path):
    """The port's steps write parameters and moments in place, and
    ``.cpu()`` of a CPU tensor is the same storage: the snapshot must be a
    copy taken before ``save`` returns."""
    s = _state()
    want = {p: t.clone() for p, t in state_leaves(s)[1:]}
    ck = AsyncCheckpointer(str(tmp_path), keep=2)
    ck.save(5, s)
    with torch.no_grad():                 # the next step, in place
        for _, t in state_leaves(s)[1:]:
            t.add_(1.0)
    s.step = 6
    ck.wait()
    assert ck.last_committed == 5
    got, step, _ = restore_checkpoint(str(tmp_path), s)
    assert step == 5 and got.step == 3
    assert all(torch.equal(_bits(dict(state_leaves(got)[1:])[p]),
                           _bits(want[p])) for p in want)


def test_async_save_retries_then_surfaces(tmp_path, monkeypatch):
    real = ckpt.save_checkpoint
    calls = {"n": 0}

    def flaky(*a, **k):
        calls["n"] += 1
        if calls["n"] <= 2:
            raise OSError("transient")
        return real(*a, **k)

    monkeypatch.setattr(ckpt, "save_checkpoint", flaky)
    ck = AsyncCheckpointer(str(tmp_path), keep=2, retries=3, backoff=0.001)
    ck.save(5, _state())
    ck.wait()                             # the third try landed
    assert calls["n"] == 3 and ck.total_retries == 2
    assert ck.last_committed == 5 and latest_step(str(tmp_path)) == 5

    def always_fail(*a, **k):
        raise OSError("disk gone")

    monkeypatch.setattr(ckpt, "save_checkpoint", always_fail)
    ck = AsyncCheckpointer(str(tmp_path / "b"), retries=2, backoff=0.001)
    ck.save(6, _state())
    assert ck.error is None or isinstance(ck.error, OSError)
    with pytest.raises(OSError):
        ck.wait()
    assert ck.total_retries == 2 and ck.last_committed is None
    # a stale background failure does not block a synchronous commit
    monkeypatch.setattr(ckpt, "save_checkpoint", real)
    ck._error = OSError("stale")
    ck.save_sync(7, _state(), extra={"plan": {}})
    assert ck.last_committed == 7
    ck.wait()


# ---------------------------------------------------------------------------
# the two packages read each other's checkpoints
# ---------------------------------------------------------------------------

def _jax_trainer(ckpt_dir, steps=2):
    cfg = reduced(get_config("parallax-lm"))
    shape = ShapeConfig("t", 16, 4, "train")
    rc = RunConfig(capacity_mode="capped", capacity_factor=1.5)
    t = JTrainer(cfg, shape, rc,
                 JTrainerConfig(total_steps=steps, ckpt_dir=ckpt_dir,
                                ckpt_every=steps),
                 SyntheticLM(cfg.vocab_size, 16, 4))
    t.run()
    return t


def _port_trainer(ckpt_dir, steps=2):
    cfg = tc.reduced(tc.get_config("parallax-lm"))
    shape = tc.ShapeConfig("t", 16, 4, "train")
    rc = tc.RunConfig(capacity_mode="capped", capacity_factor=1.5)
    return Trainer(cfg, shape, rc,
                   TrainerConfig(total_steps=steps, ckpt_dir=ckpt_dir,
                                 ckpt_every=steps),
                   SyntheticLM(cfg.vocab_size, 16, 4), device="cpu")


def _np_bits(a: np.ndarray) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def test_jax_checkpoint_restores_into_the_port(tmp_path):
    jt = _jax_trainer(str(tmp_path))
    want = {p: _np_bits(a) for p, a in named_leaves(jt._canonical_state())}
    tt = _port_trainer(str(tmp_path), steps=2)
    tt.maybe_restore()
    assert tt.step == 2 and tt.state.step == 2
    got = dict(state_leaves(tt._canonical_state()))
    assert set(got) == set(want)
    assert got.pop("step") == int(want.pop("step"))   # a Python int here
    for p, a in want.items():
        t = got[p].detach()
        b = (t.view(torch.int16).numpy().view(np.uint16)
             if t.dtype == torch.bfloat16 else t.numpy())
        assert b.dtype == a.dtype and np.array_equal(b, a), p
    assert tt.plan.tables() == jt.plan.tables()


def test_port_checkpoint_restores_into_jax(tmp_path):
    tt = _port_trainer(str(tmp_path))
    tt.run()
    with open(tmp_path / "step_00000002" / "manifest.json") as f:
        man = json.load(f)
    jt = _jax_trainer(str(tmp_path / "other"), steps=1)
    assert man["extra"]["plan"] == jt.plan.tables()
    # the JAX package restores the port's checkpoint into its own state
    got, step, extra = jckpt.restore_checkpoint(str(tmp_path),
                                                jt._canonical_state())
    assert step == 2 and int(np.asarray(got.step)) == 2
    port = dict(state_leaves(tt._canonical_state()))
    assert int(np.asarray(port.pop("step"))) == 2
    for p, a in named_leaves(got):
        if p == "step":
            continue
        t = port[p]
        b = (t.detach().view(torch.int16).numpy().view(np.uint16)
             if t.dtype == torch.bfloat16 else t.detach().numpy())
        assert np.array_equal(_np_bits(a), b), p
    assert [l["path"] for l in man["leaves"]] == \
        [p for p, _ in named_leaves(got)]


@pytest.mark.distributed
def test_gloo_restore_across_meshes(tmp_path):
    """Reduced parallax-lm trained 2 steps on a (2, 2) gloo mesh under
    comm_mode ps (the table row-sharded over model): every rank gathers the
    state whole and rank 0 writes. It restores onto (4, 1) ranks and onto
    one device, each leaf equal to the whole state the writer saw."""
    d = str(tmp_path)
    saved = spawn(RR.save_on_mesh, 4, "gloo", args=(d,), timeout=300)
    whole = saved[0]
    for shape in ((4, 1),):
        got = spawn(RR.restore_on_mesh, 4, "gloo", args=(d, shape),
                    timeout=300)
        for r in got:
            assert r["step"] == 2 and r["shards_equal"], r
    one = RR.restore_on_mesh(0, 1, d, None)
    assert one["step"] == 2 and one["shards_equal"]
    assert set(one["whole"]) == set(whole)
    for k, v in whole.items():
        assert np.array_equal(one["whole"][k], v), k
