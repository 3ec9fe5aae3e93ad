"""The port's training driver (runtime/trainer.py, runtime/monitor.py,
launch/train.py) on the CPU, reduced parallax-lm: resume equals an
uninterrupted run bit for bit; a failed step restores the last checkpoint
or re-initializes from the seed; overflow growth and its surfacing in the
monitor; the replan hook; the trainer against the JAX package's trainer
(rtol 1e-5 at f32, from the same parameters through a JAX-written
checkpoint), and a JAX trainer's checkpoint continued by the port's
trainer; the elastic half refused by name; the launcher; and
``StepMonitor`` against the reference's on synthetic step-time series.
"""
import dataclasses
import sys

import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jckpt
from repro.configs import RunConfig, ShapeConfig, get_config, reduced
from repro.data import SyntheticLM
from repro.runtime import monitor as jmon
from repro.runtime.trainer import Trainer as JTrainer
from repro.runtime.trainer import TrainerConfig as JTrainerConfig
import repro_torch.configs as tc
from repro_torch.checkpoint.ckpt import latest_step, state_leaves
from repro_torch.launch import train as launch_train
from repro_torch.runtime import monitor as tmon
from repro_torch.runtime.trainer import Trainer, TrainerConfig

SEQ, BATCH = 32, 8
F32 = dict(param_dtype="float32", compute_dtype="float32")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tests run many small eager ops; beside the other test workers,
    torch's default of a thread per core oversubscribes the host many
    times over. One intra-op thread for this module, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _trainer(rc_kw=None, tcfg=None, ds=None, vocab=512, **tkw):
    cfg = tc.reduced(tc.get_config("parallax-lm"), vocab=vocab)
    shape = tc.ShapeConfig("t", SEQ, BATCH, "train")
    ds = ds or SyntheticLM(vocab, SEQ, BATCH)
    return Trainer(cfg, shape, tc.RunConfig(**(rc_kw or F32)),
                   tcfg or TrainerConfig(**tkw), ds, device="cpu")


def _run(t) -> list:
    out = []
    t.run(on_metrics=lambda s, m: out.append((s, m)))
    return out


def _bits(state) -> dict:
    return {p: (t.detach().clone() if isinstance(t, torch.Tensor) else t)
            for p, t in state_leaves(state)}


def _equal(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(
        torch.equal(a[k], b[k]) if isinstance(a[k], torch.Tensor)
        else a[k] == b[k] for k in a)


REPLAN = dict(replan_every=2, replan_warmup=1, replan_drift=1.3)


@pytest.mark.parametrize("rc_kw", [
    dict(F32, capacity_mode="capped", capacity_factor=1.5),
    dict(capacity_mode="capped", capacity_factor=1.5),        # bf16
])
def test_resume_equals_uninterrupted_bit_for_bit(tmp_path, rc_kw):
    """6 steps straight against 3 + a fresh trainer's restore + 3, with
    replans along the way (the checkpoint at step 3 records the shrunk
    plan, which the restore adopts): equal losses and every parameter and
    moment bit for bit."""
    ref = _trainer(rc_kw, TrainerConfig(total_steps=6, **REPLAN))
    want = _run(ref)
    assert ref.monitor.replans >= 1
    d = str(tmp_path)
    a = _trainer(rc_kw, TrainerConfig(total_steps=3, ckpt_dir=d,
                                      ckpt_every=3, **REPLAN))
    first = _run(a)
    b = _trainer(rc_kw, TrainerConfig(total_steps=6, ckpt_dir=d,
                                      ckpt_every=3, **REPLAN))
    assert b.plan.table_capacity != a.plan.table_capacity
    b.maybe_restore()
    assert b.step == 3 and b.plan.tables() == a.plan.tables()
    second = _run(b)
    assert [s for s, _ in first + second] == [1, 2, 3, 4, 5, 6]
    assert [m["loss"] for _, m in first + second] == \
        [m["loss"] for _, m in want]
    assert _equal(_bits(b._canonical_state()), _bits(ref._canonical_state()))


def _flaky_once(t, fail_at_step: int) -> dict:
    """The step raises once at ``fail_at_step`` after half-writing the
    live state in place (the port's step updates it in place)."""
    orig, fired = t.train_step, {"n": 0}

    def step(state, batch):
        if t.step == fail_at_step and not fired["n"]:
            fired["n"] = 1
            with torch.no_grad():
                for p in state.params.values():
                    p.add_(1.0)              # poisoned live state
            raise RuntimeError("injected step failure")
        return orig(state, batch)

    t.train_step = step
    return fired


@pytest.mark.parametrize("ckpt_every,fail_at,steps", [
    (2, 5, [1, 2, 3, 4, 5, 5, 6]),          # rolled back to step 4
    (100, 3, [1, 2, 3, 1, 2, 3, 4, 5, 6]),  # nothing committed: seed init
])
def test_retry_after_injected_failure(tmp_path, ckpt_every, fail_at, steps):
    ref = _trainer(tcfg=TrainerConfig(total_steps=6))
    _run(ref)
    t = _trainer(tcfg=TrainerConfig(total_steps=6, ckpt_dir=str(tmp_path),
                                    ckpt_every=ckpt_every))
    fired = _flaky_once(t, fail_at)
    got = _run(t)
    assert fired["n"] == 1 and [s for s, _ in got] == steps
    assert t.step == 6 and t.state.step == 6
    assert latest_step(str(tmp_path)) == 6
    # never the poisoned state: the end state is the uninterrupted run's
    assert _equal(_bits(t._canonical_state()), _bits(ref._canonical_state()))


def test_retries_are_bounded(tmp_path):
    t = _trainer(tcfg=TrainerConfig(total_steps=3, ckpt_dir=str(tmp_path),
                                    ckpt_every=1, max_retries=1))

    def always(*a, **k):
        raise RuntimeError("dead node")

    t.model.loss_fn = always          # every rebuilt step reaches it too
    with pytest.raises(RuntimeError, match="dead node"):
        t.run()


def test_overflow_growth_and_monitor_surfacing():
    """A burst of uniform ids overflows the capped buffer the declared
    Zipf(2.0) skew sized: the overflow EMA shows in the monitor's stats
    and the replan grows the table (drift 50: only growth can trigger);
    after the growth no row drops."""
    rc = dict(F32, capacity_mode="capped", capacity_factor=2.0, zipf_a=2.0,
              capacity_growth=1.5, overflow_tolerance=0.5)
    ds = SyntheticLM(256, SEQ, BATCH, zipf_a=2.0, burst_steps=4,
                     burst_zipf_a=1.3)
    t = _trainer(rc, TrainerConfig(total_steps=10, replan_every=6,
                                   replan_warmup=2, replan_drift=50.0),
                 ds=ds, vocab=256)
    cap0 = t.plan.table_capacity["embed"]
    stats = _run(t)
    assert any(m.get("overflow", {}).get("embed", 0) > 0 for _, m in stats)
    assert max(m["embed_dropped"] for _, m in stats[:4]) > 0
    assert "overflow_rows" in stats[-1][1]
    assert t.monitor.replans >= 1 and t.replan_history[0]["capacity_grown"]
    assert t.plan.table_capacity["embed"] > cap0
    assert "embed" in t.plan.grown_tables
    assert all(m["embed_dropped"] == 0 for _, m in stats[6:])


def test_replan_hook_and_monitor():
    t = _trainer(dict(F32, capacity_mode="capped", capacity_factor=1.5),
                 TrainerConfig(total_steps=8, replan_every=4,
                               replan_warmup=2, replan_drift=1.3))
    cap0 = t.plan.capacity
    stats = _run(t)
    assert t.monitor.replans >= 1
    assert t.plan.capacity < cap0
    assert t.plan.alpha < cap0 / 512
    assert "observed_alpha" in stats[-1][1]
    assert stats[-1][1]["replans"] == t.monitor.replans
    assert all(np.isfinite(m["loss"]) for _, m in stats)
    assert stats[-1][1]["apply_seconds"] > 0


def _jax_trainer(tcfg_kw: dict, rc_kw: dict):
    cfg = reduced(get_config("parallax-lm"))
    return JTrainer(cfg, ShapeConfig("t", SEQ, BATCH, "train"),
                    RunConfig(**rc_kw), JTrainerConfig(**tcfg_kw),
                    SyntheticLM(cfg.vocab_size, SEQ, BATCH))


RC_CAPPED = dict(F32, capacity_mode="capped", capacity_factor=1.5)


def test_trainer_matches_jax_trainer(tmp_path):
    """The JAX trainer and the port's, 8 steps with replans every 2, from
    the same parameters (the JAX package writes its step-0 state, the
    port restores it): losses within rtol 1e-5, the same replans and the
    same final plan."""
    jt = _jax_trainer(dict(total_steps=8, **REPLAN), RC_CAPPED)
    jckpt.save_checkpoint(str(tmp_path), 0, jt._canonical_state())
    want = []
    jt.run(on_metrics=lambda s, m: want.append(m))
    t = _trainer(RC_CAPPED, TrainerConfig(total_steps=8,
                                          ckpt_dir=str(tmp_path),
                                          ckpt_every=100, **REPLAN))
    t.maybe_restore()
    assert t.step == 0
    got = [m for _, m in _run(t)]
    np.testing.assert_allclose([m["loss"] for m in got],
                               [m["loss"] for m in want], rtol=1e-5)
    assert [m["replans"] for m in got] == [m["replans"] for m in want]
    assert t.monitor.replans == jt.monitor.replans >= 1
    assert t.plan.tables() == jt.plan.tables()


def test_jax_checkpoint_continued_by_port_trainer(tmp_path):
    """A JAX trainer's step-3 checkpoint (its plan record shrunk by a
    replan) continued by the port's trainer to step 6 matches the JAX
    trainer's uninterrupted steps 4-6 within rtol 1e-5."""
    kw = dict(replan_every=2, replan_warmup=1, replan_drift=1.3)
    a = _jax_trainer(dict(total_steps=3, ckpt_dir=str(tmp_path),
                          ckpt_every=3, **kw), RC_CAPPED)
    a.run()
    straight = []
    b = _jax_trainer(dict(total_steps=6, **kw), RC_CAPPED)
    b.run(on_metrics=lambda s, m: straight.append(m["loss"]))
    t = _trainer(RC_CAPPED, TrainerConfig(total_steps=6,
                                          ckpt_dir=str(tmp_path),
                                          ckpt_every=100, **kw))
    t.maybe_restore()
    assert t.step == 3 and t.plan.tables() == a.plan.tables()
    got = [m["loss"] for _, m in _run(t)]
    np.testing.assert_allclose(got, straight[3:], rtol=1e-5)


ELASTIC_KNOBS = {"remesh_on_straggle": True, "stale_on_jitter": True,
                 "attribution": False, "probation_steps": 5,
                 "probation_sustained": 1, "min_data_parallel": 2}


@pytest.mark.parametrize("what", [
    *ELASTIC_KNOBS, "remesh", "_auto_remesh", "readmit", "_flip_stale",
    "_heartbeat_batch"])
def test_elastic_half_is_refused_by_name(what):
    if what in ELASTIC_KNOBS:
        with pytest.raises(NotImplementedError, match=f"{what}.*slice 7"):
            TrainerConfig(**{what: ELASTIC_KNOBS[what]})
        return
    t = _trainer(tcfg=TrainerConfig(total_steps=1))
    args = {"remesh": (None,), "_flip_stale": (True,),
            "_heartbeat_batch": ({},)}.get(what, ())
    with pytest.raises(NotImplementedError, match=f"{what}.*slice 7"):
        getattr(t, what)(*args)


LM = ["--arch", "parallax-lm", "--reduced", "--seq", "16", "--batch", "4"]


@pytest.mark.parametrize("argv,err,match", [
    # the default arch (phi3) trains; its flash kernel does not
    (["--reduced", "--attention", "pallas"], NotImplementedError,
     "pallas.*forward-only"),
    # rwkv6, hymba, chameleon, seamless and the moe family train, none
    # through the flash kernel
    (["--arch", "grok-1-314b", "--reduced", "--attention", "pallas"],
     NotImplementedError, "pallas.*forward-only"),
    (LM + ["--embed-impl", "jnp"], NotImplementedError, "embed-impl jnp"),
    (LM + ["--kernel-autotune"], NotImplementedError, "slice 8"),
    (LM + ["--remesh-on-straggle"], NotImplementedError,
     "remesh_on_straggle.*slice 7"),
    (LM + ["--heartbeat"], NotImplementedError, "heartbeat.*slice 7"),
    (LM + ["--max-staleness", "2"], NotImplementedError,
     "max_staleness.*slice 7"),
    (LM + ["--probation-steps", "5"], NotImplementedError,
     "probation_steps.*slice 7"),
    (LM + ["--no-attribution"], NotImplementedError,
     "attribution.*slice 7"),
    (LM + ["--devices", "4"], ValueError, "--mesh"),
])
def test_launcher_refuses_by_name(argv, err, match):
    with pytest.raises(err, match=match):
        launch_train.main(argv, device="cpu")


def test_launcher_trains_on_the_cpu(tmp_path):
    argv = LM + ["--steps", "4", "--log-every", "2", "--capacity-mode",
                 "capped", "--replan-every", "2", "--replan-warmup", "1",
                 "--replan-drift", "1.3", "--ckpt-dir", str(tmp_path),
                 "--ckpt-every", "2", "--lr", "1e-3"]
    out = launch_train.main(argv, device="cpu")
    assert out["step"] == 4 and len(out["losses"]) == 4
    assert all(np.isfinite(out["losses"]))
    assert latest_step(str(tmp_path)) == 4
    assert out["plan0"]["embed"]["capacity"] > \
        out["plan"]["embed"]["capacity"]
    again = launch_train.main(argv[:-6] + ["--steps", "4", "--ckpt-dir",
                                           str(tmp_path)], device="cpu")
    assert again["losses"] == [] and again["step"] == 4   # restored at 4


@pytest.mark.distributed
def test_launcher_mesh_parses_sys_argv(monkeypatch):
    """``python -m repro_torch.launch.train ... --devices 2 --mesh 2x1``:
    ``main()`` parses the command line and hands the same flags to every
    rank, which trains the arch it names on the mesh it names."""
    argv = LM + ["--steps", "2", "--devices", "2", "--mesh", "2x1"]
    monkeypatch.setattr(sys, "argv", ["repro_torch.launch.train"] + argv)
    ranks = launch_train.main(device="cpu")
    assert len(ranks) == 2
    for r in ranks:
        assert r["step"] == 2 and len(r["losses"]) == 2
        assert "embed" in r["plan0"]
        assert r["losses"] == ranks[0]["losses"]
    assert all(np.isfinite(ranks[0]["losses"]))


# ---------------------------------------------------------------------------
# StepMonitor against the reference on synthetic series
# ---------------------------------------------------------------------------

class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def _apply(mon, clock, op) -> dict:
    kind, *a = op
    if kind == "tick":
        mon.start()
        clock.t += a[0]
        return mon.stop(tokens=10)
    if kind == "recovery_tick":
        mon.start()
        clock.t += a[0]
        mon.note_recovery()
        return mon.stop(tokens=10)
    getattr(mon, f"note_{kind}")(*a)
    return {}


def _ticks(*dts):
    return [("tick", dt) for dt in dts]


MONITOR_CASES = {
    "escalation": (dict(sustained=3, min_samples=4, cooldown=10),
                   _ticks(*[1.0] * 6, 5.0, 5.0, 5.0)),
    "min_samples": (dict(sustained=1, min_samples=4),
                    _ticks(1.0, 1.0, 50.0, 1.0, 50.0)),
    "cooldown": (dict(sustained=3, min_samples=4, cooldown=14),
                 _ticks(*[1.0] * 4, *[5.0] * 3) + [("remesh",)]
                 + _ticks(*[1.0] * 8, *[5.0] * 6)),
    "recovery": (dict(sustained=2, min_samples=2),
                 _ticks(1.0, 1.0, 1.0, 1.0, 9.0) + [("recovery_tick", 50.0)]
                 + _ticks(1.0)),
    "ckpt_and_telemetry": (
        {}, [("ckpt_error", OSError("disk full"))] + _ticks(1.0)
        + [("ckpt_error", None), ("ckpt_retries", 3), ("alpha", 0.07),
           ("replan",), ("overflow", {"embed": 2.5, "enc_embed": 0.0}),
           ("exchange", {"n_collectives_dense": 3, "overlap": True,
                         "n_two_level": 0, "n_overlapped_sparse": 1}),
           ("apply", 1.5e-3)] + _ticks(1.0, 2.0)),
    "heartbeat_attribution": (
        dict(sustained=3, min_samples=4),
        [op for _ in range(5) for op in
         (("heartbeats", {0: 1.0, 1: 1.0, 2: 6.0, 3: 1.0}), ("tick", 1.0))]),
    "regrow_probation": (
        dict(sustained=3, min_samples=4, cooldown=50),
        _ticks(*[1.0] * 5) + [("regrow", 1, 10, 2)]
        + [op for _ in range(3) for op in
           (("heartbeats", {0: 1.0, 1: 8.0, 2: 1.0}), ("tick", 1.0))]
        + _ticks(*[1.0] * 12)),
    "jitter_hysteresis": (
        dict(window=20, min_samples=10, sustained=50),
        _ticks(*[1.0] * 10, *[1.0, 5.0] * 8) + [("stale_flip", True)]
        + _ticks(*[1.0] * 16)),
    "even_window_median": (dict(window=4), _ticks(1.0, 5.0, 3.0, 9.0)),
}


@pytest.mark.parametrize("case", list(MONITOR_CASES))
def test_step_monitor_matches_reference(case, monkeypatch):
    kw, ops = MONITOR_CASES[case]
    clock = _Clock()
    monkeypatch.setattr(tmon.time, "perf_counter", clock)
    monkeypatch.setattr(jmon.time, "perf_counter", clock)
    tm, jm = tmon.StepMonitor(**kw), jmon.StepMonitor(**kw)
    for op in ops:
        t0 = clock.t
        got = _apply(tm, clock, op)
        clock.t = t0
        want = _apply(jm, clock, op)
        assert got == want, (op, got, want)
        for prop in ("straggler_suspected", "remesh_suggested",
                     "stale_suggested", "stale_recovered", "jitter_ratio"):
            assert getattr(tm, prop) == getattr(jm, prop), (op, prop)
        assert tm.straggler_slice() == jm.straggler_slice()
        assert tm.median() == jm.median()
    assert dataclasses.asdict(tm).keys() == dataclasses.asdict(jm).keys()
