"""The training step's spans (``repro_torch/utils/spans.py``) on the CPU,
reduced parallax-lm through ``Trainer.run`` with a replan look every 4
steps and a checkpoint every 4: under ``torch.profiler`` every span
appears inside its parent, a replan look is one ``trainer.replan``, the
backward's spans fall inside ``step.backward``; with no profiler no
``record_function`` is entered; and the profiler changes no number. On a
(2, 1) gloo mesh whose gatherv push is deferred past the backward, the
deferred pushes fall inside ``step.exchange``."""
import pytest
import torch
from torch.autograd import profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile

import repro_torch.configs as tc
from repro_torch.checkpoint.ckpt import state_leaves
from repro_torch.data import SyntheticLM
from repro_torch.launch.mesh import spawn
from repro_torch.runtime.trainer import Trainer, TrainerConfig
from repro_torch.utils import spans

SEQ, BATCH, VOCAB, STEPS = 8, 4, 256, 8
RC = dict(param_dtype="float32", compute_dtype="float32",
          capacity_mode="capped", capacity_factor=1.5)
# span -> the spans one of which holds each of its instances
PARENTS = {"step.forward": ("trainer.step",),
           "embed.pull": ("step.forward",),
           "xent.forward": ("step.forward",),
           "step.backward": ("trainer.step",),
           "xent.backward": ("step.backward",),
           "embed.push": ("step.backward", "step.exchange"),
           "step.exchange": ("trainer.step",),
           "step.update": ("trainer.step",)}
TOP = ("trainer.batch", "trainer.step", "trainer.metrics", "trainer.profile",
       "trainer.replan", "trainer.ckpt", "trainer.decide")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _trainer(ckpt_dir=None) -> Trainer:
    cfg = tc.reduced(tc.get_config("parallax-lm"), vocab=VOCAB)
    kw = dict(ckpt_dir=str(ckpt_dir), ckpt_every=4) if ckpt_dir else {}
    return Trainer(cfg, tc.ShapeConfig("t", SEQ, BATCH, "train"),
                   tc.RunConfig(**RC),
                   TrainerConfig(total_steps=STEPS, replan_every=4,
                                 replan_warmup=2, replan_drift=1.3, **kw),
                   SyntheticLM(VOCAB, SEQ, BATCH), device="cpu")


def _traced(tmp_path) -> tuple:
    t = _trainer(tmp_path / "ckpt")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        t.run()
    by: dict = {}
    for ev in prof.events():
        if ev.name in spans.NAMES:
            by.setdefault(ev.name, []).append(
                (ev.time_range.start, ev.time_range.end))
    return t, by


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    return _traced(tmp_path_factory.mktemp("spans"))


def _inside(iv, outer) -> bool:
    return any(s <= iv[0] and iv[1] <= e for s, e in outer)


def test_every_span_appears_inside_its_parent(traced):
    t, by = traced
    assert set(by) == set(spans.NAMES)
    for name in ("trainer.batch", "trainer.step", "trainer.metrics",
                 "trainer.profile", "trainer.decide", "step.forward",
                 "step.backward", "step.exchange", "step.update",
                 "embed.pull", "embed.push", "xent.forward",
                 "xent.backward"):
        assert len(by[name]) == STEPS, name
    for child, parents in PARENTS.items():
        outer = [iv for p in parents for iv in by[p]]
        for iv in by[child]:
            assert _inside(iv, outer), (child, iv)
    # the trainer's spans hold one another nowhere
    top = sorted(iv for n in TOP for iv in by[n])
    assert all(a[1] <= b[0] for a, b in zip(top, top[1:]))


def test_a_replan_look_is_one_span(traced):
    t, by = traced
    assert len(by["trainer.replan"]) == STEPS // 4
    # the two periodic saves and the one at the end of the run
    assert len(by["trainer.ckpt"]) == STEPS // 4 + 1


def test_the_backwards_spans_fall_inside_the_backward(traced):
    _, by = traced
    for name in ("xent.backward", "embed.push"):
        for iv in by[name]:
            assert _inside(iv, by["step.backward"]), (name, iv)


def test_no_profiler_enters_no_record_function(monkeypatch):
    entered = []

    class Counting:
        def __init__(self, name, args=None):
            entered.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(autograd_profiler, "record_function", Counting)
    t = _trainer()
    t.tcfg.total_steps = 4
    t.run()
    assert entered == []
    assert spans.span("trainer.step") is spans.span("step.update")
    # the same patch sees every span once the profiler collects
    t.tcfg.total_steps = 8
    with profile(activities=[ProfilerActivity.CPU]):
        t.run()
    assert set(entered) == set(spans.NAMES) - {"trainer.ckpt"}


def test_the_profiler_changes_no_number():
    a, b = _trainer(), _trainer()
    la, lb = [], []
    a.run(on_metrics=lambda s, m: la.append(m["loss"]))
    with profile(activities=[ProfilerActivity.CPU]):
        b.run(on_metrics=lambda s, m: lb.append(m["loss"]))
    assert la == lb
    sa, sb = dict(state_leaves(a.state)), dict(state_leaves(b.state))
    assert sa.keys() == sb.keys()
    for k, v in sa.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(v, sb[k]), k
        else:
            assert v == sb[k], k


@pytest.mark.distributed
def test_a_deferred_push_falls_inside_the_exchange():
    import _torch_spans_ranks as R
    for r in spawn(R.mesh_spans_rank, 2, "gloo",
                   args=((2, 1), {"comm_mode": "mpi", "overlap": False}),
                   timeout=300):
        assert r["method"] == "mpi_gatherv" and r["deferred"]
        by = r["spans"]
        for name in ("step.forward", "step.backward", "step.exchange",
                     "step.update", "embed.pull", "xent.forward",
                     "xent.backward"):
            assert len(by[name]) == R.STEPS, name
        # the segment sum in the backward, the gatherv after it
        push = by["embed.push"]
        assert sum(_inside(iv, by["step.backward"]) for iv in push) == \
            R.STEPS
        assert sum(_inside(iv, by["step.exchange"]) for iv in push) == \
            R.STEPS
