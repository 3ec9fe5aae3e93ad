"""The program's spans in a trace (``bench/spans.py``) on synthetic event
lists, its six readers, and their entries in ``BENCHMARK.json``."""
import json
import time

import pytest

from bench import harness
from bench import spans as sp
from bench import trace as tr
from bench.harness import ROOT

READERS = {"span_ms.update": "xent and optimizer",
           "span_ms.xent": "xent and optimizer",
           "span_ms.embed": "kernels", "idle_ms.in_step": "step",
           "idle_ms.between_steps": "step", "replan_ms": "step"}


def _trace(kernels, host=(), start=0.0, end=20.0, steps=1, copies=()):
    return tr.Trace(kernels=list(kernels), host=list(host), start=start,
                    end=end, steps=steps, copies=list(copies))


def _run(trace):
    cell = harness.load_cell("lm1b-zipf")
    return harness.RankRun(cell=cell, rank=0, world=1, trace=trace,
                           steps=[], table_rows=1, width=1, table_itemsize=2,
                           wire_itemsize=2, window={})


# one step: the trainer's thread in trainer.step [1, 12], step.backward
# [4, 9]; autograd's thread in xent.backward [5, 6]; between steps
# trainer.metrics [12, 15] and trainer.replan [15, 16]
STEP = [("trainer.batch", 0.0, 1.0), ("trainer.step", 1.0, 12.0),
        ("step.forward", 1.5, 4.0), ("xent.forward", 3.0, 3.5),
        ("step.backward", 4.0, 9.0), ("xent.backward", 5.0, 6.0),
        ("step.update", 9.5, 11.5), ("trainer.metrics", 12.0, 15.0),
        ("trainer.replan", 15.0, 16.0)]


def _launch(t):
    return ("cudaLaunchKernel", t, t + 0.01)


def test_a_kernel_goes_to_the_spans_open_at_its_launch():
    # launched in the forward, in xent.backward (autograd's thread, inside
    # the trainer's step.backward) and in the update; each runs later
    k = [("fwd", 2.0, 3.0), ("xent_bwd", 6.0, 8.0), ("adam", 10.0, 13.0)]
    host = STEP + [_launch(1.8), _launch(5.5), _launch(9.6),
                   ("aten::add", 9.6, 9.7)]
    t = _trace(k, host, steps=2)
    assert sp.of(t).unmatched == 0
    assert sp.device_ms(t, ("xent.forward", "xent.backward")) == 1e3
    assert sp.device_ms(t, ("step.backward",)) == 1e3   # nested included
    assert sp.device_ms(t, ("step.update",)) == 1.5e3
    assert sp.device_ms(t, ("step.forward",)) == 0.5e3
    assert sp.device_ms(t, sp.SPANS) == 3e3             # every kernel
    # a span the trace lacks reads as nothing, not as zero
    assert sp.device_ms(t, ("embed.pull",)) is None


def test_a_cu_call_inside_a_cuda_call_is_one_launch():
    k = [("gemm", 2.0, 3.0)]
    host = STEP + [("cudaLaunchKernelExC", 1.8, 1.9),
                   ("cuLaunchKernelEx", 1.82, 1.88)]
    t = _trace(k, host)
    assert sp.of(t).unmatched == 0
    assert sp.device_ms(t, ("step.forward",)) == 1e3


def test_an_unmatched_kernel_is_counted_and_no_time_is_given():
    k = [("a", 2.0, 3.0), ("b", 3.0, 3.2)]
    t = _trace(k, STEP + [_launch(1.8)])
    assert sp.of(t).unmatched == 2
    assert sp.device_ms(t, ("step.forward",)) is None
    # NCCL's kernels run on streams of their own: no order to pair by
    k = [("a", 2.0, 3.0), ("ncclDevKernel_AllReduce_Sum_bf16", 2.5, 3.2)]
    t = _trace(k, STEP + [_launch(1.8), _launch(1.9)])
    assert sp.of(t).unmatched == 2
    assert sp.device_ms(t, ("step.forward",)) is None


def test_a_kernel_read_as_starting_before_its_call_keeps_its_order():
    # the device clock's offset: the second kernel reads 50 us before the
    # call that enqueued it
    k = [("a", 2.0, 2.2), ("b", 9.55, 9.8)]
    t = _trace(k, STEP + [_launch(1.8), _launch(9.6)])
    assert sp.of(t).unmatched == 0
    assert sp.device_ms(t, ("step.update",)) == pytest.approx(250.0)


def _outside_ms(t) -> float:
    idle = 1e3 * (t.window_s - t.busy_s()) / t.steps
    return idle - sp.idle_ms(t, sp.IN_STEP) - \
        sp.idle_ms(t, sp.BETWEEN_STEPS)


def test_an_idle_gap_is_split_where_it_crosses_a_span():
    # busy [0, 11] and [13, 20]: idle [11, 13] crosses trainer.step's end
    # at 12 into trainer.metrics
    k = [("k1", 0.0, 11.0), ("k2", 13.0, 20.0)]
    t = _trace(k, STEP + [_launch(0.5), _launch(1.2)])
    assert sp.idle_ms(t, sp.IN_STEP) == pytest.approx(1e3)
    assert sp.idle_ms(t, sp.BETWEEN_STEPS) == pytest.approx(1e3)
    assert _outside_ms(t) == pytest.approx(0.0)


def test_idle_with_no_span_open_is_outside():
    # idle [16, 18]: after trainer.replan ends, before the window's end
    k = [("k1", 0.0, 16.0), ("k2", 18.0, 20.0)]
    t = _trace(k, STEP + [_launch(0.5), _launch(1.2)])
    assert sp.idle_ms(t, sp.IN_STEP + sp.BETWEEN_STEPS) == 0.0
    assert _outside_ms(t) == pytest.approx(2e3)


def test_replan_ms_is_the_mean_look():
    host = STEP + [("trainer.replan", 17.0, 20.0)]
    assert harness.reader("replan_ms")(_run(_trace([], host))) == \
        pytest.approx(2000.0)


@pytest.mark.parametrize("name", sorted(READERS))
def test_a_reader_without_a_trace_or_spans_reads_nothing(name):
    read = harness.reader(name)
    assert read(_run(None)) is None
    # a program without spans (the trace still holds its kernels)
    k = [("k1", 0.0, 1.0)]
    assert read(_run(_trace(k, [("aten::mm", 0.0, 0.5), _launch(0.1)]))) \
        is None


@pytest.mark.parametrize("name", sorted(READERS))
def test_the_six_entries_are_found_with_their_files(name):
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    e = {m["name"]: m for m in b["per_layer"]}[name]
    assert e["layer"] == READERS[name] and e["source"] == "device_trace"
    assert e["unit"] == "ms" and e["better"] == "lower"
    assert (ROOT / "bench" / "metrics" / f"{name}.py").is_file()
    want = ({"lm1b-zipf"} if name == "replan_ms"
            else {"lm1b-zipf", "phi3-dense"})
    assert set(e["workloads"]) == want
    for w in ("lm1b-zipf", "phi3-dense"):
        names = {m["name"] for m in harness.load_cell(w).per_layer}
        assert (name in names) is (w in want)


def test_a_traced_tiny_run_reads_the_spans(tiny_root):
    """The tiny LM traced on the CPU (no kernels): the span readers run on
    the real harness's trace, the idle split adds up to the window."""
    cell = harness.load_cell("tiny-lm", tiny_root)
    out = harness.run_cell(cell, 7, 0.2, True, t0=time.monotonic(),
                           device="cpu")
    got = out["metrics"]
    assert {"span_ms.update", "span_ms.xent", "span_ms.embed",
            "idle_ms.in_step", "idle_ms.between_steps"} <= set(got)
    assert got["span_ms.update"]["value"] == 0.0
    steps = cell.config["harness"]["trace_steps"]
    idle_ms = 1e3 * out["device"]["window_s"] / steps
    split = got["idle_ms.in_step"]["value"] + \
        got["idle_ms.between_steps"]["value"]
    assert 0.5 * idle_ms < split <= idle_ms * (1 + 1e-9)
