"""The program's spans in a traced stretch (``trace.Trace``): the device
time of the kernels launched inside each span, the device's idle time
split by the trainer span open over it, and the host time of a span.

The program marks the layers of a training step with
``torch.profiler.record_function`` ranges (``repro_torch/utils/
spans.py``); they are host events of the trace, on the kernels' clock.
``SPANS`` is a frozen copy of their names, as ``trace.py`` keeps a copy of
the program's idle arithmetic: a renamed span reads as missing here, and
its metrics fall silent, rather than change meaning.

A kernel belongs to the spans open at its launch: the start of the CUDA
call that enqueued it, on whichever thread (the backward's spans are
entered on autograd's thread while the trainer's thread waits in
``step.backward``, so time containment decides, not the thread). The
trace keeps no correlation id, so kernels and launch calls are paired in
order: the program launches every kernel on one stream, where the device
runs them in the order the calls enqueue them, and the host makes one
call at a time. (A kernel may read as starting before its own call: the
device's clock is mapped onto the host's with an offset of up to ~80 us
on the H100, which is why the pairing goes by order and not by time.)
The pairing is kept only where the counts agree and no kernel is
NCCL's, which runs on streams of its own; otherwise every kernel is
counted unmatched and no kernel time is given a span.

Idle time is the trace's own (``trace.gaps`` of every kernel and copy):
each idle stretch is split over the trainer spans open on the trainer's
thread across it, a stretch crossing a span's edge in parts; what no
trainer span covers is ``outside`` (the benchmark's own loop and
callback, the profiler's buffer requests).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from bench import trace as tracing

SPANS = ("trainer.batch", "trainer.step", "step.forward", "embed.pull",
         "xent.forward", "step.backward", "xent.backward", "embed.push",
         "step.exchange", "step.update", "trainer.metrics", "trainer.profile",
         "trainer.replan", "trainer.ckpt", "trainer.decide")
# the trainer's spans, on its own thread, none inside another
IN_STEP = ("trainer.step",)
BETWEEN_STEPS = ("trainer.batch", "trainer.metrics", "trainer.profile",
                 "trainer.replan", "trainer.ckpt", "trainer.decide")
# host calls that enqueue one kernel each: the CUDA runtime's (cuda*) and
# the lower-level API's (cu*)
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC",
                "cudaLaunchCooperativeKernel", "cuLaunchKernel",
                "cuLaunchKernelEx", "cuLaunchCooperativeKernel")


@dataclass
class Spans:
    """The spans of a trace: {name: sorted [start, end]}, each kernel's
    launch time (None where unpaired) beside ``trace.kernels``, and the
    count of kernels no launch call was paired with."""
    spans: dict
    launched: list
    unmatched: int

    def intervals(self, names) -> list:
        return sorted(iv for n in names for iv in self.spans.get(n, ()))


def device_ms(trace: Optional[tracing.Trace], names) -> Optional[float]:
    """Kernel time a step (summed, not a union) of the kernels launched
    inside any span of ``names``, those of nested spans included; None
    without a trace, where no span of ``names`` is in it, or where a
    kernel went unpaired."""
    sp = of(trace)
    ivs = sp.intervals(names) if sp else []
    if not ivs or sp.unmatched:
        return None
    return 1e3 * sum(e - s for (_, s, e), t in zip(trace.kernels, sp.launched)
                     if _within(t, ivs)) / trace.steps


def idle_ms(trace: Optional[tracing.Trace], names) -> Optional[float]:
    """Device idle time a step while a span of ``names`` was open; None
    without a trace or where no span of ``names`` is in it."""
    sp = of(trace)
    ivs = sp.intervals(names) if sp else []
    if not ivs:
        return None
    busy = [(s, e) for _, s, e in trace.kernels + trace.copies]
    idle = tracing.gaps(busy, trace.start, trace.end)
    return 1e3 * tracing.overlap(idle, ivs) / trace.steps


def host_s(trace: Optional[tracing.Trace], name: str) -> list:
    """The length of each ``name`` span, in start order."""
    sp = of(trace)
    return [e - s for s, e in sp.spans.get(name, ())] if sp else []


def _within(t, ivs: list) -> bool:
    return t is not None and any(s <= t <= e for s, e in ivs)


def _pair(kernels: list, calls: list) -> tuple:
    """(each kernel's launch time, unmatched): the i-th kernel to start
    takes the i-th call."""
    if len(kernels) != len(calls) or any(
            tracing.kernel_class(k[0]) == "nccl" for k in kernels):
        return [None] * len(kernels), len(kernels)
    order = sorted(range(len(kernels)), key=lambda i: kernels[i][1])
    launched = [None] * len(kernels)
    for i, t in zip(order, calls):
        launched[i] = t
    return launched, 0


def of(trace: Optional[tracing.Trace]) -> Optional[Spans]:
    """The spans of ``trace`` (None without a trace)."""
    if trace is None:
        return None
    spans: dict = {}
    calls = []
    for name, s, e in trace.host:
        if name in SPANS:
            spans.setdefault(name, []).append([s, e])
        elif name in LAUNCH_CALLS:
            calls.append((s, e))
    calls.sort()
    # a cu* call made inside a cuda* call enqueues the same kernel
    outer: list = []
    for s, e in calls:
        if outer and e <= outer[-1][1]:
            continue
        outer.append((s, e))
    launched, unmatched = _pair(trace.kernels, [s for s, _ in outer])
    return Spans(spans={n: sorted(v) for n, v in spans.items()},
                 launched=launched, unmatched=unmatched)
