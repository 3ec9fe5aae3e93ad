"""Named spans at the layer boundaries of a training step, for
``torch.profiler``.

``span(name)`` is a context manager. While torch's profiler collects, it
is ``torch.profiler.record_function(name)``: a host event in the same
kineto trace as the kernels, so a span shares the device trace's clock,
and the kernels launched inside it are the span's. Otherwise it costs one
read of the profiler's enabled flag and hands back a shared null context:
no allocation, no clock, no option to set.

Every span (parent in brackets), where it is entered, and the benchmark
metric that reads it (``bench/metrics/``: ``span_ms.*`` sum the device
time of the kernels launched inside a span, ``idle_ms.*`` split the
device's idle time by the trainer span open over it):

  trainer.batch    runtime/trainer.py::Trainer.run: the batch's draw and
                   upload                               idle_ms.between_steps
  trainer.step     Trainer.run: the step's launches     idle_ms.in_step
  step.forward     (trainer.step) core/transform.py, both value-and-grad
                   functions: ``model.loss_fn``
  embed.pull       (step.forward) core/embedding.py::_Lookup.forward: the
                   dedupe and the gather                span_ms.embed
  xent.forward     (step.forward) core/xent.py::_Xent.forward: the loss
                   over the logits (the head's product is outside)
                                                        span_ms.xent
  step.backward    (trainer.step) ``loss.backward()``, with the buckets
                   that overlap it
  xent.backward    (step.backward) _Xent.backward, on autograd's thread
                                                        span_ms.xent
  embed.push       (step.backward) _Lookup.backward, on autograd's
                   thread; (step.exchange) ``deferred_push`` after a
                   mesh's backward: the scatter         span_ms.embed
  step.exchange    (trainer.step) the gradients' exchange after the
                   backward (one device: the wire cast alone)
  step.update      (trainer.step) make_train_step: the staleness rule and
                   the optimizer's update, clipping included
                                                        span_ms.update
  trainer.metrics  Trainer.run: ``host_scalars``, the host's one wait for
                   the device a step                    idle_ms.between_steps
  trainer.profile  Trainer.run: the profile's and the monitor's notes
                                                        idle_ms.between_steps
  trainer.replan   Trainer.run: ``maybe_replan``        replan_ms and
                                                        idle_ms.between_steps
  trainer.ckpt     Trainer.run: the checkpoint's save   idle_ms.between_steps
  trainer.decide   Trainer.run: the elastic decision and its action
                                                        idle_ms.between_steps

No span sits inside a per-time-step, per-layer or per-leaf loop: a step
enters about 14 (two more per extra embedding table).
"""
from __future__ import annotations

import contextlib

from torch.autograd import profiler as _profiler

NAMES = ("trainer.batch", "trainer.step", "step.forward", "embed.pull",
         "xent.forward", "step.backward", "xent.backward", "embed.push",
         "step.exchange", "step.update", "trainer.metrics", "trainer.profile",
         "trainer.replan", "trainer.ckpt", "trainer.decide")

_NULL = contextlib.nullcontext()


def span(name: str):
    """A context manager: ``record_function(name)`` while the profiler
    collects, else a shared no-op."""
    if not _profiler._is_profiler_enabled:
        return _NULL
    return _profiler.record_function(name)
