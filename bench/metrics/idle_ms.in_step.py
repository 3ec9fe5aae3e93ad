"""Device idle time a step while the trainer's thread is in the program's
``trainer.step`` span, launching the step: the device waiting on the
host's launches (``spans.idle_ms``)."""
from bench import spans


def read(run):
    return spans.idle_ms(run.trace, spans.IN_STEP)
