"""Device idle time a step while the trainer's thread is in one of the
program's spans between steps (``spans.BETWEEN_STEPS``: the batch's draw
and upload, the metrics transfer, the profile's notes, the replan's look,
a checkpoint, the elastic decision)."""
from bench import spans


def read(run):
    return spans.idle_ms(run.trace, spans.BETWEEN_STEPS)
