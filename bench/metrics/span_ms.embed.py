"""Device time a step of the kernels launched inside the program's
``embed.pull`` and ``embed.push`` spans: the dedupe's sort, the gather,
the segment sum and the scatter (and a push's exchange on a mesh)."""
from bench import spans


def read(run):
    return spans.device_ms(run.trace, ("embed.pull", "embed.push"))
