"""Device time a step of the kernels launched inside the program's
``step.update`` span: the staleness rule and the optimizer's update,
clipping included (``spans.device_ms``), summed over kernels."""
from bench import spans


def read(run):
    return spans.device_ms(run.trace, ("step.update",))
