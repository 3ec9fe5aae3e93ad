"""Device time a step of the kernels launched inside the program's
``xent.forward`` and ``xent.backward`` spans: the loss's passes over the
logits, forward and backward (the head's product is not in them)."""
from bench import spans


def read(run):
    return spans.device_ms(run.trace, ("xent.forward", "xent.backward"))
