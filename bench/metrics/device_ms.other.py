"""Device time a step of the kernels that are neither matrix products, nor
NCCL's, nor the port's own (``trace.kernel_class`` "other": the xent's
passes, the optimizer's chain, the LSTM's and the norms' elementwise work,
the dedupe's sort), summed over kernels."""


def read(run):
    t = run.trace
    return None if t is None else 1e3 * t.class_seconds("other") / t.steps
