"""Device time a step of the matrix products (``trace.kernel_class``
"gemm": the models' dense layers and the head), summed over kernels."""


def read(run):
    t = run.trace
    return None if t is None else 1e3 * t.class_seconds("gemm") / t.steps
