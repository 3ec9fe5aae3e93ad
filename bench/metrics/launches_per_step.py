"""Kernels launched a step: the traced stretch's kernels (copies and fills
not counted) over its steps."""


def read(run):
    return None if run.trace is None else len(run.trace.kernels) / run.trace.steps
