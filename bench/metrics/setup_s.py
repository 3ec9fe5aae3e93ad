"""Set-up: from the start of the benchmark's process to the start of the
window (kernel builds, the trainer's build, the weights, the compared and
warm-up steps)."""


def read(run):
    return run.setup_s
