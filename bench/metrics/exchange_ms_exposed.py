"""NCCL kernel time a step that no other kernel overlaps
(``trace.Trace.exposed_nccl_s``): the exchange the step waits for. Read on
a mesh only."""


def read(run):
    t = run.trace
    if t is None or run.world == 1:
        return None
    return 1e3 * t.exposed_nccl_s() / t.steps
