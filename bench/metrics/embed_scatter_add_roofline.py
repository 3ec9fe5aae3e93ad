"""``embed_scatter_add``'s (the one-pass push's) share of its roofline:
the least time of each traced launch (``counters.scatter_bytes``: the
buffer's ids, the distinct ids' rows, the (rows, width) f32 gradient
written once) summed, over the launches' summed kernel time, in %. One
launch a step is expected; otherwise (a push that takes the accumulating
plain scatter, as ``mpi_gatherv``'s does) nothing is read."""
from bench import counters
from bench.trace import PORT_KERNELS


def read(run):
    if run.trace is None:
        return None
    ks = run.trace.launches(PORT_KERNELS["embed_scatter_add"])
    if not ks or len(ks) != len(run.steps):
        return None
    row = run.width * run.wire_itemsize
    least = sum(counters.least_seconds(counters.scatter_bytes(
        s["capacity"], s["unique"], row, run.table_rows, run.width))
        for s in run.steps)
    return 100.0 * least / sum(e - b for _, b, e in ks)
