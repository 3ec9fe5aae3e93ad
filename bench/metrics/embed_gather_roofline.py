"""``embed_gather``'s share of its roofline: the least time of each traced
launch (``counters.gather_bytes`` of that step's buffer and distinct ids
over the HBM peak) summed, over the launches' summed kernel time, in %.
One launch a step is expected; otherwise nothing is read."""
from bench import counters
from bench.trace import PORT_KERNELS


def read(run):
    if run.trace is None:
        return None
    ks = run.trace.launches(PORT_KERNELS["embed_gather"])
    if not ks or len(ks) != len(run.steps):
        return None
    row = run.width * run.table_itemsize
    least = sum(counters.least_seconds(
        counters.gather_bytes(s["capacity"], s["unique"], row))
        for s in run.steps)
    return 100.0 * least / sum(e - b for _, b, e in ks)
