"""The share of the traced stretch in which no operation ran on this rank's
device: 1 - the union of every kernel's and copy's interval, on every
stream, over the stretch (``trace.Trace.idle_share``), in %."""


def read(run):
    return None if run.trace is None else 100.0 * run.trace.idle_share()
