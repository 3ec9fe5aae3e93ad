"""Host time of one replan look: the mean length of the program's
``trainer.replan`` spans in the traced stretch."""
import statistics

from bench import spans


def read(run):
    looks = spans.host_s(run.trace, "trainer.replan")
    return 1e3 * statistics.fmean(looks) if looks else None
