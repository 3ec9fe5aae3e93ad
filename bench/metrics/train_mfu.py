"""The whole step's share of the card's bf16 peak: the benchmark's counted
operations of this rank's steps in the measured window
(``counters.train_step_flops``, no recomputation) over the window and the
peak, in %. On a mesh every rank counts its own rows: the mean over the
ranks is all ranks' operations over the ranks' peaks."""
from bench import counters


def read(run):
    w = run.window
    return 100.0 * run.flops_per_step * w["steps"] / w["seconds"] \
        / counters.PEAK_BF16_FLOPS
