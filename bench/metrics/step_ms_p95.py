"""The 95th percentile of the window's step times (host clock, rank 0; the
ranks of a mesh step together), linear between ranks."""
import numpy as np


def read(run):
    return float(np.percentile(run.window["step_s"], 95)) * 1e3
