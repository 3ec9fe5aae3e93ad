"""Training throughput: every token of every step in the window (the global
batch on a mesh) over the window's length, on the host's clock."""


def read(run):
    w = run.window
    return w["steps"] * run.cell.tokens_per_step / w["seconds"]
