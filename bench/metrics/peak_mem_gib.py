"""The fullest device's ``torch.cuda.max_memory_allocated`` over the run,
in GiB."""


def read(run):
    return max(r["peak"] for r in run.ranks) / 2 ** 30
