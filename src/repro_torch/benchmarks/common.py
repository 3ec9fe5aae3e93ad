"""Benchmark helpers of the port (its counterpart of the repo-level
``benchmarks/common.py``): the CSV line every benchmark prints, a median
timer that synchronises the card, and ranks on a process mesh in place of
the reference's 512 fake devices.

A benchmark runs on the card unless it is asked for the CPU; a CPU run's
times say how fast PyTorch's CPU kernels are, and each line names its
device.
"""
from __future__ import annotations

import math
import os
import time

import torch

from repro_torch.launch.mesh import spawn

# results/ at the repo root (listed in .gitignore)
RESULTS = os.path.abspath(os.path.join(os.path.dirname(__file__), "..",
                                       "..", "..", "results"))


def emit(name: str, us_per_call: float, derived: str) -> None:
    """One ``name,us_per_call,derived`` CSV line (the reference's)."""
    print(f"{name},{us_per_call:.1f},{derived}", flush=True)


def device_name(device) -> str:
    dev = torch.device(device)
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


WARMUP, ITERS = 2, 5


def time_fn(fn, *args, device="cuda") -> float:
    """Median wall seconds of ``ITERS`` calls of ``fn(*args)`` after
    ``WARMUP``; on the card each call ends in a ``synchronize``."""
    sync = (torch.cuda.synchronize if torch.device(device).type == "cuda"
            else (lambda: None))
    for _ in range(WARMUP):
        fn(*args)
    sync()
    times = []
    for _ in range(ITERS):
        t0 = time.perf_counter()
        fn(*args)
        sync()
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]


def run_on_mesh(fn, shape: tuple, device: str = "cuda",
                args: tuple = ()) -> list:
    """``fn(rank, world, shape, *args)`` on ``prod(shape)`` ranks of one
    gloo process group (``launch/mesh.py::spawn``: several ranks share one
    card over gloo, whose staging through the host makes their times no
    exchange times) -> each rank's result. ``fn`` lives at module level
    and its results pickle (numpy, not tensors)."""
    return spawn(fn, math.prod(shape), "gloo", device,
                 args=(tuple(shape),) + tuple(args), timeout=900.0)
