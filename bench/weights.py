"""The benchmark's weights: every leaf drawn on the device from the run's
seed, in the dtype it is trained in, one call a leaf.

Each leaf has a generator of its own, seeded from (seed, the leaf's name),
so one leaf can be drawn again alone: the reference and the check of the
parameters' change redraw the start values leaf by leaf instead of holding
a copy of the model. Leaves and their draws come from
``reference.leaf_specs``: the benchmark's own description of the model,
which the port's parameters must match by name and shape.
"""
from __future__ import annotations

import zlib

import numpy as np
import torch


def leaf_seed(seed: int, name: str) -> int:
    """A 63-bit seed for leaf ``name`` of run ``seed``."""
    ss = np.random.SeedSequence([int(seed), zlib.crc32(name.encode())])
    return int(ss.generate_state(1, dtype=np.uint64)[0] >> np.uint64(1))


def draw_leaf(spec, seed: int, dtype: torch.dtype, device) -> torch.Tensor:
    """Leaf ``spec`` (a ``reference.Leaf``) of run ``seed``."""
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dtype, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(leaf_seed(seed, spec.name))
    out = torch.randn(spec.shape, generator=gen, dtype=dtype, device=device)
    return out.mul_(spec.std)


def draw_all(specs: list, seed: int, dtype: torch.dtype, device) -> dict:
    """{name: leaf} of every spec."""
    return {s.name: draw_leaf(s, seed, dtype, device) for s in specs}
