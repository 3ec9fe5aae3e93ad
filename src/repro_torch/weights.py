"""Parameters from the JAX package into the port, bit for bit.

torch and ``jax.random`` draw different numbers from the same seed, so a
parity test initializes the reference model, flattens it to
``{dotted_name: numpy array}`` (the names of ``repro/utils/tree.py::
path_name``) and hands that dict here. Nothing here imports JAX: bf16
arrays arrive as numpy arrays of the ``bfloat16`` extension dtype and are
moved through a 16-bit integer view, so no bit changes.

On a mesh, ``shard_tensor`` cuts a whole parameter into this rank's shard
(its ``ParamPlan.held``) and ``gather_params`` puts the shards back
together; the tests hold the port's sharded state against the JAX package
with it.
``gather_state`` / ``shard_state`` do the same for a whole canonical
``TrainState`` (the parameters and EMA shadows by ``held``, the moments by
``opt_held``): a replan whose placements moved, and a checkpoint's save
and restore, carry the state whole between two plans' placements. Under
ZeRO-1 ``opt_dims`` names the dimensions the moments are sharded over
apart from their parameter; ``block_of`` cuts a parameter-shaped tensor
to that block and ``gather_blocks`` puts the blocks back together.
"""
from __future__ import annotations

from dataclasses import replace

import numpy as np
import torch

from repro_torch.core import collectives as coll
from repro_torch.core.plan import entry_axes

_NUMPY_TO_TORCH = {
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float16): torch.float16,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
}


def to_torch(a: np.ndarray, device) -> torch.Tensor:
    """One numpy array -> a tensor on ``device`` with identical bits."""
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    if a.dtype not in _NUMPY_TO_TORCH:
        raise ValueError(f"unsupported dtype {a.dtype}")
    return torch.from_numpy(a.copy()).to(device)


def load_reference_params(named: dict, device) -> dict:
    """{dotted_name: numpy array} -> {dotted_name: tensor on ``device``},
    ready for ``get_runner(..., params=...)``."""
    return {n: to_torch(np.asarray(a), device) for n, a in named.items()}


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor -> numpy for comparison with the reference: bf16 widens to
    f32 (exactly)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


# ---------------------------------------------------------------------------
# shards on a mesh
# ---------------------------------------------------------------------------

def _dims(held: tuple, mesh) -> list:
    """[(dim, axes)] of a held placement's sharded dimensions."""
    return [(d, entry_axes(e)) for d, e in enumerate(held)
            if mesh.axes_size(entry_axes(e)) > 1]


def block_of(t: torch.Tensor, dims: list, mesh) -> torch.Tensor:
    """This rank's block of ``t`` along ``dims`` ([(dim, axes)]): block
    ``mesh.index(axes)`` of ``mesh.axes_size(axes)`` on each; a view."""
    for d, axes in dims:
        size = t.shape[d] // mesh.axes_size(axes)
        t = t.narrow(d, mesh.index(axes) * size, size)
    return t


def gather_blocks(t: torch.Tensor, dims: list, mesh) -> torch.Tensor:
    """The tensor every rank's ``block_of`` came from (a collective over
    each dimension's axes, in the block order ``P(axes)`` gives: the
    first axis major)."""
    for d, axes in dims:
        t = coll.all_gather(t, axes, mesh, dim=d)
    return t


def shard_tensor(full: torch.Tensor, held: tuple, mesh) -> torch.Tensor:
    """This rank's block of ``full`` under ``held``."""
    return block_of(full, _dims(held, mesh), mesh).contiguous()


def gather_tensor(local: torch.Tensor, held: tuple, mesh) -> torch.Tensor:
    """The whole tensor from every rank's ``shard_tensor`` block (a
    collective over the held axes: every rank of them calls it)."""
    return gather_blocks(local, _dims(held, mesh), mesh)


def gather_params(named_local: dict, plan, mesh) -> dict:
    """This rank's shards -> the whole tensors (on every rank)."""
    return {n: gather_tensor(t, plan.params[n].held, mesh)
            for n, t in named_local.items()}


def opt_dims(held: tuple, opt_held: tuple, mesh) -> list:
    """[(dim, axes)] of the dimensions ``opt_held`` shards (over more than
    one rank) and ``held`` does not: where a ZeRO-1 leaf's optimizer state
    is this rank's block of its parameter. Empty where the two agree."""
    out = []
    for d, (h, o) in enumerate(zip(held, opt_held)):
        axes = entry_axes(o)
        if entry_axes(h) == axes or mesh.axes_size(axes) <= 1:
            continue
        if mesh.axes_size(entry_axes(h)) > 1:
            raise ValueError(f"dim {d}: optimizer state on {o!r} apart from "
                             f"its parameter's {h!r}")
        out.append((d, axes))
    return out


# TrainState's per-parameter parts (optim/optimizer.py), in the order a
# checkpoint lists them, and the placement each part lies on
STATE_PARTS = ("params", "m", "v", "ema")
PART_PLACEMENT = {"params": "held", "m": "opt_held", "v": "opt_held",
                  "ema": "held"}


def _placed(plan, part: str, name: str) -> tuple:
    return getattr(plan.params[name], PART_PLACEMENT[part])


def gather_state(state, plan, mesh):
    """A canonical TrainState of this rank's shards under ``plan`` (the
    moments by ``opt_held``) -> the same state with every leaf whole (a
    collective: every rank calls it). Off a mesh the state is returned as
    it is."""
    if mesh is None:
        return state
    out = {part: None if getattr(state, part) is None else
           {n: gather_tensor(t, _placed(plan, part, n), mesh)
            for n, t in getattr(state, part).items()}
           for part in STATE_PARTS}
    return replace(state, **out)


def shard_state(state, plan, mesh, whole_shapes: dict):
    """A canonical TrainState -> this rank's shards under ``plan`` (the
    moments by ``opt_held``). A leaf is cut only where it has its whole
    shape (``whole_shapes[name]``): a leaf already in this plan's shard
    shape stays as it is, so a state whose placements held passes through
    untouched."""
    if mesh is None:
        return state

    def cut(part, n, t):
        if tuple(t.shape) != tuple(whole_shapes[n]):
            return t
        return shard_tensor(t, _placed(plan, part, n), mesh)

    out = {part: None if getattr(state, part) is None else
           {n: cut(part, n, t) for n, t in getattr(state, part).items()}
           for part in STATE_PARTS}
    return replace(state, **out)
