"""Parameters from the JAX package into the port, bit for bit.

torch and ``jax.random`` draw different numbers from the same seed, so a
parity test initializes the reference model, flattens it to
``{dotted_name: numpy array}`` (the names of ``repro/utils/tree.py::
path_name``) and hands that dict here. Nothing here imports JAX: bf16
arrays arrive as numpy arrays of the ``bfloat16`` extension dtype and are
moved through a 16-bit integer view, so no bit changes.

On a mesh, ``shard_tensor`` cuts a whole parameter into this rank's shard
(its ``ParamPlan.held``, laid out by ``ParamPlan.groups``: the LSTM's
gate leaves hold a rank's units of each of the four gates) and
``gather_params`` puts the shards back together in the reference's
layout; the tests hold the port's sharded state against the JAX package
with it.
``gather_state`` / ``shard_state`` do the same for a whole canonical
``TrainState`` (the parameters and EMA shadows by ``held``, the moments by
``opt_held``; a staleness buffer's gradient by its table's ``held``, its
age as it is): a replan whose placements moved, a remesh, and a
checkpoint's save and restore, carry the state whole between two plans'
placements. Under
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

def block_dims(held: tuple, mesh, groups: tuple = ()) -> list:
    """[(dim, axes, groups)] of a held placement's sharded dimensions
    (``groups``: ``ParamPlan.groups``, 1 on every dimension if empty)."""
    groups = groups or (1,) * len(held)
    return [(d, entry_axes(e), g) for d, (e, g) in enumerate(zip(held, groups))
            if mesh.axes_size(entry_axes(e)) > 1]


def block_of(t: torch.Tensor, dims: list, mesh) -> torch.Tensor:
    """This rank's block of ``t`` along ``dims`` ([(dim, axes, groups)]):
    on each dimension, the dimension cut into ``groups`` equal groups and
    block ``mesh.index(axes)`` of ``mesh.axes_size(axes)`` taken from each
    (one contiguous block where ``groups`` is 1: then a view)."""
    for d, axes, g in dims:
        k = mesh.axes_size(axes)
        if t.shape[d] % (k * g):
            raise ValueError(f"dim {d} of {tuple(t.shape)} does not split "
                             f"into {g} groups over {k} ranks")
        size = t.shape[d] // (k * g)
        lo = mesh.index(axes) * size
        if g == 1:
            t = t.narrow(d, lo, size)
        else:
            t = t.unflatten(d, (g, k * size)).narrow(d + 1, lo, size) \
                .flatten(d, d + 1)
    return t


def gather_blocks(t: torch.Tensor, dims: list, mesh) -> torch.Tensor:
    """The tensor every rank's ``block_of`` came from (a collective over
    each dimension's axes, in the block order ``P(axes)`` gives: the
    first axis major; a grouped dimension's blocks interleaved back into
    their groups)."""
    for d, axes, g in dims:
        t = coll.all_gather(t, axes, mesh, dim=d)
        if g > 1:
            k = mesh.axes_size(axes)
            t = t.unflatten(d, (k, g, -1)).transpose(d, d + 1) \
                .flatten(d, d + 2)
    return t


def shard_shape(shape: tuple, held: tuple, mesh) -> tuple:
    """The shape of this rank's block of a ``shape`` leaf under
    ``held``."""
    out = list(shape)
    for d, axes, _ in block_dims(held, mesh):
        out[d] //= mesh.axes_size(axes)
    return tuple(out)


def shard_tensor(full: torch.Tensor, held: tuple, mesh,
                 groups: tuple = ()) -> torch.Tensor:
    """This rank's block of ``full`` under ``held`` (and ``groups``)."""
    return block_of(full, block_dims(held, mesh, groups), mesh).contiguous()


def gather_tensor(local: torch.Tensor, held: tuple, mesh,
                  groups: tuple = ()) -> torch.Tensor:
    """The whole tensor from every rank's ``shard_tensor`` block (a
    collective over the held axes: every rank of them calls it)."""
    return gather_blocks(local, block_dims(held, mesh, groups), mesh)


def gather_params(named_local: dict, plan, mesh) -> dict:
    """This rank's shards -> the whole tensors (on every rank)."""
    return {n: gather_tensor(t, plan.params[n].held, mesh,
                             plan.params[n].groups)
            for n, t in named_local.items()}


def opt_dims(held: tuple, opt_held: tuple, mesh) -> list:
    """[(dim, axes, 1)] of the dimensions ``opt_held`` shards (over more
    than one rank) and ``held`` does not: where a ZeRO-1 leaf's optimizer
    state is this rank's (contiguous) block of its parameter. Empty where
    the two agree."""
    out = []
    for d, (h, o) in enumerate(zip(held, opt_held)):
        axes = entry_axes(o)
        if entry_axes(h) == axes or mesh.axes_size(axes) <= 1:
            continue
        if mesh.axes_size(entry_axes(h)) > 1:
            raise ValueError(f"dim {d}: optimizer state on {o!r} apart from "
                             f"its parameter's {h!r}")
        out.append((d, axes, 1))
    return out


# TrainState's per-parameter parts (optim/optimizer.py), in the order a
# checkpoint lists them, and the placement each part lies on
STATE_PARTS = ("params", "m", "v", "ema")
PART_PLACEMENT = {"params": "held", "m": "opt_held", "v": "opt_held",
                  "ema": "held"}


def _placed(plan, part: str, name: str) -> tuple:
    """(placement, groups) of one part of a leaf's state."""
    p = plan.params[name]
    return getattr(p, PART_PLACEMENT[part]), p.groups


def _stale_part(stale: dict, fn) -> dict:
    """The staleness buffers with ``fn(name, g)`` applied to each table's
    gradient buffer (its age, a replicated scalar, as it is)."""
    return {n: {"g": fn(n, b["g"]), "age": b["age"]}
            for n, b in stale.items()}


def gather_state(state, plan, mesh):
    """A canonical TrainState of this rank's shards under ``plan`` (the
    moments by ``opt_held``) -> the same state with every leaf whole (a
    collective: every rank calls it). Off a mesh the state is returned as
    it is."""
    if mesh is None:
        return state

    def whole(part, n, t):
        held, groups = _placed(plan, part, n)
        return gather_tensor(t, held, mesh, groups)

    out = {part: None if getattr(state, part) is None else
           {n: whole(part, n, t) for n, t in getattr(state, part).items()}
           for part in STATE_PARTS}
    if state.stale is not None:
        out["stale"] = _stale_part(state.stale,
                                   lambda n, g: whole("params", n, g))
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
        held, groups = _placed(plan, part, n)
        return shard_tensor(t, held, mesh, groups)

    out = {part: None if getattr(state, part) is None else
           {n: cut(part, n, t) for n, t in getattr(state, part).items()}
           for part in STATE_PARTS}
    if state.stale is not None:
        out["stale"] = _stale_part(state.stale,
                                   lambda n, g: cut("params", n, g))
    return replace(state, **out)
