"""Parameters from the JAX package into the port, bit for bit.

torch and ``jax.random`` draw different numbers from the same seed, so a
parity test initializes the reference model, flattens it to
``{dotted_name: numpy array}`` (the names of ``repro/utils/tree.py::
path_name``) and hands that dict here. Nothing here imports JAX: bf16
arrays arrive as numpy arrays of the ``bfloat16`` extension dtype and are
moved through a 16-bit integer view, so no bit changes.

On a mesh, ``shard_params`` cuts whole parameters into this rank's shards
(each ``ParamPlan.held``) and ``gather_params`` puts them back together;
the tests hold the port's sharded state against the JAX package with them.
"""
from __future__ import annotations

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


def shard_tensor(full: torch.Tensor, held: tuple, mesh) -> torch.Tensor:
    """This rank's block of ``full`` under ``held``: along each sharded
    dimension, block ``mesh.index(axes)`` of ``mesh.axes_size(axes)``."""
    out = full
    for d, axes in _dims(held, mesh):
        n = mesh.axes_size(axes)
        size = full.shape[d] // n
        out = out.narrow(d, mesh.index(axes) * size, size)
    return out.contiguous()


def gather_tensor(local: torch.Tensor, held: tuple, mesh) -> torch.Tensor:
    """The whole tensor from every rank's ``shard_tensor`` block (a
    collective over the held axes: every rank of them calls it)."""
    out = local
    for d, axes in _dims(held, mesh):
        out = coll.all_gather(out, axes, mesh, dim=d)
    return out


def shard_params(named_full: dict, plan, mesh) -> dict:
    """{dotted_name: whole tensor} -> {dotted_name: this rank's shard}
    under each parameter's ``ParamPlan.held``."""
    return {n: shard_tensor(t, plan.params[n].held, mesh)
            for n, t in named_full.items()}


def gather_params(named_local: dict, plan, mesh) -> dict:
    """This rank's shards -> the whole tensors (on every rank)."""
    return {n: gather_tensor(t, plan.params[n].held, mesh)
            for n, t in named_local.items()}
