"""Parameters from the JAX package into the port, bit for bit.

torch and ``jax.random`` draw different numbers from the same seed, so a
parity test initializes the reference model, flattens it to
``{dotted_name: numpy array}`` (the names of ``repro/utils/tree.py::
path_name``) and hands that dict here. Nothing here imports JAX: bf16
arrays arrive as numpy arrays of the ``bfloat16`` extension dtype and are
moved through a 16-bit integer view, so no bit changes.
"""
from __future__ import annotations

import numpy as np
import torch

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
