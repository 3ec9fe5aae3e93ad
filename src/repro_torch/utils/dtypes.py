"""dtype names as the configs spell them <-> torch dtypes."""
from __future__ import annotations

import torch

_BY_NAME = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}


def torch_dtype(dt) -> torch.dtype:
    """'bfloat16' (or a torch dtype) -> torch.bfloat16."""
    if isinstance(dt, torch.dtype):
        return dt
    try:
        return _BY_NAME[str(dt)]
    except KeyError:
        raise ValueError(f"unsupported dtype {dt!r}; "
                         f"known: {sorted(_BY_NAME)}") from None


def dtype_name(dt) -> str:
    """torch.bfloat16 -> 'bfloat16' (the name the JAX package prints)."""
    return str(torch_dtype(dt)).removeprefix("torch.")
