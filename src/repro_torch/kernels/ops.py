"""Public wrappers of the embedding kernels (the port of
``repro/kernels/ops.py``).

Dispatch is by the tensor's device, never by a flag:
  * a CPU tensor takes the plain version (kernels/ref.py);
  * a CUDA tensor launches the hand-written kernel (csrc/*.cu, built with
    nvcc on first use by kernels/_build.py) or raises. Nothing falls back.

Each wrapper checks device, dtype, shape and contiguity before it hands a
pointer to the kernel, and carries a launch counter (``<wrapper>.launches``,
a plain integer) that it bumps where it launches the kernel and nowhere
else, so a run can show that its main path went through the kernel.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

_DTYPES = (torch.float32, torch.bfloat16)


def reset_launch_counts() -> None:
    embed_gather.launches = 0
    embed_scatter_add.launches = 0


def launch_counts() -> dict:
    return {"embed_gather": embed_gather.launches,
            "embed_scatter_add": embed_scatter_add.launches}


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")


def embed_gather(table_shard: torch.Tensor, ids: torch.Tensor,
                 row_offset: int = 0) -> torch.Tensor:
    """table_shard (Vs, E) bf16|f32; ids (N,) int32 global ids -> (N, E)
    owned rows in the table dtype, zeros for ids outside
    [row_offset, row_offset + Vs)."""
    _check(table_shard.dim() == 2, f"table must be 2-D, got "
           f"{tuple(table_shard.shape)}")
    _check(table_shard.dtype in _DTYPES,
           f"table dtype {table_shard.dtype} not in {_DTYPES}")
    _check(ids.dim() == 1 and ids.dtype == torch.int32,
           f"ids must be 1-D int32, got {ids.dtype} {tuple(ids.shape)}")
    _check(ids.device == table_shard.device,
           f"ids on {ids.device}, table on {table_shard.device}")
    if table_shard.device.type == "cpu":
        return ref.embed_gather_ref(table_shard, ids, row_offset)
    if table_shard.device.type != "cuda":
        raise NotImplementedError(
            f"embed_gather: no kernel for device {table_shard.device}")
    _check(table_shard.is_contiguous() and ids.is_contiguous(),
           "embed_gather takes contiguous tensors")
    vs, e = table_shard.shape
    n = ids.shape[0]
    out = torch.empty((n, e), dtype=table_shard.dtype,
                      device=table_shard.device)
    fn = _build.load("embed_gather")
    stream = torch.cuda.current_stream(table_shard.device).cuda_stream
    err = fn(table_shard.data_ptr(), ids.data_ptr(), out.data_ptr(), n, vs,
             e, table_shard.element_size(), int(row_offset), stream)
    _raise_on(err, "embed_gather")
    embed_gather.launches += 1
    return out


def embed_scatter_add(ids: torch.Tensor, rows: torch.Tensor,
                      vs: int) -> torch.Tensor:
    """ids (N,) int32 local-space ids, unique among owned rows (the dedupe
    buffer); rows (N, E) bf16|f32 -> (Vs, E) f32 gradient rows, zeros where
    no id lands. Unowned ids are dropped."""
    _check(rows.dim() == 2, f"rows must be 2-D, got {tuple(rows.shape)}")
    _check(rows.dtype in _DTYPES, f"rows dtype {rows.dtype} not in {_DTYPES}")
    _check(ids.dim() == 1 and ids.dtype == torch.int32
           and ids.shape[0] == rows.shape[0],
           f"ids must be (N,) int32 for N = {rows.shape[0]}, got "
           f"{ids.dtype} {tuple(ids.shape)}")
    _check(ids.device == rows.device,
           f"ids on {ids.device}, rows on {rows.device}")
    _check(vs >= 0, f"vs must be >= 0, got {vs}")
    if rows.device.type == "cpu":
        return ref.embed_scatter_add_ref(ids, rows, vs)
    if rows.device.type != "cuda":
        raise NotImplementedError(
            f"embed_scatter_add: no kernel for device {rows.device}")
    _check(rows.is_contiguous() and ids.is_contiguous(),
           "embed_scatter_add takes contiguous tensors")
    n, e = rows.shape
    # the counterpart of the TPU kernel's aliased zeros buffer; row Vs is
    # the dump row for unowned ids and is dropped below
    out = torch.zeros((vs + 1, e), dtype=torch.float32, device=rows.device)
    scatter_into(ids, rows, out, vs)
    return out[:vs]


def scatter_into(ids: torch.Tensor, rows: torch.Tensor, out: torch.Tensor,
                 vs: int) -> None:
    """The kernel launch alone, into a caller-zeroed contiguous (Vs + 1, E)
    f32 CUDA buffer: ``embed_scatter_add`` after its zero fill
    (chip_smoke.py times it on its own). Counts as a launch of
    ``embed_scatter_add``."""
    n, e = rows.shape
    _check(rows.is_cuda and ids.is_cuda and out.device == rows.device
           and ids.device == rows.device,
           "scatter_into takes CUDA tensors on one device")
    _check(ids.dtype == torch.int32 and tuple(ids.shape) == (n,)
           and ids.is_contiguous() and rows.is_contiguous()
           and rows.dtype in _DTYPES,
           "scatter_into takes contiguous (N,) int32 ids, (N, E) rows")
    _check(out.shape == (vs + 1, e) and out.dtype == torch.float32
           and out.is_contiguous(),
           f"out must be contiguous ({vs + 1}, {e}) f32")
    fn = _build.load("embed_scatter_add")
    stream = torch.cuda.current_stream(rows.device).cuda_stream
    err = fn(ids.data_ptr(), rows.data_ptr(), out.data_ptr(), n, vs, e,
             rows.element_size(), stream)
    _raise_on(err, "embed_scatter_add")
    embed_scatter_add.launches += 1


embed_gather.launches = 0
embed_scatter_add.launches = 0
