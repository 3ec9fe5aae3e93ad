"""Public wrappers of the kernels (the port of ``repro/kernels/ops.py``):
the embedding pull and push, flash attention and the RWKV6 WKV recurrence.

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

# embed_gather's bulk route (csrc/embed_gather_bulk.cu) moves rows of 16 B
# to 32 KB that are whole 16-byte units; a block of the one-pass scatter
# (csrc/embed_scatter_fused.cu) writes about 64 KB and maps at most 8,192
# rows in shared memory
_GATHER_BULK_MAX_ROW = 32768
_SCATTER_BLOCK_BYTES = 65536
_SCATTER_MAX_ROWS = 8192


_FLASH_DIMS = (16, 32, 64, 128, 160)
_FLASH_TC_DIMS = (64, 128, 160)
_WKV_DIMS = (16, 32, 64)
_WKV_TC_DIM = 64
_WKV_MAX_CHUNK = 64


def reset_launch_counts() -> None:
    embed_gather.launches = 0
    embed_gather.launches_bulk = 0
    embed_scatter_add.launches = 0
    embed_scatter_add.launches_fused = 0
    flash_attention.launches = 0
    flash_attention.launches_tc = 0
    wkv.launches = 0
    wkv.launches_tc = 0
    wkv.launches_step = 0


def launch_counts() -> dict:
    """Launches per kernel, and per route where a wrapper has several
    (``embed_gather_bulk``; ``embed_scatter_add_fused``;
    ``flash_attention_tc``; ``wkv_tc`` and ``wkv_step``), each route also
    counted in its wrapper's total."""
    return {"embed_gather": embed_gather.launches,
            "embed_gather_bulk": embed_gather.launches_bulk,
            "embed_scatter_add": embed_scatter_add.launches,
            "embed_scatter_add_fused": embed_scatter_add.launches_fused,
            "flash_attention": flash_attention.launches,
            "flash_attention_tc": flash_attention.launches_tc,
            "wkv": wkv.launches,
            "wkv_tc": wkv.launches_tc,
            "wkv_step": wkv.launches_step}


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _refuse_grad(name: str, tensors, training_route: str) -> None:
    """A forward-only kernel writes into a fresh buffer through ctypes, so
    its output would carry no ``grad_fn``: under autograd a CUDA launch
    would cut the gradient silently. Refused on every device, so a CPU run
    shows what the card would do."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} is forward-only (the reference's kernel has no "
            f"backward), and an input requires grad: train through "
            f"{training_route}, or call it under torch.no_grad()")


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")


def gather_route(row_bytes: int, table_ptr: int) -> str:
    """Which CUDA kernel ``embed_gather`` launches, from the row's bytes and
    the table's address alone: "bulk" (csrc/embed_gather_bulk.cu: each row
    one TMA bulk copy in and one out) for rows of 16 B to 32 KB that are
    whole 16-byte units of a 16-byte aligned table — every full-width
    table of the repo's models; "element" (csrc/embed_gather.cu: a thread
    per 16-byte unit or per element) otherwise, e.g. E = 100 in bf16 or a
    view whose base is off a 16-byte boundary."""
    return "bulk" if (row_bytes % 16 == 0
                      and 16 <= row_bytes <= _GATHER_BULK_MAX_ROW
                      and table_ptr % 16 == 0) else "element"


def embed_gather(table_shard: torch.Tensor, ids: torch.Tensor,
                 row_offset: int = 0) -> torch.Tensor:
    """table_shard (Vs, E) bf16|f32; ids (N,) int32 global ids -> (N, E)
    owned rows in the table dtype, zeros for ids outside
    [row_offset, row_offset + Vs). ``gather_route`` picks the kernel; both
    count in ``embed_gather.launches``, the bulk route also in
    ``embed_gather.launches_bulk``."""
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
    row_bytes = e * table_shard.element_size()
    if gather_route(row_bytes, table_shard.data_ptr()) == "element":
        return gather_element(table_shard, ids, row_offset)
    n = ids.shape[0]
    out = torch.empty((n, e), dtype=table_shard.dtype,
                      device=table_shard.device)
    fn = _build.load("embed_gather_bulk")
    stream = torch.cuda.current_stream(table_shard.device).cuda_stream
    err = fn(table_shard.data_ptr(), ids.data_ptr(), out.data_ptr(), n, vs,
             row_bytes, int(row_offset), stream)
    _raise_on(err, "embed_gather (bulk route)")
    embed_gather.launches_bulk += 1
    embed_gather.launches += 1
    return out


def gather_element(table_shard: torch.Tensor, ids: torch.Tensor,
                   row_offset: int = 0) -> torch.Tensor:
    """``embed_gather``'s element route on contiguous CUDA tensors, whatever
    the row's shape: the route for rows the bulk kernel does not take, and
    the way chip_smoke.py times this kernel beside the bulk one. Counts as
    a launch of ``embed_gather``."""
    _check(table_shard.is_cuda and ids.device == table_shard.device
           and table_shard.dim() == 2 and table_shard.dtype in _DTYPES
           and table_shard.is_contiguous(),
           "gather_element takes a contiguous (Vs, E) bf16|f32 CUDA table")
    _check(ids.dim() == 1 and ids.dtype == torch.int32
           and ids.is_contiguous(),
           "gather_element takes contiguous (N,) int32 ids")
    vs, e = table_shard.shape
    n = ids.shape[0]
    out = torch.empty((n, e), dtype=table_shard.dtype,
                      device=table_shard.device)
    fn = _build.load("embed_gather")
    stream = torch.cuda.current_stream(table_shard.device).cuda_stream
    err = fn(table_shard.data_ptr(), ids.data_ptr(), out.data_ptr(), n, vs,
             e, table_shard.element_size(), int(row_offset), stream)
    _raise_on(err, "embed_gather (element route)")
    embed_gather.launches += 1
    return out


def scatter_partition(vs: int, e: int, n: int) -> tuple:
    """The one-pass scatter's cut of [0, Vs) for (N, E) pushed rows:
    (rows per block R, grid G). R gives a block about 64 KB of f32 output,
    or more when N is large, so that no block reads more id bytes than a
    quarter of what it writes; at most 8,192 rows (the block's map). Block
    b writes rows [b * R, min((b + 1) * R, Vs)): the ranges cover [0, Vs)
    once, the last one ragged, and none is empty. G is 0 for Vs = 0."""
    _check(vs >= 0 and e >= 1 and n >= 0,
           f"scatter_partition needs vs >= 0, e >= 1, n >= 0, got {vs}, "
           f"{e}, {n}")
    row_bytes = 4 * e
    per_block = max(_SCATTER_BLOCK_BYTES // row_bytes,
                    -(-16 * n // row_bytes), 1)
    per_block = min(per_block, _SCATTER_MAX_ROWS)
    return per_block, -(-vs // per_block)


def embed_scatter_add(ids: torch.Tensor, rows: torch.Tensor,
                      vs: int) -> torch.Tensor:
    """ids (N,) int32 local-space ids, unique among owned rows (the dedupe
    buffer; in any order); rows (N, E) bf16|f32 -> (Vs, E) f32 gradient
    rows, zeros where no id lands. Unowned ids are dropped. One launch
    (csrc/embed_scatter_fused.cu) writes every row of the output once;
    counts in ``embed_scatter_add.launches`` and ``.launches_fused``."""
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
    out = torch.empty((vs, e), dtype=torch.float32, device=rows.device)
    if out.numel() == 0:
        return out
    per_block, grid = scatter_partition(vs, e, n)
    fn = _build.load("embed_scatter_fused")
    stream = torch.cuda.current_stream(rows.device).cuda_stream
    err = fn(ids.data_ptr(), rows.data_ptr(), out.data_ptr(), n, vs, e,
             rows.element_size(), per_block, grid, stream)
    _raise_on(err, "embed_scatter_add (one-pass route)")
    embed_scatter_add.launches_fused += 1
    embed_scatter_add.launches += 1
    return out


def scatter_into(ids: torch.Tensor, rows: torch.Tensor, out: torch.Tensor,
                 vs: int) -> None:
    """The dump-row kernel (csrc/embed_scatter.cu, the first port of the
    push) into a caller-zeroed contiguous (Vs + 1, E) f32 CUDA buffer, whose
    row Vs takes every unowned id: no path calls it; chip_smoke.py times it
    beside the one-pass kernel. Counts as a launch of
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
    _raise_on(err, "embed_scatter_add (dump-row kernel)")
    embed_scatter_add.launches += 1


def flash_route(dtype: torch.dtype, d: int) -> str:
    """Which CUDA kernel ``flash_attention`` launches, from dtype and head
    dim alone: "tc" (csrc/flash_attention_tc.cu: wgmma, TMA) for bf16 with
    D in {64, 128, 160} (160 = two 64-column boxes and a 32-column one);
    "scalar" (csrc/flash_attention.cu: f32 FMAs, D in {16, 32, 64, 128,
    160}) for f32, whose 2e-6 bar the TF32 tensor cores cannot meet, and
    for the narrow bf16 heads."""
    return "tc" if dtype == torch.bfloat16 and d in _FLASH_TC_DIMS \
        else "scalar"


def _tma_strides(t: torch.Tensor) -> list:
    """The b, s, h strides of a (B, S, H, D) tensor as a TMA map takes them:
    a dimension of size 1 is never stepped, so its stride is replaced by
    the packed one."""
    b, s, h, d = t.shape
    sb, ss, sh = t.stride()[:3]
    sh = sh if h > 1 else d
    ss = ss if s > 1 else h * sh
    sb = sb if b > 1 else s * ss
    return [sb, ss, sh]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q (B, Sq, H, D), k/v (B, Sk, H, D) with KV pre-expanded to H heads,
    bf16|f32 -> (B, Sq, H, D) in q's dtype: softmax(q k^T D^-0.5) v, causal
    positions counted from 0 on both sides. The kernels read the tensors
    through their strides (the head dimension must be contiguous) and take
    D in {16, 32, 64, 128, 160}; ``flash_route`` picks the kernel (bf16 at
    D 64, 128 and 160 on the tensor cores). The tensor-core route also
    needs 16-byte aligned base pointers and b, s, h strides. Both routes
    count in ``flash_attention.launches``, the tensor-core route also in
    ``flash_attention.launches_tc``. Forward-only: an input that requires
    grad under autograd is refused on every device (train through
    ``models/attention.py``'s naive or chunked attention)."""
    _check(q.dim() == 4 and k.dim() == 4 and v.dim() == 4,
           f"q, k, v must be (B, S, H, D), got {tuple(q.shape)}, "
           f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, sq, h, d = q.shape
    _check(k.shape == v.shape and k.shape[0] == b and k.shape[2:] == (h, d),
           f"k, v must be (B={b}, Sk, H={h}, D={d}), got "
           f"{tuple(k.shape)}, {tuple(v.shape)}")
    _check(k.shape[1] > 0, "flash_attention needs Sk >= 1")
    _check(q.dtype in _DTYPES and k.dtype == q.dtype and v.dtype == q.dtype,
           f"q, k, v must share a dtype in {_DTYPES}, got {q.dtype}, "
           f"{k.dtype}, {v.dtype}")
    _check(k.device == q.device and v.device == q.device,
           f"q on {q.device}, k on {k.device}, v on {v.device}")
    _refuse_grad("flash_attention", (q, k, v),
                 "attention_impl 'naive' or 'chunked'")
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal)
    if q.device.type != "cuda":
        raise NotImplementedError(
            f"flash_attention: no kernel for device {q.device}")
    _check(d in _FLASH_DIMS, f"flash_attention: head dim {d} not in "
           f"{_FLASH_DIMS}")
    _check(q.stride(-1) == 1 and k.stride(-1) == 1 and v.stride(-1) == 1,
           "flash_attention needs a contiguous head dimension")
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    if q.numel() == 0:
        return out
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if flash_route(q.dtype, d) == "tc":
        strides = [x for t in (q, k, v) for x in _tma_strides(t)]
        _check(all(t.data_ptr() % 16 == 0 for t in (q, k, v))
               and all(x % 8 == 0 for x in strides),
               "flash_attention (bf16 tensor-core route) needs 16-byte "
               "aligned q, k, v and b, s, h strides that are multiples of "
               f"8 elements, got strides {strides}")
        fn = _build.load("flash_attention_tc")
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 b, sq, k.shape[1], h, d, int(bool(causal)), *strides,
                 *out.stride()[:3], d ** -0.5, stream)
        _raise_on(err, "flash_attention (tensor-core route)")
        flash_attention.launches_tc += 1
    else:
        fn = _build.load("flash_attention")
        strides = [x for t in (q, k, v, out) for x in t.stride()[:3]]
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 b, sq, k.shape[1], h, d, q.element_size(),
                 int(bool(causal)), *strides, d ** -0.5, stream)
        _raise_on(err, "flash_attention")
    flash_attention.launches += 1
    return out


def wkv_route(dtype: torch.dtype, e: int, s: int) -> str:
    """Which CUDA kernel ``wkv`` launches, from the dtype of r/k/v, the
    head size and the sequence length alone: "step" (csrc/wkv_step.cu, one
    pass over the state) for one token, in either dtype; "tc"
    (csrc/wkv_tc.cu: mma.sync bf16 behind a TMA ring) for bf16
    with E = 64 and S > 1; "scalar" (csrc/wkv.cu: f32 FMAs) otherwise — f32,
    whose 1e-4 bar that kernel keeps by staying in f32, and the narrow
    heads."""
    if s == 1:
        return "step"
    return "tc" if dtype == torch.bfloat16 and e == _WKV_TC_DIM else "scalar"


def _wkv_tc_misaligned(tensors) -> list:
    """Indices of the (B, S, H, E) tensors among ``tensors`` that the tc
    route's TMA maps cannot take: a base pointer, or a b, s or h stride as
    ``_tma_strides`` gives it, that is not a multiple of 16 bytes."""
    return [i for i, t in enumerate(tensors)
            if t.data_ptr() % 16
            or any(x * t.element_size() % 16 for x in _tma_strides(t))]


def wkv(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, lw: torch.Tensor,
        bonus: torch.Tensor, state: torch.Tensor, *,
        chunk: int = 32) -> tuple:
    """The RWKV6 WKV recurrence in the TPU kernel's chunk form: r, k, v
    (B, S, H, E) bf16|f32 sharing a dtype, lw (B, S, H, E) log-decay
    bf16|f32, bonus (H, E) f32, state (B, H, E, E) f32 [key x value] ->
    (out (B, S, H, E) in r's dtype, final state (B, H, E, E) f32). Chunks
    of min(chunk, S) tokens, 1 <= chunk <= 64. The kernels read the four
    inputs through their strides (E must be contiguous) and take E in
    {16, 32, 64}; ``wkv_route`` picks the kernel. The tc and step routes
    also need a 16-byte aligned state, the tc route 16-byte aligned rows
    of r, k, v and lw. Every route counts in ``wkv.launches``, the tc and
    step routes also in ``wkv.launches_tc`` and ``wkv.launches_step``.
    Forward-only: an input that requires grad under autograd is refused on
    every device (train through ``models/rwkv.py::chunk_wkv``)."""
    _check(r.dim() == 4 and r.shape[1] >= 1,
           f"r must be (B, S >= 1, H, E), got {tuple(r.shape)}")
    b, s, h, e = r.shape
    _check(k.shape == r.shape and v.shape == r.shape and lw.shape == r.shape,
           f"r, k, v, lw must share a shape, got {tuple(r.shape)}, "
           f"{tuple(k.shape)}, {tuple(v.shape)}, {tuple(lw.shape)}")
    _check(r.dtype in _DTYPES and k.dtype == r.dtype and v.dtype == r.dtype,
           f"r, k, v must share a dtype in {_DTYPES}, got {r.dtype}, "
           f"{k.dtype}, {v.dtype}")
    _check(lw.dtype in _DTYPES, f"lw dtype {lw.dtype} not in {_DTYPES}")
    _check(tuple(bonus.shape) == (h, e) and bonus.dtype == torch.float32,
           f"bonus must be ({h}, {e}) f32, got {bonus.dtype} "
           f"{tuple(bonus.shape)}")
    _check(tuple(state.shape) == (b, h, e, e) and state.dtype == torch.float32,
           f"state must be ({b}, {h}, {e}, {e}) f32, got {state.dtype} "
           f"{tuple(state.shape)}")
    _check(1 <= chunk <= _WKV_MAX_CHUNK,
           f"chunk must be in [1, {_WKV_MAX_CHUNK}], got {chunk}")
    _check(all(t.device == r.device for t in (k, v, lw, bonus, state)),
           "r, k, v, lw, bonus, state must lie on one device")
    _refuse_grad("wkv", (r, k, v, lw, bonus, state),
                 "models/rwkv.py::chunk_wkv (the reference's _chunk_wkv)")
    if r.device.type == "cpu":
        return ref.wkv_chunked_ref(r, k, v, lw, bonus, state, chunk=chunk)
    if r.device.type != "cuda":
        raise NotImplementedError(f"wkv: no kernel for device {r.device}")
    _check(e in _WKV_DIMS, f"wkv: head size {e} not in {_WKV_DIMS}")
    _check(all(t.stride(-1) == 1 for t in (r, k, v, lw)),
           "wkv needs a contiguous head dimension")
    _check(bonus.is_contiguous() and state.is_contiguous(),
           "wkv takes a contiguous bonus and state")
    out = torch.empty((b, s, h, e), dtype=r.dtype, device=r.device)
    s_out = torch.empty_like(state)
    stream = torch.cuda.current_stream(r.device).cuda_stream
    ptrs = (r.data_ptr(), k.data_ptr(), v.data_ptr(), lw.data_ptr(),
            bonus.data_ptr(), state.data_ptr(), out.data_ptr(),
            s_out.data_ptr())
    route = wkv_route(r.dtype, e, s)
    _check(route == "scalar" or state.data_ptr() % 16 == 0,
           f"wkv ({route} route) needs a 16-byte aligned state")
    if route == "step":
        strides = [x for t in (r, k, v, lw, out)
                   for x in (t.stride(0), t.stride(2))]
        err = _build.load("wkv_step")(*ptrs, b, h, e, r.element_size(),
                                      lw.element_size(), *strides, stream)
        _raise_on(err, "wkv (step route)")
        wkv.launches_step += 1
    elif route == "tc":
        bad = _wkv_tc_misaligned((r, k, v, lw))
        _check(not bad, "wkv (bf16 tensor-core route) needs 16-byte aligned "
               "rows: base pointers and b, s, h strides that are multiples "
               f"of 16 bytes; {[('r', 'k', 'v', 'lw')[i] for i in bad]} "
               "are not")
        strides = [x for t in (r, k, v, lw) for x in _tma_strides(t)]
        strides += list(out.stride()[:3])
        err = _build.load("wkv_tc")(*ptrs, b, s, h, e, int(chunk),
                                    lw.element_size(), *strides, stream)
        _raise_on(err, "wkv (tensor-core route)")
        wkv.launches_tc += 1
    else:
        strides = [x for t in (r, k, v, lw, out) for x in t.stride()[:3]]
        err = _build.load("wkv")(*ptrs, b, s, h, e, int(chunk),
                                 r.element_size(), lw.element_size(),
                                 *strides, stream)
        _raise_on(err, "wkv")
    wkv.launches += 1
    return out, s_out


embed_gather.launches = 0
embed_gather.launches_bulk = 0
embed_scatter_add.launches = 0
embed_scatter_add.launches_fused = 0
flash_attention.launches = 0
flash_attention.launches_tc = 0
wkv.launches = 0
wkv.launches_tc = 0
wkv.launches_step = 0
