"""Measured autotune of the one-pass scatter's tile (the port of
``repro/kernels/autotune.py``).

The PS push's kernel (csrc/embed_scatter_fused.cu) cuts the (Vs, E)
gradient into blocks of R rows; ``kernels/ops.py::scatter_partition``
picks R from the shape (about 64 KB of output a block, more when N is
large). Which R is fastest is a scheduling question the roofline can rank
but not decide, so this module runs a small measured sweep per (table
shape, pushed rows, dtype, card), guided by utils/roofline.py:

  * candidates come from ``roofline.kernel_tile_candidates`` (0, the
    partition's own choice, and powers of two up to 8,192 rows whose
    block map fits shared memory); 0 is always measured, so a tuned tile
    never loses to the untuned one;
  * ``roofline.embed_tile_seconds`` ranks the others (a candidate equal
    to the partition's own R is the same launch as 0 and is left out) and
    the sweep measures the cheapest ``_MEASURE_CANDS`` - 1 of them, every
    candidate at today's list, on the card, at the table's real Vs (the
    kernel writes every row of the output, so its time depends on Vs):
    CUDA events in ``REPEATS`` interleaved rounds, one call of each
    candidate a round, the median of each (measured one candidate after
    another, R 0 and the identical R 32 read 6 % apart on the card: the
    drift of one candidate's runs);
  * the measured argmin is cached on disk (JSON, written atomically),
    keyed ``kernel:VsxE:nN:dtype:cuda:smXY``, so a card pays the sweep once
    per configuration.

Only the scatter has a tile. The gather's kernel follows from the table's
row bytes and alignment (``ops.gather_route``), so its tile is always 0:
``Plan.table_tiles[name] = (0, R)``, the reference's (gather, scatter)
pair.

What the port keys on: the reference tunes only on its Pallas path (its
RunConfig's embedding-implementation field); the port reads that field
nowhere (its kernels dispatch on the tensor's device), so it keys on the
device. A runner on the card with ``RunConfig.kernel_autotune`` measures;
on the CPU the plain version has no tile, nothing is measured, and every
table keeps (0, 0). A tile never changes the math, only the schedule: every R
writes the same bits.

Cache location: ``~/.cache/repro_torch/kernel_autotune.json``, moved by
``REPRO_TORCH_AUTOTUNE_CACHE``. ``REPRO_TORCH_AUTOTUNE_NO_MEASURE=1``
forbids new measurements (cache hits still apply).
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import Optional

import torch

from repro_torch.utils import roofline

DEFAULT_CACHE = os.path.join(os.path.expanduser("~"), ".cache",
                             "repro_torch", "kernel_autotune.json")
CACHE_ENV = "REPRO_TORCH_AUTOTUNE_CACHE"
NO_MEASURE_ENV = "REPRO_TORCH_AUTOTUNE_NO_MEASURE"
_MEASURE_CANDS = 11     # 0 + the (this - 1) cheapest roofline predictions:
                        # every candidate of kernel_tile_candidates
REPEATS = 15


def cache_path() -> str:
    return os.environ.get(CACHE_ENV, DEFAULT_CACHE)


def _load() -> dict:
    try:
        with open(cache_path()) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


def _save(cache: dict) -> None:
    """Write the cache atomically: a temp file in the same directory,
    then a rename over the old one."""
    path = cache_path()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".",
                               suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(cache, f, indent=1, sort_keys=True)
        os.replace(tmp, path)
    except OSError:
        try:
            os.unlink(tmp)
        except OSError:
            pass


def backend(device=None) -> str:
    """"cuda:smXY" of the card (``device``, default the current one), or
    "cpu"."""
    device = torch.device("cuda" if device is None else device)
    if device.type != "cuda":
        return "cpu"
    major, minor = torch.cuda.get_device_capability(device)
    return f"cuda:sm{major}{minor}"


def _key(kernel: str, vs: int, e: int, n: int, dtype, device=None) -> str:
    name = str(dtype).removeprefix("torch.")
    return f"{kernel}:{vs}x{e}:n{n}:{name}:{backend(device)}"


def measurement_allowed() -> bool:
    return os.environ.get(NO_MEASURE_ENV, "0") in ("0", "")


def _time_us(fns: dict, repeats: int = REPEATS) -> dict:
    """{key: median CUDA-event microseconds of ``fns[key]()``}: one warm
    call each, then ``repeats`` rounds of one timed call of each, so that
    a drift of the card's clocks falls on every candidate alike."""
    for fn in fns.values():
        fn()
    times = {k: [] for k in fns}
    for _ in range(repeats):
        for k, fn in fns.items():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times[k].append(start.elapsed_time(end) * 1e3)
    return {k: sorted(v)[len(v) // 2] for k, v in times.items()}


def sweep_candidates(vs: int, e: int, n: int, itemsize: int) -> list:
    """0 and the (``_MEASURE_CANDS`` - 1) candidates the roofline ranks
    cheapest, without the partition's own R (0's launch)."""
    from repro_torch.kernels.ops import scatter_partition
    own = scatter_partition(vs, e, n)[0]
    cands = roofline.kernel_tile_candidates(vs)
    tiled = sorted((r for r in cands if r and r != own),
                   key=lambda r: roofline.embed_tile_seconds(n, e, r,
                                                             itemsize, vs))
    return [0] + sorted(tiled[:_MEASURE_CANDS - 1])


def sweep_inputs(vs: int, e: int, n: int, dtype, device) -> tuple:
    """The sweep's push: n ids unique in [0, vs) (a seeded permutation)
    and n rows of ``dtype``."""
    gen = torch.Generator(device="cpu").manual_seed(0)
    ids = torch.randperm(vs, generator=gen)[:n].to(torch.int32)
    rows = torch.randn((n, e), generator=gen).to(dtype)
    return ids.to(device), rows.to(device)


def tune(kernel: str, vs: int, e: int, n: int, dtype,
         cache: Optional[dict] = None, device=None,
         inputs: Optional[tuple] = None) -> tuple:
    """The measured best tile for one kernel and shape on ``device`` (the
    card by default). -> (best R, {R: median µs}); (0, {}) when nothing
    can be measured: the gather (no tile), a CPU device, a degenerate
    shape, or a cold cache with measurement forbidden. Reads and writes
    the disk cache unless ``cache`` is given (its caller then saves).
    ``inputs``: the (ids, rows) to time on (a path's own push), else
    ``sweep_inputs``'."""
    device = torch.device("cuda" if device is None else device)
    if kernel != "scatter" or device.type != "cuda":
        return 0, {}
    own = cache is None
    cache = _load() if own else cache
    key = _key(kernel, vs, e, n, dtype, device)
    hit = cache.get(key)
    if hit is not None:
        return int(hit["best"]), {int(k): v for k, v in hit["us"].items()}
    itemsize = torch.empty((), dtype=dtype).element_size()
    cands = sweep_candidates(vs, e, n, itemsize)
    if len(cands) <= 1 or n <= 0 or not measurement_allowed():
        return 0, {}
    from repro_torch.kernels import ops
    ids, rows = inputs or sweep_inputs(vs, e, n, dtype, device)
    us = _time_us({r: (lambda r=r: ops.embed_scatter_add(ids, rows, vs,
                                                          block=r))
                   for r in cands})
    best = min(us, key=us.get)
    cache[key] = {"best": int(best),
                  "us": {str(k): float(v) for k, v in us.items()}}
    if own:
        _save(cache)
    return int(best), us


def ensure_for_plan(plan, rt, model=None) -> dict:
    """Stamp (0, R) tiles for every sparse table of ``model`` into
    ``plan.table_tiles``: R the measured best for this rank's shard of the
    table (its rows), the table's dedupe capacity and the wire dtype its
    rows are pushed at. Off the card, or without a model, nothing is
    stamped and every table keeps (0, 0). -> the stamped dict."""
    if model is None or rt.device.type != "cuda":
        return {}
    from repro_torch.models.layers import flatten_specs
    from repro_torch.utils.tree import named_parameters
    own = named_parameters(model)
    cache = _load()
    before = json.dumps(cache, sort_keys=True)
    for name, spec in flatten_specs(model.specs()):
        if not spec.sparse or len(spec.shape) != 2:
            continue
        vs, e = (int(x) for x in own[name].shape)
        n = int(plan.table_capacity.get(name, 0)) or \
            rt.embed_capacity_for(name)
        wire = plan.table_wire.get(name, rt.wire_dtype)
        r, _ = tune("scatter", vs, e, n, wire, cache=cache, device=rt.device)
        plan.table_tiles[name] = (0, int(r))
    if json.dumps(cache, sort_keys=True) != before:
        _save(cache)
    return dict(plan.table_tiles)


def cache_status(device=None) -> dict:
    """The cache for an environment report (the reference's
    ``tools/check_env.py`` reads it): path, whether it exists, its
    entries, and how many are this card's."""
    path = cache_path()
    cache = _load()
    here = backend(device) if torch.cuda.is_available() else "cpu"
    return {"path": path, "exists": os.path.exists(path),
            "entries": len(cache), "state": "warm" if cache else "cold",
            "backend_entries": sum(1 for k in cache
                                   if k.endswith(f":{here}"))}
