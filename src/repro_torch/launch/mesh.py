"""Process meshes (the port of ``repro/launch/mesh.py`` and of
``repro/compat/shardmesh.py::make_mesh``).

The JAX package runs one program over a device mesh; the port runs one
process per device, each holding its own shards, with every collective
written out (core/collectives.py). A mesh here is therefore a view of an
initialised process group:

``MeshShape(shape, axes)``  the axis names and sizes only, no groups: what
                           ``analyze()`` and the plan tests read.
``make_mesh(shape, axes, device=...)``  a ``Mesh`` over the default process
                           group, built on ``init_device_mesh``: this rank's
                           coordinates and the process group of each axis
                           and of each tuple of axes.
``DryMesh(shape, axes)``   a record-only mesh: rank 0 of a mesh with no
                           process behind it, whose groups know only their
                           size (core/collectives.py records their
                           collectives and sends nothing). Only the
                           dry-run (launch/dryrun.py) builds on it, as the
                           reference compiles on fake devices.
``make_production_mesh()`` the reference's 16x16 and 2x16x16 production
                           meshes, as ``MeshShape``s.
``spawn(fn, world, backend, device)``  start ``world`` processes (forked
                           from a server that has torch loaded and that
                           is stopped at exit), give each
                           a process group and return each rank's result
                           (the tests' gloo meshes, chip_smoke.py's ranks).

The backend is always the caller's choice (``nccl`` or ``gloo``); nothing
here probes for one. Every mesh carries its grid of world ranks
(``ranks``); ``make_mesh`` lays the world's ranks on it in row-major
order, as devices lie on a ``jax.make_mesh`` grid.

The elastic helpers (the reference's ``shrink_mesh`` / ``grow_mesh`` /
``slice_for_process``, with ranks in place of devices):

``shrink_mesh(mesh, i)``   the grid without data slice ``i``; the kept
                           ranks keep their grid positions;
``grow_mesh(mesh, ranks, i)``  the grid with a returning slice inserted at
                           index ``i`` (a shrink -> grow round trip gives
                           the grid back exactly);
``slice_for_process(mesh, h)``  the data slice whose ranks all run on host
                           ``h`` (a "process" of the reference: the
                           controller of one host's devices), or None.

On a ``MeshShape`` they return a ``MeshShape`` (plans only). On a ``Mesh``
the new grid becomes a ``Mesh`` over a subset of the world's ranks
(``mesh_from_ranks``): its process groups are created on every rank of the
world, in the same order, so each call is collective over the default
group, the ranks off the new grid included. A rank off the grid gets a
``Mesh`` with ``member`` False: it knows the grid and its lead rank, and
belongs to none of its groups.
"""
from __future__ import annotations

import atexit
import itertools
import math
import multiprocessing as mp
import os
import pickle
import queue as queue_mod
import socket
import tempfile
import time
import traceback
from datetime import timedelta
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.collectives import DryGroup


class MeshShape:
    """Axis names and sizes of a mesh, without process groups.
    ``shape[axis]`` is an axis's size, as on a JAX mesh. ``ranks``: the
    grid of world ranks (default: 0..n-1 in row-major order); ``host_of``:
    {rank: host index} (default: ``hosts`` contiguous blocks of ranks)."""

    def __init__(self, shape: Sequence[int], axes: Sequence[str],
                 hosts: int = 1, *, ranks=None, host_of: Optional[dict] = None):
        shape, axes = tuple(int(s) for s in shape), tuple(axes)
        if len(shape) != len(axes) or len(set(axes)) != len(axes):
            raise ValueError(f"mesh shape {shape} vs axes {axes}")
        n = math.prod(shape)
        self.ranks = (np.arange(n).reshape(shape) if ranks is None
                      else np.asarray(ranks, dtype=np.int64))
        if self.ranks.shape != shape:
            raise ValueError(f"rank grid {self.ranks.shape} vs shape {shape}")
        if host_of is None:
            host_of = {r: r * int(hosts) // n for r in range(n)}
        self.host_of = dict(host_of)
        self.axis_names = axes
        self.shape = dict(zip(axes, shape))
        self.hosts = len({self.host_of[int(r)] for r in self.ranks.flat})

    def axes_size(self, axes) -> int:
        return math.prod(self.shape[a] for a in _as_axes(axes))

    @property
    def lead(self) -> int:
        """The first rank of the grid: the rank that writes and decides
        for the mesh (global rank 0 may have been evicted)."""
        return int(self.ranks.flat[0])

    def __repr__(self) -> str:
        dims = ", ".join(f"{a}={n}" for a, n in self.shape.items())
        return f"{type(self).__name__}({dims})"


def _as_axes(axes) -> tuple:
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


class Mesh(MeshShape):
    """A ``MeshShape`` over initialised process groups: this rank's
    ``coords`` ({axis: index}), its ``device``, and ``group(axes)`` — the
    process group of the ranks that share every coordinate outside
    ``axes`` (None for a group of one: every collective over it is the
    identity). A rank off the grid (``member`` False: evicted) has no
    coordinates and no groups."""

    def __init__(self, ranks, axes, *, device, groups: dict,
                 host_of: dict, device_mesh=None):
        ranks = np.asarray(ranks, dtype=np.int64)
        super().__init__(ranks.shape, axes, ranks=ranks, host_of=host_of)
        self.device = torch.device(device)
        self.device_mesh = device_mesh
        self.rank = dist.get_rank()
        self.backend = dist.get_backend()
        where = np.argwhere(self.ranks == self.rank)
        self.member = len(where) == 1
        self.coords = (dict(zip(self.axis_names, map(int, where[0])))
                       if self.member else None)
        self._groups = groups

    def _key(self, axes) -> tuple:
        axes = set(_as_axes(axes))
        return tuple(a for a in self.axis_names if a in axes)

    def group(self, axes):
        key = self._key(axes)
        if self.axes_size(key) <= 1:
            return None
        return self._groups[key]

    def index(self, axes) -> int:
        """This rank's position in ``group(axes)``: row-major over the
        axes in mesh order (the shard a ``P(axes)`` dimension gives it)."""
        i = 0
        for a in self._key(axes):
            i = i * self.shape[a] + self.coords[a]
        return i


class DryMesh(Mesh):
    """A record-only mesh: a ``MeshShape`` that acts as rank 0 (its
    ``coords`` all 0, ``index()`` as on a ``Mesh``) on ``device`` (the
    meta device by default), with no process group behind it. Its
    ``group(axes)`` is a ``collectives.DryGroup`` that knows only its size,
    so each collective reports the event a real mesh's would and returns
    an empty result of the right shape. ``get_runner`` refuses it: only
    the dry-run builds on it."""

    def __init__(self, shape, axes, *, device="meta", hosts: int = 1):
        MeshShape.__init__(self, shape, axes, hosts=hosts)
        self.device = torch.device(device)
        self.device_mesh = None
        self.rank = 0
        self.backend = "dry"
        self.member = True
        self.coords = {a: 0 for a in self.axis_names}
        self._groups = {}

    def group(self, axes):
        n = self.axes_size(self._key(axes))
        return DryGroup(n) if n > 1 else None


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    """The reference's production meshes: 16x16 over (data, model), 256
    cards, or 2x16x16 over (pod, data, model), 512."""
    if multi_pod:
        return MeshShape((2, 16, 16), ("pod", "data", "model"))
    return MeshShape((16, 16), ("data", "model"))


def _subset_groups(shape: tuple, axes: tuple) -> dict:
    """For every tuple of two or more axes, the partition of the ranks
    into groups that share every other coordinate; creates them all, in
    the same order on every rank, and keeps the one holding this rank."""
    ranks = torch.arange(math.prod(shape)).reshape(shape)
    out = {}
    for k in range(2, len(axes) + 1):
        for sub in itertools.combinations(range(len(axes)), k):
            rest = [d for d in range(len(axes)) if d not in sub]
            moved = ranks.permute(*rest, *sub).reshape(
                -1, math.prod(shape[d] for d in sub))
            lists = [r.tolist() for r in moved]
            if len(lists) == 1:
                out[tuple(axes[d] for d in sub)] = dist.group.WORLD
                continue
            own, _ = dist.new_subgroups_by_enumeration(lists)
            out[tuple(axes[d] for d in sub)] = own
    return out


def make_mesh(shape: Sequence[int], axes: Sequence[str], *,
              device) -> Mesh:
    """A mesh over the default process group (already initialised, its
    world the mesh's size): per-axis groups from ``init_device_mesh``,
    groups of axis tuples beside them. ``device`` is this rank's device
    (``"cpu"``, or the card this rank drives)."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(torch.distributed.init_process_group)")
    if math.prod(shape) != dist.get_world_size():
        raise ValueError(f"mesh {shape} needs {math.prod(shape)} ranks, "
                         f"the group has {dist.get_world_size()}")
    device = torch.device(device)
    dm = torch.distributed.device_mesh.init_device_mesh(
        device.type, shape, mesh_dim_names=axes)
    groups = {(a,): dm.get_group(a) for a in axes}
    groups.update(_subset_groups(shape, axes))
    names = [None] * dist.get_world_size()
    dist.all_gather_object(names, socket.gethostname())
    order = list(dict.fromkeys(names))     # hosts by their first rank
    return Mesh(np.arange(math.prod(shape)).reshape(shape), axes,
                device=device, device_mesh=dm, groups=groups,
                host_of={r: order.index(h) for r, h in enumerate(names)})


# the groups ``mesh_from_ranks`` made, by their tuple of world ranks, for
# the default group they were made in (a later world starts afresh)
_GROUPS: dict = {}
_GROUPS_WORLD: list = [None]


def _group_of(row: list):
    """The process group of the world ranks ``row``: made once with
    ``new_group`` (collective over the default group), then reused, so a
    shrink -> grow round trip creates nothing and the groups a run holds
    are bounded by the distinct grids it passes through. Every rank of the
    world makes the same calls in the same order, so each fills the cache
    alike and the creations stay matched."""
    if _GROUPS_WORLD[0] is not dist.group.WORLD:
        _GROUPS.clear()
        _GROUPS_WORLD[0] = dist.group.WORLD
    key = tuple(row)
    if key not in _GROUPS:
        _GROUPS[key] = dist.new_group(list(row))
    return _GROUPS[key]


def mesh_from_ranks(ranks, axes: Sequence[str], *, device,
                    host_of: dict) -> Mesh:
    """A ``Mesh`` over ``ranks`` (a grid of world ranks: a subset of the
    world, as a shrink or a grow leaves it). Collective over the default
    group: every rank of the world calls it with the same arguments, in
    the same order, since each of the grid's process groups is created on
    all of them (``new_group``, once for each tuple of ranks:
    ``_group_of``). A rank off the grid gets a ``Mesh`` with ``member``
    False."""
    ranks = np.asarray(ranks, dtype=np.int64)
    axes = tuple(axes)
    me = dist.get_rank()
    groups = {}
    for k in range(1, len(axes) + 1):
        for sub in itertools.combinations(range(len(axes)), k):
            rest = tuple(d for d in range(len(axes)) if d not in sub)
            size = math.prod(ranks.shape[d] for d in sub)
            if size <= 1:
                continue
            rows = np.transpose(ranks, rest + sub).reshape(-1, size)
            for row in rows.tolist():
                g = _group_of(row)
                if me in row:
                    groups[tuple(axes[d] for d in sub)] = g
    return Mesh(ranks, axes, device=device, groups=groups, host_of=host_of)


# ---------------------------------------------------------------------------
# elasticity: shrink, grow, attribution (the reference's launch/mesh.py)
# ---------------------------------------------------------------------------

def _regrid(mesh: MeshShape, ranks: np.ndarray) -> MeshShape:
    """``ranks`` as the same kind of mesh as ``mesh``: a ``MeshShape``, or
    (collectively, on every rank of the world) a ``Mesh``."""
    if isinstance(mesh, Mesh):
        return mesh_from_ranks(ranks, mesh.axis_names, device=mesh.device,
                               host_of=mesh.host_of)
    return MeshShape(ranks.shape, mesh.axis_names, ranks=ranks,
                     host_of=mesh.host_of)


def slice_for_process(mesh: Optional[MeshShape], process_index: int,
                      axis: str = "data") -> Optional[int]:
    """The ``axis`` slice whose ranks all run on host ``process_index``
    (``mesh.host_of``): the attribution step between "host P is slow" and
    "drop slice i" (``shrink_mesh``). None when no slice is wholly that
    host's (no mesh, the axis is absent, or the host's ranks straddle
    slices): the caller falls back to its by-convention choice rather than
    evicting healthy ranks."""
    if mesh is None or axis not in mesh.axis_names:
        return None
    moved = np.moveaxis(mesh.ranks, mesh.axis_names.index(axis), 0)
    for i in range(moved.shape[0]):
        if {mesh.host_of[int(r)] for r in moved[i].flat} == {process_index}:
            return i
    return None


def shrink_mesh(mesh: Optional[MeshShape],
                drop_axis_index: Optional[int] = None, axis: str = "data",
                min_axis_size: int = 1,
                drop_process_index: Optional[int] = None):
    """``mesh`` without one slice along ``axis``: the straggler eviction.
    The kept ranks keep their grid positions, so every other slice's
    placement is stable across the shrink. ``drop_process_index`` names
    the slow host instead of a grid index (through ``slice_for_process``;
    None when that host owns no whole slice).

    Returns None when the mesh cannot shrink: no mesh, the axis is absent,
    or the shrink would take it below ``min_axis_size`` (the trainer's
    ``min_data_parallel`` floor). Raises ``ValueError`` on an out-of-range
    index. On a ``Mesh``: collective over the world (``mesh_from_ranks``)."""
    if mesh is None or axis not in mesh.axis_names:
        return None
    if drop_process_index is not None:
        if drop_axis_index is not None:
            raise ValueError(
                "pass drop_axis_index or drop_process_index, not both")
        drop_axis_index = slice_for_process(mesh, drop_process_index, axis)
        if drop_axis_index is None:
            return None
    elif drop_axis_index is None:
        raise ValueError("need drop_axis_index or drop_process_index")
    ax = mesh.axis_names.index(axis)
    size = mesh.ranks.shape[ax]
    if not 0 <= drop_axis_index < size:
        raise ValueError(f"drop_axis_index {drop_axis_index} out of range "
                         f"for {axis}={size}")
    if size <= 1 or size - 1 < min_axis_size:
        return None
    return _regrid(mesh, np.delete(mesh.ranks, drop_axis_index, axis=ax))


def grow_mesh(mesh: Optional[MeshShape], slice_ranks,
              insert_axis_index: Optional[int] = None, axis: str = "data"):
    """``mesh`` with one more slice along ``axis``: the re-admission. The
    returning ranks ``slice_ranks`` (the shape of one slice, or a flat
    sequence of its size) go in at ``insert_axis_index`` (their old grid
    position, so a shrink -> grow round trip restores the grid exactly;
    default: after the last slice). None when there is no mesh or the axis
    is absent; ``ValueError`` on a wrong-sized slice, ranks already on the
    mesh, or an out-of-range index. On a ``Mesh``: collective over the
    world (``mesh_from_ranks``)."""
    if mesh is None or axis not in mesh.axis_names:
        return None
    ax = mesh.axis_names.index(axis)
    size = mesh.ranks.shape[ax]
    if insert_axis_index is None:
        insert_axis_index = size
    if not 0 <= insert_axis_index <= size:
        raise ValueError(f"insert_axis_index {insert_axis_index} out of "
                         f"range for {axis}={size} (0..{size} valid)")
    shape = mesh.ranks.shape[:ax] + mesh.ranks.shape[ax + 1:]
    new = np.asarray(slice_ranks, dtype=np.int64)
    if new.shape != shape:
        if new.size != math.prod(shape):
            raise ValueError(f"slice of {new.size} ranks cannot fill a "
                             f"{shape} grid slice")
        new = new.reshape(shape)
    overlap = set(mesh.ranks.ravel().tolist()) & set(new.ravel().tolist())
    if overlap:
        raise ValueError(f"returning slice overlaps the live mesh: ranks "
                         f"{sorted(overlap)}")
    return _regrid(mesh, np.insert(mesh.ranks, insert_axis_index, new,
                                   axis=ax))


# ---------------------------------------------------------------------------
# starting ranks
# ---------------------------------------------------------------------------

def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def rank_device(device: str, rank: int) -> torch.device:
    """The device a rank drives: the CPU, or card ``rank % count`` (ranks
    share a card when there are more ranks than cards)."""
    if device == "cpu":
        return torch.device("cpu")
    return torch.device("cuda", rank % torch.cuda.device_count())


def _worker(job: str, rank: int, world: int, backend: str, device: str,
            port: int, queue) -> None:
    try:
        with open(job, "rb") as f:
            fn, args = pickle.load(f)
        dev = rank_device(device, rank)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        else:
            torch.set_num_threads(1)    # ranks share the host's cores
        dist.init_process_group(
            backend, init_method=f"tcp://localhost:{port}", rank=rank,
            world_size=world, timeout=timedelta(seconds=300))
        try:
            queue.put((rank, True, fn(rank, world, *args)))
        finally:
            dist.destroy_process_group()
    except BaseException:
        queue.put((rank, False, traceback.format_exc()))


# Loaded once by the fork server that every rank is forked from, so a
# rank's start is a fork and not a fresh import of torch and the port,
# which took most of a mesh phase's start-up on the card's host. The
# server is a fresh interpreter that never touches CUDA, and nothing here
# starts a thread on import, so a forked rank initialises its own CUDA
# context and process group.
_PRELOAD = ["torch", "numpy", "repro_torch.core.transform"]


def stop_fork_server() -> None:
    """Stop the fork server and the resource tracker, whose pipe the
    server holds open, and wait for both to exit. Left alone, each outlives
    the program by the second the server takes to unload torch. Registered
    at exit by the first ``spawn``; a later ``spawn`` starts both anew."""
    from multiprocessing import forkserver, resource_tracker
    forkserver._forkserver._stop()
    resource_tracker._resource_tracker._stop()


_stop_registered = False


def spawn(fn: Callable, world: int, backend: str, device: str = "cpu",
          args: tuple = (), *, timeout: float = 600.0) -> list:
    """Run ``fn(rank, world, *args)`` in ``world`` new processes that
    share one ``backend`` process group (``tcp://localhost``, a free port)
    and return the results by rank. ``fn`` and its results must pickle.
    On the CPU each rank computes on one thread. Any rank's exception or
    death, or a rank that has not answered within ``timeout`` seconds,
    stops every rank and raises."""
    global _stop_registered
    ctx = mp.get_context("forkserver")
    ctx.set_forkserver_preload(_PRELOAD)
    if not _stop_registered:
        atexit.register(stop_fork_server)
        _stop_registered = True
    queue = ctx.Queue()
    port = free_port()
    # fn and args reach the ranks through a file: a start's arguments go
    # down a pipe that blocks until that rank has started, which would
    # serialise the ranks' start-ups behind large arguments
    with tempfile.NamedTemporaryFile(suffix=".spawn", delete=False) as f:
        pickle.dump((fn, args), f)
        job = f.name
    procs = [ctx.Process(target=_worker, daemon=True,
                         args=(job, r, world, backend, device, port, queue))
             for r in range(world)]
    results, errors = {}, []
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.start()
        while len(results) < world and not errors:
            try:
                rank, ok, value = queue.get(timeout=1.0)
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in results and p.exitcode not in (None, 0)]
                if dead:
                    errors.append(f"ranks {dead} died (exit codes "
                                  f"{[procs[r].exitcode for r in dead]})")
                elif time.monotonic() > deadline:
                    errors.append(f"ranks did not answer within {timeout} s")
                continue
            if ok:
                results[rank] = value
            else:
                errors.append(f"rank {rank}:\n{value}")
        for p in procs:
            p.join(timeout=60 if not errors else 5)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        os.unlink(job)
    if errors:
        raise RuntimeError("spawn: " + "\n".join(errors))
    return [results[r] for r in range(world)]
