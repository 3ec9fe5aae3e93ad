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
here probes for one. Ranks lie on the mesh in row-major order, as devices
lie on a ``jax.make_mesh`` grid. ``shrink_mesh`` / ``grow_mesh`` belong to
ROADMAP slice 7 (elasticity).
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
from typing import Callable, Sequence

import torch
import torch.distributed as dist

from repro_torch.core.collectives import DryGroup


class MeshShape:
    """Axis names and sizes of a mesh, without process groups.
    ``shape[axis]`` is an axis's size, as on a JAX mesh."""

    def __init__(self, shape: Sequence[int], axes: Sequence[str],
                 hosts: int = 1):
        shape, axes = tuple(int(s) for s in shape), tuple(axes)
        if len(shape) != len(axes) or len(set(axes)) != len(axes):
            raise ValueError(f"mesh shape {shape} vs axes {axes}")
        self.axis_names = axes
        self.shape = dict(zip(axes, shape))
        self.hosts = int(hosts)

    def axes_size(self, axes) -> int:
        return math.prod(self.shape[a] for a in _as_axes(axes))

    def __repr__(self) -> str:
        dims = ", ".join(f"{a}={n}" for a, n in self.shape.items())
        return f"{type(self).__name__}({dims})"


def _as_axes(axes) -> tuple:
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


class Mesh(MeshShape):
    """A ``MeshShape`` over an initialised process group: this rank's
    ``coords`` ({axis: index}), its ``device``, and ``group(axes)`` — the
    process group of the ranks that share every coordinate outside
    ``axes`` (None for a group of one: every collective over it is the
    identity)."""

    def __init__(self, shape, axes, *, device, device_mesh, groups: dict,
                 hosts: int):
        super().__init__(shape, axes, hosts=hosts)
        self.device = torch.device(device)
        self.device_mesh = device_mesh
        self.rank = dist.get_rank()
        self.backend = dist.get_backend()
        idx, coords = self.rank, {}
        for a in reversed(self.axis_names):
            idx, coords[a] = divmod(idx, self.shape[a])
        self.coords = {a: coords[a] for a in self.axis_names}
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
    return Mesh(shape, axes, device=device, device_mesh=dm, groups=groups,
                hosts=len(set(names)))


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
