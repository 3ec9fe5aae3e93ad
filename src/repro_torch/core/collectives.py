"""Every collective of the port, by mesh axis name — the one module that
calls ``torch.distributed`` (the JAX package writes ``jax.lax.psum`` and
friends inline; the port names the same operations here).

``all_reduce`` / ``all_reduce_max``  sum / max over the named axes (the
                          reference's ``psum`` / ``pmax``; the JAX
                          package's lint reserves the name ``psum`` for its
                          manual-region modules and scans this tree too);
``all_gather``            tiled concatenation along ``dim`` in the group's
                          row-major order (``P(axes)``'s shard order);
``reduce_scatter``        sum, then keep this rank's block along ``dim``;
``all_reduce_async``      the bucketed exchange's non-blocking all-reduce;
``all_to_all``            chunk j of ``split_dim`` to rank j, the received
                          chunks concatenated along ``concat_dim`` in rank
                          order (the reference's ``jax.lax.all_to_all``),
                          an autograd function whose backward is the
                          inverse all-to-all: the MoE's expert-parallel
                          dispatch;
``broadcast`` / ``broadcast_object``  a tensor or a picklable object of
                          one rank on every rank of a mesh (or, for an
                          object, of the world): the elastic trainer's
                          verdicts, re-admissions and messages to the
                          ranks off the mesh (``barrier`` waits over the
                          mesh's own ranks);
``copy_to`` / ``reduce_from``  the model-axis pair as autograd functions:
                          identity forward / all-reduce backward, and its
                          mirror;
``gather_from``           all-gather forward, this rank's block backward:
                          a result every rank of ``axes`` then uses whole,
                          with the whole gradient on every rank;
``split_to``              its mirror: this rank's block forward, the
                          blocks' gradients all-gathered backward (a whole
                          value entering a sequence-sharded region);
``gather_rs`` / ``reduce_scatter_ag``  the sequence-parallel pair
                          (core/sp.py): all-gather forward, reduce-scatter
                          backward (each rank's gradient of the gathered
                          value is its partial sum), and reduce-scatter
                          forward, all-gather backward; both ride a wire
                          dtype each way, as the reference's casts do.

A collective over a group of one rank (``Mesh.group`` is None) is the
identity and returns its input untouched.

Under gloo, a collective that gloo has no CUDA path for is staged through
host memory: gloo lists only broadcast and all-reduce for CUDA tensors, so
``all_gather``, ``reduce_scatter`` and ``all_to_all`` of a CUDA tensor copy
it to the host,
run there and copy the result back. That staging exists in this module
only; compute never moves to the CPU. Several ranks on one card run over
gloo (NCCL takes one card per rank), so this is what the card's multi-rank
runs exchange through.

The record (``record()``): every collective above reports one ``Event``
to each record open while it runs (kind, axes, group size, the result's
element count, dtype and bytes, a sequence number, whether it was issued
inside a backward that ``backward()`` marks, and its time: a CUDA-event
time on the card, the host clock on the CPU; for an ``all_reduce_async``
the time from issue to its ``wait()``). A staged gloo collective is one
event, its copies included. The identity over a group of one is no
collective and records nothing. With no record open the cost is one
truth test of a module list. Every blocking call also adds its host
seconds to ``blocked_seconds()`` (two clock reads): a rank's heartbeat is
its step less that. ``analysis/contract.py`` diffs a step's
record against its plan; ``wire_bytes`` applies the ring factors the
reference applies to HLO (``repro/utils/hlo.py::_ring_factor``).

A record-only mesh (``launch/mesh.py::DryMesh``, the dry-run's stand-in
for the reference's fake devices) hands out ``DryGroup``s, which know
only their size. Each function here, given one, reports the same event a
process group's call would, returns a tensor of the result's shape,
dtype and device (empty: nothing is computed) and communicates nothing.
"""
from __future__ import annotations

import contextlib
import itertools
import time
import warnings
from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist


@dataclass
class Event:
    """One collective as ``record()`` saw it. ``elems`` / ``bytes``: the
    result's (an all-gather's n blocks, a reduce-scatter's one block), as
    the reference's HLO reading counts them; ``op``: an all-reduce's
    reduction ("sum" / "max"), else None; ``ms``: None until the record
    closes (an async all-reduce's: and its ``wait()`` has run)."""
    seq: int
    kind: str                 # all-reduce | all-gather | reduce-scatter |
                              # all-to-all
    axes: tuple               # mesh axes, in mesh order
    group: int                # ranks in the group
    elems: int
    dtype: str                # torch dtype name ("bfloat16", "int32", ...)
    bytes: int
    op: Optional[str] = None
    in_backward: bool = False
    ms: Optional[float] = None
    clocks: tuple = ()        # (start, end): CUDA events or host seconds

    @property
    def name(self) -> str:
        return f"{self.kind}#{self.seq}"


def wire_bytes(ev: Event) -> float:
    """The bytes ``ev`` puts on the wire a rank, the ring factors of the
    reference's ``utils/hlo.py::_ring_factor``: 2(n-1)/n of an
    all-reduce's result, (n-1)/n of the others'."""
    n = ev.group
    return ev.bytes * (2.0 if ev.kind == "all-reduce" else 1.0) * (n - 1) / n


class DryGroup:
    """A group of a record-only mesh: its size, and no process."""

    def __init__(self, size: int):
        self.size = int(size)

    def __repr__(self) -> str:
        return f"DryGroup({self.size})"


def _size(g) -> int:
    return g.size if isinstance(g, DryGroup) else dist.get_world_size(g)


def _dry(g) -> bool:
    return isinstance(g, DryGroup)


class _DoneWork:
    """The work handle of a record-only all-reduce: nothing to wait for."""

    def wait(self):
        return True


class Record:
    """The events of one ``record()`` window, in issue order."""

    def __init__(self):
        self.events: list = []

    def by_kind_axes(self) -> dict:
        """{"<kind> over <axes>": count, payload and wire bytes, ms}; a max
        all-reduce keyed apart ("all-reduce/max")."""
        out = {}
        for ev in self.events:
            kind = ev.kind + ("/max" if ev.op == "max" else "")
            row = out.setdefault(f"{kind} over {'+'.join(ev.axes)}", {
                "count": 0, "bytes": 0, "wire_bytes": 0.0, "ms": 0.0})
            row["count"] += 1
            row["bytes"] += ev.bytes
            row["wire_bytes"] += wire_bytes(ev)
            row["ms"] += ev.ms or 0.0
        return out

    def _resolve(self) -> None:
        """Read the times of the events whose clocks have stopped."""
        done = [ev for ev in self.events
                if ev.ms is None and len(ev.clocks) == 2]
        if any(isinstance(ev.clocks[0], torch.cuda.Event) for ev in done):
            torch.cuda.synchronize()
        for ev in done:
            start, end = ev.clocks
            ev.ms = (float(start.elapsed_time(end))
                     if isinstance(start, torch.cuda.Event)
                     else (end - start) * 1e3)


class _State:
    """The open records and the depth of ``backward()`` regions. Module
    state, not a context argument: autograd runs a card's backward, and
    the gradient hooks that issue the bucketed all-reduces, on a thread
    of its own."""
    records: list = []
    backward: int = 0
    seq = itertools.count()
    blocked: float = 0.0          # host seconds spent waiting in collectives


def blocked_seconds() -> float:
    """Host seconds this process has spent inside collectives so far (each
    blocking call's wall time, an async all-reduce's ``wait()``). A step's
    time less its share of this is the rank's own work: its heartbeat
    (runtime/trainer.py), since in a synchronous step every rank's wall
    time is gated by the slowest rank at each collective."""
    return _State.blocked


@contextlib.contextmanager
def _blocking():
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _State.blocked += time.perf_counter() - t0


@contextlib.contextmanager
def record():
    """Record every collective issued until the block ends (each open
    record sees every event) -> the ``Record``. Its events' times are
    read when it closes: one ``synchronize`` on the card."""
    rec = Record()
    _State.records.append(rec)
    try:
        yield rec
    finally:
        _State.records.remove(rec)
        rec._resolve()


@contextlib.contextmanager
def backward():
    """Mark the collectives issued in this block as inside the backward
    (the training step wraps ``loss.backward()`` in it)."""
    _State.backward += 1
    try:
        yield
    finally:
        _State.backward -= 1


def _clock(x: torch.Tensor):
    if x.device.type == "cuda":
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev
    return time.perf_counter()


def _start(kind: str, x: torch.Tensor, elems: int, axes, mesh, g,
           op: Optional[str] = None) -> Event:
    """Report a collective on ``x`` (its dtype and device) whose result has
    ``elems`` elements to every open record, and start its clock."""
    ev = Event(seq=next(_State.seq), kind=kind, axes=mesh._key(axes),
               group=_size(g), elems=int(elems),
               dtype=str(x.dtype).removeprefix("torch."),
               bytes=int(elems) * x.element_size(), op=op,
               in_backward=_State.backward > 0,
               clocks=(_clock(x),))
    for rec in _State.records:
        rec.events.append(ev)
    return ev


def _stop(ev: Event, x: torch.Tensor) -> None:
    ev.clocks = (ev.clocks[0], _clock(x))


class _TimedWork:
    """An async all-reduce's work handle whose ``wait()`` counts as
    blocked time and stops its event's clock (``ev``: None when no record
    was open)."""

    def __init__(self, work, ev, buf: torch.Tensor):
        self.work, self.ev, self.buf = work, ev, buf

    def wait(self):
        with _blocking():
            out = self.work.wait()
        if self.ev:
            _stop(self.ev, self.buf)
        return out


def _gloo(mesh) -> bool:
    return mesh.backend == "gloo"


def _staged(mesh, x: torch.Tensor) -> bool:
    return _gloo(mesh) and x.device.type != "cpu"


def all_reduce(x: torch.Tensor, axes, mesh) -> torch.Tensor:
    """Sum over the ranks of ``axes``; a new tensor (x itself over a group
    of one)."""
    g = mesh.group(axes)
    if g is None:
        return x
    out = x.contiguous().clone()
    ev = _State.records and _start("all-reduce", out, out.numel(), axes,
                                   mesh, g, "sum")
    if not _dry(g):
        with _blocking():
            dist.all_reduce(out, op=dist.ReduceOp.SUM, group=g)
    if ev:
        _stop(ev, out)
    return out


def all_reduce_max(x: torch.Tensor, axes, mesh) -> torch.Tensor:
    g = mesh.group(axes)
    if g is None:
        return x
    out = x.contiguous().clone()
    ev = _State.records and _start("all-reduce", out, out.numel(), axes,
                                   mesh, g, "max")
    if not _dry(g):
        with _blocking():
            dist.all_reduce(out, op=dist.ReduceOp.MAX, group=g)
    if ev:
        _stop(ev, out)
    return out


def all_reduce_async(buf: torch.Tensor, axes, mesh):
    """Sum ``buf`` (contiguous) in place over ``axes`` without blocking;
    returns the work handle to ``wait()`` on, or None over a group of
    one."""
    g = mesh.group(axes)
    if g is None:
        return None
    ev = _State.records and _start("all-reduce", buf, buf.numel(), axes,
                                   mesh, g, "sum")
    if _dry(g):
        return _TimedWork(_DoneWork(), ev, buf) if ev else _DoneWork()
    work = dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=g,
                           async_op=True)
    return _TimedWork(work, ev, buf)


def all_gather(x: torch.Tensor, axes, mesh, dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` of ``axes``, concatenated along ``dim`` in the
    group's row-major order."""
    g = mesh.group(axes)
    if g is None:
        return x
    n = _size(g)
    src = x.movedim(dim, 0).contiguous()
    home = src.device
    ev = _State.records and _start("all-gather", src, n * src.numel(), axes,
                                   mesh, g)
    if _staged(mesh, src):
        src = src.cpu()
    if _dry(g):
        out = src.new_empty((n * src.shape[0],) + tuple(src.shape[1:]))
    elif _gloo(mesh):
        parts = [torch.empty_like(src) for _ in range(n)]
        with _blocking():
            dist.all_gather(parts, src, group=g)
        out = torch.cat(parts, 0)
    else:
        out = src.new_empty((n * src.shape[0],) + tuple(src.shape[1:]))
        with _blocking():
            dist.all_gather_into_tensor(out, src, group=g)
    out = out.to(home)
    if ev:
        _stop(ev, out)
    return out.movedim(0, dim)


def reduce_scatter(x: torch.Tensor, axes, mesh, dim: int = 0
                   ) -> torch.Tensor:
    """The sum over ``axes`` of ``x``, cut along ``dim`` into one block per
    rank (row-major order); this rank's block."""
    g = mesh.group(axes)
    if g is None:
        return x
    n = _size(g)
    src = x.movedim(dim, 0).contiguous()
    if src.shape[0] % n:
        raise ValueError(f"reduce_scatter: dim of {src.shape[0]} over "
                         f"{n} ranks")
    home = src.device
    ev = _State.records and _start("reduce-scatter", src, src.numel() // n,
                                   axes, mesh, g, "sum")
    if _staged(mesh, src):
        src = src.cpu()
    out = src.new_empty((src.shape[0] // n,) + tuple(src.shape[1:]))
    if not _dry(g):
        with warnings.catch_warnings():
            # renamed reduce_scatter_single in newer torch; this name is
            # in every version the port runs on
            warnings.simplefilter("ignore", FutureWarning)
            with _blocking():
                dist.reduce_scatter_tensor(out, src, op=dist.ReduceOp.SUM,
                                           group=g)
    out = out.to(home)
    if ev:
        _stop(ev, out)
    return out.movedim(0, dim)


class _AllToAll(torch.autograd.Function):
    """The forward of ``all_to_all``; the backward sends each gradient
    block home: the all-to-all with the two dims swapped."""

    @staticmethod
    def forward(fctx, x, axis, g, mesh, split_dim, concat_dim):
        fctx.axis, fctx.g, fctx.mesh = axis, g, mesh
        fctx.dims = (split_dim, concat_dim)
        n = _size(g)
        if x.shape[split_dim] % n:
            raise ValueError(f"all_to_all: dim of {x.shape[split_dim]} "
                             f"over {n} ranks")
        # (n, chunk, *the other dims): block j goes to rank j, and block i
        # of the result came from rank i
        src = x.movedim(split_dim, 0)
        src = src.reshape((n, src.shape[0] // n) + tuple(src.shape[1:]))
        src = src.contiguous()
        home = src.device
        ev = _State.records and _start("all-to-all", src, src.numel(), axis,
                                       mesh, g)
        if _staged(mesh, src):
            src = src.cpu()
        out = torch.empty_like(src)
        if not _dry(g):
            with _blocking():
                dist.all_to_all_single(out, src, group=g)
        out = out.to(home)
        if ev:
            _stop(ev, out)
        # the chunk back in split_dim's place, then the rank blocks merged
        # into concat_dim
        out = out.movedim(1, split_dim + 1).movedim(0, concat_dim)
        shape = list(out.shape)
        shape[concat_dim:concat_dim + 2] = [shape[concat_dim]
                                            * shape[concat_dim + 1]]
        return out.reshape(shape)

    @staticmethod
    def backward(fctx, gy):
        split_dim, concat_dim = fctx.dims
        return (_AllToAll.apply(gy, fctx.axis, fctx.g, fctx.mesh,
                                concat_dim, split_dim),
                None, None, None, None, None)


def all_to_all(x: torch.Tensor, axis, mesh, split_dim: int = 0,
               concat_dim: int = 0) -> torch.Tensor:
    """``x``'s ``split_dim`` cut into one block per rank of ``axis``, block
    j sent to rank j; the blocks this rank receives concatenated along
    ``concat_dim`` in rank order (``jax.lax.all_to_all(x, axis,
    split_axis, concat_axis)``). Differentiable: the backward is the
    inverse all-to-all."""
    g = mesh.group(axis)
    if g is None:
        return x
    return _AllToAll.apply(x, axis, g, mesh, split_dim, concat_dim)


class _GatherFrom(torch.autograd.Function):
    """All-gather forward, this rank's block backward: every rank of
    ``axes`` uses the gathered result whole and so already holds its
    whole gradient; summing it would count it once per rank."""

    @staticmethod
    def forward(fctx, x, axes, mesh, dim):
        fctx.block = (mesh.index(axes), x.shape[dim], dim)
        return all_gather(x, axes, mesh, dim=dim)

    @staticmethod
    def backward(fctx, g):
        i, n, dim = fctx.block
        return g.narrow(dim, i * n, n), None, None, None


def gather_from(x: torch.Tensor, axes, mesh, dim: int = 0) -> torch.Tensor:
    if mesh.group(axes) is None:
        return x
    return _GatherFrom.apply(x, axes, mesh, dim)


class _SplitTo(torch.autograd.Function):
    """This rank's block forward, the blocks' gradients all-gathered
    backward: the mirror of ``_GatherFrom``."""

    @staticmethod
    def forward(fctx, x, axes, mesh, dim):
        fctx.args = (axes, mesh, dim)
        n = mesh.axes_size(axes)
        size = x.shape[dim] // n
        return x.narrow(dim, mesh.index(axes) * size, size)

    @staticmethod
    def backward(fctx, g):
        axes, mesh, dim = fctx.args
        return all_gather(g, axes, mesh, dim=dim), None, None, None


def split_to(x: torch.Tensor, axes, mesh, dim: int = 0) -> torch.Tensor:
    if mesh.group(axes) is None:
        return x
    if x.shape[dim] % mesh.axes_size(axes):
        raise ValueError(f"split_to: dim of {x.shape[dim]} over "
                         f"{mesh.axes_size(axes)} ranks")
    return _SplitTo.apply(x, axes, mesh, dim)


def _wired(fn, x: torch.Tensor, wire, *args, **kw) -> torch.Tensor:
    """``fn`` on ``x`` cast to ``wire`` (None: as it is), cast back."""
    if wire is None or wire == x.dtype:
        return fn(x, *args, **kw)
    return fn(x.to(wire), *args, **kw).to(x.dtype)


class _GatherRS(torch.autograd.Function):
    """All-gather forward, reduce-scatter backward."""

    @staticmethod
    def forward(fctx, x, axes, mesh, dim, wire):
        fctx.args = (axes, mesh, dim, wire)
        return _wired(all_gather, x, wire, axes, mesh, dim=dim)

    @staticmethod
    def backward(fctx, g):
        axes, mesh, dim, wire = fctx.args
        return (_wired(reduce_scatter, g, wire, axes, mesh, dim=dim),
                None, None, None, None)


class _ReduceScatterAG(torch.autograd.Function):
    """Reduce-scatter forward, all-gather backward."""

    @staticmethod
    def forward(fctx, x, axes, mesh, dim, wire):
        fctx.args = (axes, mesh, dim, wire)
        return _wired(reduce_scatter, x, wire, axes, mesh, dim=dim)

    @staticmethod
    def backward(fctx, g):
        axes, mesh, dim, wire = fctx.args
        return (_wired(all_gather, g, wire, axes, mesh, dim=dim),
                None, None, None, None)


def gather_rs(x: torch.Tensor, axes, mesh, dim: int = 0,
              wire=None) -> torch.Tensor:
    """Every rank's block of ``axes`` concatenated along ``dim``; the
    backward sums each rank's gradient of the whole and keeps this rank's
    block. ``wire``: the dtype both collectives ride."""
    if mesh.group(axes) is None:
        return x
    return _GatherRS.apply(x, axes, mesh, dim, wire)


def reduce_scatter_ag(x: torch.Tensor, axes, mesh, dim: int = 0,
                      wire=None) -> torch.Tensor:
    """The sum over ``axes`` of ``x``, this rank's block along ``dim``;
    the backward all-gathers the blocks' gradients."""
    if mesh.group(axes) is None:
        return x
    return _ReduceScatterAG.apply(x, axes, mesh, dim, wire)


class _CopyTo(torch.autograd.Function):
    """Identity forward, all-reduce backward: the activation every rank of
    ``axes`` uses whole feeds a product sharded over ``axes``, so each
    rank's gradient is a partial sum."""

    @staticmethod
    def forward(fctx, x, axes, mesh):
        fctx.axes, fctx.mesh = axes, mesh
        return x.view_as(x)

    @staticmethod
    def backward(fctx, g):
        return all_reduce(g, fctx.axes, fctx.mesh), None, None


class _ReduceFrom(torch.autograd.Function):
    """All-reduce forward, identity backward: the mirror of ``_CopyTo``."""

    @staticmethod
    def forward(fctx, x, axes, mesh):
        return all_reduce(x, axes, mesh)

    @staticmethod
    def backward(fctx, g):
        return g, None, None


def copy_to(x: torch.Tensor, axes, mesh) -> torch.Tensor:
    return _CopyTo.apply(x, axes, mesh)


def reduce_from(x: torch.Tensor, axes, mesh) -> torch.Tensor:
    return _ReduceFrom.apply(x, axes, mesh)


def barrier(mesh) -> None:
    """Every rank of the mesh waits for the others (a no-op off a mesh or
    on a mesh of one rank): the trainer's checkpoint hand-off between the
    writing rank and the readers. Over the mesh's own ranks, which after a
    shrink are not the whole world."""
    if mesh is None or not dist.is_initialized():
        return
    g = mesh.group(mesh.axis_names)
    if g is not None:
        with _blocking():
            dist.barrier(group=g)


def broadcast(x: torch.Tensor, mesh, src: Optional[int] = None,
              axes=None) -> torch.Tensor:
    """``x`` of global rank ``src`` (default: the mesh's lead, its first
    rank) on every rank of ``group(axes)`` (default: the whole mesh), in
    place (a no-op over a group of one): how a returning slice receives
    the live state at a re-admission."""
    axes = mesh.axis_names if axes is None else axes
    g = mesh.group(axes)
    if g is None:
        return x
    ev = _State.records and _start("broadcast", x, x.numel(), axes, mesh,
                                   g)
    with _blocking():
        dist.broadcast(x, src=mesh.lead if src is None else src, group=g)
    if ev:
        _stop(ev, x)
    return x


def broadcast_object(obj, mesh=None, *, src: Optional[int] = None,
                     axes=None):
    """A picklable ``obj`` of global rank ``src`` on every rank: over the
    mesh's ``group(axes)`` (default: all its ranks; ``src`` default: its
    lead), or (``mesh`` None) over the whole world — the channel between a
    mesh's live ranks and the ranks a shrink left off it, which wait on
    the world. A control-plane message: no record sees it."""
    g = None
    if mesh is not None:
        g = mesh.group(mesh.axis_names if axes is None else axes)
        if g is None:
            return obj
        src = mesh.lead if src is None else src
    box = [obj]
    with _blocking():
        dist.broadcast_object_list(box, src=src, group=g)
    return box[0]


def world_size() -> int:
    """Ranks in the default process group (1 without one)."""
    return dist.get_world_size() if dist.is_initialized() else 1
