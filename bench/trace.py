"""Reduction of a ``torch.profiler`` trace of a stretch of training steps
to plain numbers: device busy time, kernels by class, NCCL time not hidden
behind compute, the top device operations and the longest idle gaps named
by what the host was doing.

The idle arithmetic is a frozen copy of the port's
``launch/profile_step.py::_union_us``: the device is busy where any kernel
of any stream runs, so busy time is the length of the union of the kernel
intervals and the idle share is 1 - busy / window.

Kernel classes, by name, first rule that matches (the port's own kernels
are its ``csrc/*.cu`` entry points):

``nccl``   NCCL's kernels (``nccl`` in the name);
``port``   the port's hand-written kernels: ``gather_rows``,
           ``gather_bulk``, ``scatter_rows``, ``scatter_fused``,
           ``flash_fwd``, ``wkv``, ``launch_floor``;
``gemm``   the matrix products of cuBLAS and CUTLASS: ``gemm``,
           ``nvjet``, ``xmma``, ``cutlass``, ``cublas``;
``other``  everything else (the xent's, the optimizer's, the LSTM's
           elementwise, reductions, sorts, copies and fills).
"""
from __future__ import annotations

from dataclasses import dataclass, field

CLASS_RULES = (
    ("nccl", ("nccl",)),
    ("port", ("gather_rows", "gather_bulk", "scatter_rows", "scatter_fused",
              "flash_fwd", "wkv", "launch_floor")),
    ("gemm", ("gemm", "nvjet", "xmma", "cutlass", "cublas")),
)
# the port's kernel for each embedding operation, by name fragment
PORT_KERNELS = {"embed_gather": ("gather_bulk", "gather_rows"),
                "embed_scatter_add": ("scatter_fused",)}
TOP = 10
# the benchmark's own ranges: they name no host work of the program
OWN_RANGES = ("bench.",)


def kernel_class(name: str) -> str:
    low = name.lower()
    for cls, frags in CLASS_RULES:
        if any(f in low for f in frags):
            return cls
    return "other"


def merge(intervals) -> list:
    """Sorted, disjoint [start, end] covering the same points."""
    out: list = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def length(intervals) -> float:
    return sum(e - s for s, e in merge(intervals))


def overlap(a, b) -> float:
    """Length of the points in both interval sets."""
    a, b = merge(a), merge(b)
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def gaps(intervals, start: float, end: float) -> list:
    """The [s, e] stretches of [start, end] no interval covers."""
    out, t = [], start
    for s, e in merge(intervals):
        if s > t:
            out.append([t, min(s, end)])
        t = max(t, e)
        if t >= end:
            break
    if t < end:
        out.append([t, end])
    return [g for g in out if g[1] > g[0]]


@dataclass
class Trace:
    """A traced stretch: kernels (name, start, end) and host operations
    (name, start, end) in seconds, the window [start, end] and the steps
    it holds."""
    kernels: list
    host: list
    start: float
    end: float
    steps: int
    copies: list = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return self.end - self.start

    def of_class(self, cls: str) -> list:
        return [k for k in self.kernels if kernel_class(k[0]) == cls]

    def busy_s(self) -> float:
        return length((s, e) for _, s, e in self.kernels + self.copies)

    def idle_share(self) -> float:
        return 1.0 - self.busy_s() / self.window_s

    def class_seconds(self, cls: str) -> float:
        """Summed kernel time of a class (not a union)."""
        return sum(e - s for _, s, e in self.of_class(cls))

    def exposed_nccl_s(self) -> float:
        """NCCL kernel time that no other kernel overlaps."""
        comm = [(s, e) for _, s, e in self.of_class("nccl")]
        comp = [(s, e) for n, s, e in self.kernels
                if kernel_class(n) != "nccl"]
        return length(comm) - overlap(comm, comp)

    def launches(self, fragments: tuple) -> list:
        """Kernels whose name holds one of ``fragments``, in start order."""
        return sorted((k for k in self.kernels
                       if any(f in k[0] for f in fragments)),
                      key=lambda k: k[1])

    def top_ops(self, n: int = TOP) -> list:
        by: dict = {}
        for name, s, e in self.kernels + self.copies:
            by[name] = by.get(name, 0.0) + (e - s)
        top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:120], sec] for name, sec in top]

    def idle_gaps(self, n: int = TOP) -> list:
        """The ``n`` longest idle gaps, each named by what the host was
        doing at its middle: the innermost host operation running there,
        else "after <the last to end> / before <the next to start>"."""
        busy = [(s, e) for _, s, e in self.kernels + self.copies]
        longest = sorted(gaps(busy, self.start, self.end),
                         key=lambda g: g[0] - g[1])[:n]
        host = [h for h in self.host if not h[0].startswith(OWN_RANGES)]
        out = []
        for s, e in longest:
            mid = 0.5 * (s + e)
            cover = [h for h in host if h[1] <= mid <= h[2]]
            if cover:
                name = max(cover, key=lambda h: (h[1], -h[2]))[0]
            else:
                done = [h for h in host if h[2] < mid]
                nxt = [h for h in host if h[1] > mid]
                name = "after {} / before {}".format(
                    max(done, key=lambda h: h[2])[0] if done else "start",
                    min(nxt, key=lambda h: h[1])[0] if nxt else "end")
            out.append([name[:120], e - s])
        return out


def from_profiler(prof, window_name: str, steps: int) -> Trace:
    """A ``Trace`` of the ``record_function(window_name)`` range in a
    finished ``torch.profiler.profile``."""
    from torch.autograd import DeviceType
    kernels, copies, host = [], [], []
    window = None
    for ev in prof.events():
        tr = ev.time_range
        item = (ev.name, tr.start * 1e-6, tr.end * 1e-6)
        if ev.device_type == DeviceType.CUDA:
            if getattr(ev, "is_user_annotation", False) or \
                    ev.name == window_name:
                continue            # a range's mirror on the device
            if ev.name.startswith(("Memcpy", "Memset")):
                copies.append(item)
            else:
                kernels.append(item)
        elif ev.name == window_name:
            window = item
        else:
            host.append(item)
    if window is None:
        raise RuntimeError(f"the trace holds no {window_name!r} range")
    _, start, end = window
    inside = lambda xs: [x for x in xs if x[2] > start and x[1] < end]
    return Trace(kernels=inside(kernels), host=inside(host), start=start,
                 end=end, steps=steps, copies=inside(copies))
