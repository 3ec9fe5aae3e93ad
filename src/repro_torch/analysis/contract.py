"""Diff one training step's collectives against its Plan's contract (the
port of ``repro/analysis/contract.py``).

The planner (core/plan.py + core/buckets.py) decides how every gradient
moves; this pass verifies the step carried that decision out. Expected
side: ``Plan.exchange_contract()`` — per-bucket (kind, element-count)
sequences, the overlap mode, and each sparse table's method and capacity.
Observed side: the step's record (``core/collectives.py::record``): every
collective it issued, in issue order, with its axes, size, dtype and
whether it was issued inside the backward. The reference reads the same
facts from the compiled HLO's schedule.

Which collectives the contract covers: those whose axes include a batch
axis of the plan (the exchange over the replicas). A collective over
``model`` alone is tensor-parallel traffic — the blocks' ``copy_to`` /
``reduce_from``, the ``ps`` pull's sum over the row shards, core/sp.py —
and outside the contract; the check reports their count by kind beside
its findings (``Findings.outside``). The reference's HLO has no axes, so
its pool holds every collective (ROADMAP Queue 3).

The rules, as the reference's:

  * each ring bucket is ONE all-reduce of exactly ``sum(sizes)``
    elements; matching is by kind and element count, and the planned
    wire dtype is checked under ``strict_dtype``;
  * each two-level bucket is the reduce-scatter(E/L) -> all-reduce(E/L)
    -> all-gather(E) triple, E padded to the local replica count L;
  * the loss and every metric scalar ride exactly ONE all-reduce of at
    most ``SCALAR_MAX`` elements (``buckets.py::fused_metrics``), and no
    other all-reduce crosses the replicas;
  * a gatherv table's push shows as a row-buffer all-gather (elements a
    multiple of the replica count, at least replicas x capacity) and an
    integer uid all-gather;
  * with overlap on and two or more buckets, the first bucket collective
    is issued inside the backward; with overlap off every one is issued
    after it;
  * all-reduces over the batch axes are at most buckets + 1; an
    unbucketed plan issues at least one collective per ``allreduce``
    leaf (where there is more than one replica).
"""
from __future__ import annotations

import math

from repro_torch.analysis.findings import Finding

_INT_DTYPES = {"int32", "int64"}

# all-reduces over the replicas at or under this many elements are metric
# scalars, not gradient traffic (the fused metrics vector is tens of
# elements; the smallest real bucket is thousands)
SCALAR_MAX = 4096


class ContractViolation(AssertionError):
    """Raised by the verify gate when a step breaks its plan."""

    def __init__(self, findings):
        self.findings = list(findings)
        lines = "\n  ".join(str(f) for f in self.findings)
        super().__init__(
            f"the step violates its plan contract "
            f"({len(self.findings)} finding(s)):\n  {lines}")


class Findings(list):
    """The findings of one check (a list: empty when the step carries
    out its plan), with ``outside``: {kind: count} of the recorded
    collectives the contract does not cover (over no batch axis)."""

    def __init__(self, items=(), outside=None):
        super().__init__(items)
        self.outside = dict(outside or {})


def _batch_axes(plan) -> tuple:
    """The mesh axes the plan's replicas span."""
    if plan.bucket_plan is not None:
        return tuple(plan.bucket_plan.batch_axes)
    rules = plan.rules.rules if plan.rules is not None else {}
    return tuple(rules.get("batch") or ())


def _replicas(plan) -> int:
    if plan.bucket_plan is not None:
        return plan.bucket_plan.replicas
    if plan.mesh is None:
        return 1
    return math.prod(plan.mesh.shape[a] for a in _batch_axes(plan))


def _match(pool: list, kind: str, elems: int):
    """Pop and return the first unclaimed sum of ``kind`` with a result of
    exactly ``elems`` elements, or None."""
    for e in pool:
        if e.kind == kind and e.elems == elems and e.op != "max":
            pool.remove(e)
            return e
    return None


def _check_buckets(plan, pool: list, strict_dtype: bool) -> tuple:
    """Match each bucket's expected collectives in the pool. -> (findings,
    the matched events)."""
    findings, matched = [], []
    for want in plan.exchange_contract()["buckets"]:
        leaf = f"bucket[{want['bucket']}]"
        for kind, elems in want["collectives"]:
            ev = _match(pool, kind, elems)
            if ev is None:
                findings.append(Finding(
                    "missing-collective", plan_leaf=leaf,
                    expected=f"{kind} of {elems} elems ({want['dtype']})",
                    actual="no matching collective in the record"))
                continue
            matched.append(ev)
            if strict_dtype and ev.dtype != want["dtype"]:
                findings.append(Finding(
                    "wire-dtype", where=ev.name, plan_leaf=leaf,
                    expected=want["dtype"], actual=ev.dtype,
                    message="collective rides the wrong wire dtype"))
    return findings, matched


def _check_sparse(plan, pool: list) -> list:
    """Each gatherv table's row-buffer and uid all-gathers; claims them,
    one of each a table, so they are not read as dense traffic."""
    findings = []
    replicas = _replicas(plan)
    for name, t in plan.exchange_contract()["tables"].items():
        if t["method"] != "mpi_gatherv":
            continue
        cap = max(t["capacity"], 1)
        gathers = [e for e in pool if e.kind == "all-gather"
                   and e.elems % replicas == 0]
        uid = next((e for e in gathers if e.dtype in _INT_DTYPES
                    and e.elems >= replicas), None)
        rows = next((e for e in gathers if e.dtype not in _INT_DTYPES
                     and e.elems >= replicas * cap), None)
        if rows is None:
            findings.append(Finding(
                "missing-sparse-collective", plan_leaf=name,
                expected=f"row-buffer all-gather >= {replicas}x{cap} rows",
                actual="none in the record",
                message="gatherv table exchange not found"))
        if uid is None:
            findings.append(Finding(
                "missing-sparse-collective", plan_leaf=name,
                expected="integer uid all-gather",
                actual="none in the record",
                message="gatherv uid exchange not found"))
        for e in (rows, uid):
            if e is not None:
                pool.remove(e)
    return findings


def _check_scalars(pool: list) -> list:
    """Exactly one small fused all-reduce carries every metric scalar, and
    no other all-reduce crosses the replicas."""
    findings = []
    small = [e for e in pool
             if e.kind == "all-reduce" and e.elems <= SCALAR_MAX]
    if not small:
        findings.append(Finding(
            "missing-collective", plan_leaf="metrics",
            expected=f"one fused scalar all-reduce (<= {SCALAR_MAX} elems)",
            actual="none"))
    for e in small[1:]:
        findings.append(Finding(
            "unfused-scalars", where=e.name,
            expected="one fused scalar all-reduce",
            actual=f"extra {e.elems}-elem all-reduce",
            message="metric scalars must ride a single fused all-reduce"))
    for e in small:
        pool.remove(e)
    for e in pool:
        if e.kind == "all-reduce":
            findings.append(Finding(
                "unexpected-collective", where=e.name,
                expected="no all-reduce outside the bucket contract",
                actual=f"{e.elems}-elem all-reduce ({e.dtype})",
                message="gradient traffic outside the planned buckets"))
    return findings


def _check_schedule(plan, matched: list) -> list:
    """Overlap placement: where the bucket collectives were issued
    against the backward."""
    bp = plan.bucket_plan
    if not matched:
        return []
    first = min(matched, key=lambda e: e.seq)
    # with one bucket the fused collective becomes ready only once every
    # gradient exists, so overlap can place nothing early: the
    # inside-the-backward guarantee needs >= 2 buckets
    if bp.overlap and len(bp.buckets) >= 2 and not first.in_backward:
        return [Finding(
            "schedule", where=first.name, plan_leaf="bucket[0]",
            expected="first bucket collective issued inside the backward "
                     "(overlap=True)",
            actual="issued after the backward",
            message="exchange does not overlap the backward")]
    early = [e for e in matched if e.in_backward]
    if not bp.overlap and early:
        return [Finding(
            "schedule", where=early[0].name, plan_leaf="bucket[0]",
            expected="every bucket collective issued after the backward "
                     "(overlap=False)",
            actual=f"{len(early)} issued inside the backward",
            message="deferred exchange issued mid-backward")]
    return []


def _check_counts(plan, events: list) -> list:
    """Totals over the replicas: at most one all-reduce a bucket plus the
    metrics'; an unbucketed plan's per-leaf exchange present."""
    observed = sum(1 for e in events if e.kind == "all-reduce")
    bp = plan.bucket_plan
    if bp is not None:
        expected = len(bp.buckets) + 1
        if observed > expected:
            return [Finding(
                "collective-count", plan_leaf="dense",
                expected=f"{expected} all-reduces ({len(bp.buckets)} "
                         "buckets + 1 scalar all-reduce)",
                actual=f"{observed} over the batch axes",
                message="more all-reduces than the bucket plan allows")]
        return []
    n_ar = plan.methods().get("allreduce", 0)
    if n_ar and _replicas(plan) > 1 and len(events) < n_ar:
        return [Finding(
            "missing-collective", plan_leaf="dense",
            expected=f">= 1 collective for each of {n_ar} allreduce leaves",
            actual=f"{len(events)} over the batch axes",
            message="unbucketed dense exchange absent")]
    return []


def check_contract(plan, record, *, strict_dtype: bool = False) -> Findings:
    """Diff one step's ``record`` (a ``collectives.Record`` or its list of
    events) against ``plan``. Returns the :class:`Finding` list — empty
    when the step carries out the plan — with ``.outside``, the count by
    kind of the collectives over no batch axis. ``strict_dtype`` also
    requires each bucket collective to ride the planned wire dtype (the
    record holds the dtype that rode, so the port can always ask)."""
    events = list(getattr(record, "events", record))
    axes = set(_batch_axes(plan))
    pool = [e for e in events if axes & set(e.axes)]
    outside = {}
    for e in events:
        if not axes & set(e.axes):
            outside[e.kind] = outside.get(e.kind, 0) + 1
    findings = []
    if plan.bucket_plan is not None:
        work = list(pool)
        bfinds, matched = _check_buckets(plan, work, strict_dtype)
        findings += bfinds
        findings += _check_sparse(plan, work)
        findings += _check_scalars(work)
        findings += _check_schedule(plan, matched)
    findings += _check_counts(plan, pool)
    return Findings(findings, outside)


def verify_step_contract(plan, record, *, strict_dtype: bool = False
                         ) -> None:
    """The verify gate (``RunConfig.verify_contract``): raise
    :class:`ContractViolation` when the step's collectives do not carry
    out the plan."""
    findings = check_contract(plan, record, strict_dtype=strict_dtype)
    if findings:
        raise ContractViolation(findings)
