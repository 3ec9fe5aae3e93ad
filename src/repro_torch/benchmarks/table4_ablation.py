"""Paper Table 4 through the port: the cumulative ablation BASE (ps
everywhere, no LA / OPAU / OPSW) -> +HYB -> +LA -> +OPAU -> +OPSW, each
stage a dry-run (launch/dryrun.py) of ``train_4k`` on the 16x16
production mesh (the reference's ``benchmarks/table4_ablation.py``).

Per stage: a card's wire bytes a step (the recorded collectives, ring
factors applied), the roofline-bound step on the H100 record, the tokens
a second that bound gives, and the speedup over BASE. A projection from
counted operations, recorded collectives and the traffic model, not a
measurement: the dry-run computes nothing and runs on the host whatever
the device.

``accounting`` holds each stage's recorded bytes over the batch axes
against the cost model (core/cost_model.py's bytes of each leaf's planned
method on this rank's block of it) plus named terms, as Table 3's
benchmark does:

  ``pull_over_model``  ps / ps_gather's formulas count the pull over
                       ``model``, which is no batch axis (-pull);
  ``buffer_rows``      the sparse formulas price α·b; the push moves the
                       dedupe buffer's capacity rows (without LA the raw
                       tokens');
  ``own_block``        ps_gather's formula counts all D row blocks, a
                       ring all-gather sends the D - 1 others (-αb);
  ``receive_side``     mpi_gatherv's 2(N-1)αb counts what a replica sends
                       and receives, the ring factors what it sends;
  ``uid_gather``       the gather pushes all-gather the int32 ids beside
                       the rows;
  ``fsdp_gather_dtype`` an fsdp leaf is gathered at the parameter's dtype,
                       its gradient reduce-scattered at the wire dtype;
  ``rs_block``         a reduce-scatter's wire bytes are its result
                       block's ((n-1)/n of b/n, the reference's ring
                       factor on the HLO result), the formula's (n-1)/n b;
  ``opau_gather``      without OPAU the clipping norm gathers every
                       sharded gradient whole first (the reference's
                       replicated constraint), over the batch axes too;
  ``tied_head``        a tied table's head gradient is summed over the
                       batch axes beside its push (the cost model prices
                       the table once, by its sparse method);
  ``metrics``          the loss and the scalar metrics, one f32
                       all-reduce (the step's last over the batch axes).

    PYTHONPATH=src python -m repro_torch.benchmarks.run table4
"""
from __future__ import annotations

import os

from repro_torch.benchmarks.common import emit
from repro_torch.configs import SHAPES, RunConfig
from repro_torch.launch.dryrun import run_cells

ARCHS = ("parallax-lm", "command-r-35b")
SHAPE = "train_4k"
RTOL = 1e-3         # recorded against cost model + named terms
STAGES = [
    ("BASE", dict(comm_mode="ps", local_agg=False, opau=False, opsw=False)),
    ("+HYB", dict(comm_mode="hybrid", local_agg=False, opau=False,
                  opsw=False)),
    ("+LA", dict(comm_mode="hybrid", local_agg=True, opau=False, opsw=False)),
    ("+OPAU", dict(comm_mode="hybrid", local_agg=True, opau=True,
                   opsw=False)),
    ("+OPSW", dict(comm_mode="hybrid", local_agg=True, opau=True, opsw=True)),
]


def accounting(plan, rt, model, record) -> dict:
    """This rank's recorded wire bytes over the batch axes beside the
    cost model's bytes of each leaf's planned method and the named terms
    (module docstring): {"recorded", "formula", "terms"}."""
    import math

    import torch

    from repro_torch.core import buckets
    from repro_torch.core import collectives as coll
    from repro_torch.core import cost_model as cm
    from repro_torch.core.runtime import mesh_dims
    from repro_torch.models.layers import flatten_specs
    from repro_torch.weights import block_dims, shard_shape

    mesh, ba = rt.mesh, tuple(rt.batch_axes)
    recorded = sum(coll.wire_bytes(ev) for ev in record.events
                   if set(ev.axes) & set(ba))
    dims = mesh_dims(mesh)
    n = rt.replicas
    item = lambda dt: torch.empty((), dtype=dt).element_size()
    formula = 0.0
    terms = {}

    def add(k, v):
        terms[k] = terms.get(k, 0.0) + v

    tokens = rt.shape_cfg.tokens // n
    ring = (n - 1) / n
    pushed = ("ps", "ps_gather", "mpi_gatherv")
    for name, spec in flatten_specs(model.specs()):
        p = plan.params[name]
        numel = math.prod(spec.shape)
        blk = math.prod(shard_shape(spec.shape, p.held, mesh))
        grad_item = item(rt.param_dtype)
        if p.sparse:
            wire = item(plan.table_wire[name])
            b = numel * wire
            alpha = plan.table_alpha[name]
            method = plan.table_methods[name]
            e = spec.shape[1]
            rows = (min(plan.table_capacity[name], tokens)
                    if rt.run_cfg.local_agg else tokens)
            m = dims.model if method in ("ps", "ps_gather") else 1
            pull = 2.0 * alpha * b * (m - 1) / m if m > 1 else 0.0
            if method == "ps":
                formula += cm.sparse_ps_bytes(b, alpha, dims)
                add("pull_over_model", -pull)
            elif method == "ps_gather":
                formula += cm.sparse_ps_gather_bytes(b, alpha, dims)
                add("pull_over_model", -pull)
                add("buffer_rows", n * (rows * e * wire - alpha * b))
                add("own_block", -rows * e * wire)
                add("uid_gather", (n - 1) * rows * 4)
            elif method == "mpi_gatherv":
                formula += cm.sparse_mpi_bytes(b, alpha, dims)
                add("buffer_rows", 2 * (n - 1) * (rows * e * wire
                                                  - alpha * b))
                add("receive_side", -(n - 1) * rows * e * wire)
                add("uid_gather", (n - 1) * rows * 4)
            else:           # a table on the dense exchange
                formula += cm.dense_allreduce_bytes(blk * wire, dims)
            if model.cfg.tie_embeddings and method in pushed:
                cut = rt.vocab_shards > 1 and \
                    spec.shape[0] // rt.vocab_shards != blk // e
                k = n * (dims.model if cut else 1)
                add("tied_head", 2.0 * (k - 1) / k * blk * grad_item)
        else:
            wire = item(buckets.exchange_dtype(rt, p))
            grad_item = wire
            sharded_over_batch = any(
                set(axes) & set(ba)
                for _, axes, _ in block_dims(p.held, mesh))
            if p.method == "fsdp" and sharded_over_batch:
                # the leaf's model block, gathered over the batch axes
                whole = blk * n
                formula += cm.dense_fsdp_bytes(whole * wire, dims)
                add("fsdp_gather_dtype",
                    ring * whole * (item(rt.param_dtype) - wire))
                add("rs_block", ring * blk * wire - ring * whole * wire)
            else:
                formula += cm.dense_allreduce_bytes(blk * wire, dims)
        if not rt.run_cfg.opau:
            size = blk
            for _, axes, _ in block_dims(p.held, mesh):
                k = mesh.axes_size(axes)
                size *= k
                if set(axes) & set(ba):
                    add("opau_gather", (k - 1) / k * size * grad_item)
    last = [ev for ev in record.events
            if set(ev.axes) & set(ba) and ev.kind == "all-reduce"]
    if last:
        add("metrics", coll.wire_bytes(last[-1]))
    return {"recorded": recorded, "formula": formula, "terms": terms}


def stage_config(flags: dict) -> RunConfig:
    return RunConfig(capacity_mode="capped", remat="full", **flags)


def summary(res: dict, tokens: int) -> dict:
    """A dry-run cell -> the row: collective_GB, bound_ms, tok_s, the
    terms of the three roofline times, the peak, and the batch-axis
    accounting (raises when a stage failed, broke its contract, or its
    recorded bytes miss the cost model plus the named terms by RTOL)."""
    if not res["ok"]:
        raise RuntimeError(f"table4: {res['arch']} failed: "
                           f"{res.get('error') or res['contract']}")
    r, acc = res["roofline"], res["account"]
    held = acc["formula"] + sum(acc["terms"].values())
    rel = abs(acc["recorded"] - held) / held
    if rel > RTOL:
        raise AssertionError(
            f"table4 {res['arch']}: recorded {acc['recorded']} B over the "
            f"batch axes, cost model {acc['formula']} + terms "
            f"{acc['terms']} = {held} (rel {rel}, bar {RTOL})")
    return {"collective_GB": r["per_chip_collective_bytes"] / 1e9,
            "bound_ms": r["bound_s"] * 1e3, "tok_s": tokens / r["bound_s"],
            "dominant": r["dominant"], "compute_ms": r["compute_s"] * 1e3,
            "memory_ms": r["memory_s"] * 1e3,
            "collective_ms": r["collective_s"] * 1e3,
            "peak_GB": res["memory_analysis"]["peak_bytes"] / 1e9,
            "batch_axis_bytes": acc, "rel_to_model_plus_terms": rel}


def ablation(archs=ARCHS, workers: int = 0, shape=SHAPE) -> dict:
    """{arch: {stage: row}} (rows with ``speedup_vs_base``). ``shape``: a
    SHAPES name or a ShapeConfig (a test's shorter sequence)."""
    workers = workers or (os.cpu_count() or 1)
    tokens = (SHAPES[shape] if isinstance(shape, str) else shape).tokens
    cells = [dict(arch=a, shape_name=shape, run_cfg=stage_config(f),
                  verbose=False, account=accounting)
             for a in archs for _, f in STAGES]
    res = iter(run_cells(cells, workers))
    out = {}
    for arch in archs:
        rows = {name: summary(next(res), tokens) for name, _ in STAGES}
        base = rows["BASE"]["tok_s"]
        for row in rows.values():
            row["speedup_vs_base"] = row["tok_s"] / base
        out[arch] = rows
    return out


def main(device: str = "cuda", archs=ARCHS) -> dict:
    out = ablation(archs)
    for arch, rows in out.items():
        for name, r in rows.items():
            emit(f"table4/{arch}/{name}", r["bound_ms"] * 1e3,
                 f"collective_GB={r['collective_GB']:.2f};"
                 f"tok_s={r['tok_s']:.0f};"
                 f"speedup_vs_base={r['speedup_vs_base']:.2f};"
                 f"dominant={r['dominant']};"
                 f"device=host (dry-run, priced on the H100 record; "
                 f"--device {device} unused)")
    return out


if __name__ == "__main__":
    main()
