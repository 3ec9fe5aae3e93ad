"""Paper Table 3 through the port: the bytes a replica puts on the wire for
the embedding exchange under each method, recorded
(``core/collectives.py::record``), beside the cost model's
``sparse_{ps,ps_gather,mpi}_bytes`` at the same dims (the reference's
``benchmarks/table3_transfer.py``).

An embedding-only step (lookup -> loss -> gradient) on a process mesh, so
every collective belongs to the exchange under test: ``ps``, ``ps_gather``
and ``mpi_gatherv`` with local aggregation, and ``ps`` without it. The
paper's sizes: a 65,536 x 512 bf16 table, 256 x 256 uniform ids, each
replica's dedupe buffer at the expected unique count + 1. The reference
lowers the step on a (16, 16) mesh of fake devices; the port runs real
ranks, (2, 2) by default, and prints the (16, 16) analytic column beside.

Where the recorded bytes differ from the formula by a collective the
formula leaves out or counts otherwise, the term is named and the record
is held to formula + terms within ``RTOL``:

  ``uid_gather``    ps_gather and mpi_gatherv all-gather the int32 ids of
                    the rows beside the rows;
  ``own_block``     ps_gather's formula counts all D row blocks a
                    replica's gather returns; a ring all-gather sends the
                    D - 1 that are not its own (-αb);
  ``receive_side``  mpi_gatherv's 2(N-1)αb counts each block a replica
                    sends and receives; the ring factors count what it
                    sends (-(N-1)αb).

On the card the ranks share it over gloo, which stages the gathers
through the host: the collectives' times are not exchange times.

    PYTHONPATH=src python -m repro_torch.benchmarks.run table3 [--device cpu]
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.benchmarks.common import device_name, emit, run_on_mesh
from repro_torch.core import collectives as coll
from repro_torch.core import cost_model as cm

SIZES = (65536, 512, 256, 256)        # V, E, B, S: the paper's
MESH = (2, 2)
PAPER_MESH = (16, 16)
WIRE_BYTES = 2                        # bf16 rows
ID_BYTES = 4                          # int32 ids
RTOL = 1e-2
# case -> (method, local aggregation)
CASES = {"ps": ("ps", True), "ps_gather": ("ps_gather", True),
         "mpi_gatherv": ("mpi_gatherv", True), "ps_noLA": ("ps", False)}
_FORMULA = {"ps": cm.sparse_ps_bytes, "ps_gather": cm.sparse_ps_gather_bytes,
            "mpi_gatherv": cm.sparse_mpi_bytes}


def workload(sizes=SIZES, mesh=MESH) -> dict:
    """The replica's tokens, the expected unique rows of uniform ids, α,
    the dedupe capacity and the table's bytes b."""
    v, e, b, s = sizes
    tokens = b * s // mesh[0]
    uniq = v * (1 - math.exp(tokens * math.log1p(-1 / v)))
    return {"tokens": tokens, "unique": uniq, "alpha": uniq / v,
            "capacity": int(uniq) + 1, "table_bytes": v * e * WIRE_BYTES}


def analytic(case: str, sizes=SIZES, mesh=MESH) -> float:
    """The cost model's bytes a replica for ``case`` on ``mesh``; without
    local aggregation α is the raw token buffer's, tokens / V."""
    w = workload(sizes, mesh)
    method, la = CASES[case]
    alpha = w["alpha"] if la else w["tokens"] / sizes[0]
    dims = cm.MeshDims(data=mesh[0], model=mesh[1])
    return _FORMULA[method](w["table_bytes"], alpha, dims)


def terms(case: str, sizes=SIZES, mesh=MESH) -> dict:
    """The named terms between the formula and the record (see the module
    docstring), in bytes."""
    w = workload(sizes, mesh)
    d = mesh[0]
    ab = w["alpha"] * w["table_bytes"]
    uids = (d - 1) * w["capacity"] * ID_BYTES
    if case == "ps_gather":
        return {"uid_gather": uids, "own_block": -ab}
    if case == "mpi_gatherv":
        return {"uid_gather": uids, "receive_side": -(d - 1) * ab}
    return {}


def transfer_rank(rank: int, world: int, shape: tuple, sizes: tuple,
                  device: str) -> dict:
    """Each case's embedding-only step on this rank of a (data, model)
    mesh of ``shape`` under a record: its collectives (kind, axes,
    payload and wire bytes, ms) and their wire bytes summed."""
    from repro_torch.core.embedding import EmbedCtx, lookup
    from repro_torch.launch.mesh import make_mesh, rank_device
    dev = rank_device(device, rank)
    mesh = make_mesh(shape, ("data", "model"), device=dev)
    v, e, b, s = sizes
    w = workload(sizes, shape)
    ids = np.random.default_rng(0).integers(0, v, size=(b, s))
    rows = b // shape[0]
    d = mesh.coords["data"]
    ids = torch.from_numpy(ids[d * rows:(d + 1) * rows]).to(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {}
    for case, (method, la) in CASES.items():
        vs = v if method == "mpi_gatherv" else v // shape[1]
        table = torch.randn((vs, e), generator=gen, device=dev).to(
            torch.bfloat16).requires_grad_()
        ctx = EmbedCtx(method=method, vocab_padded=v,
                       wire_dtype=torch.bfloat16, local_agg=la, exact=False,
                       mesh=mesh, batch_axes=("data",), model_axis="model")
        with coll.record() as rec:
            got, _ = lookup(table, ids, ctx=ctx, capacity=w["capacity"])
            loss = torch.sum(got.float() ** 2)
            with coll.backward():
                loss.backward()
        out[case] = {
            "collectives": [{"kind": ev.kind, "axes": list(ev.axes),
                             "dtype": ev.dtype, "bytes": ev.bytes,
                             "wire_bytes": coll.wire_bytes(ev),
                             "ms": ev.ms, "in_backward": ev.in_backward}
                         for ev in rec.events],
            "wire_bytes": sum(coll.wire_bytes(ev) for ev in rec.events),
            "grad_finite": bool(torch.isfinite(table.grad.float()).all())}
    return out


def run(sizes=SIZES, mesh=MESH, device="cuda") -> dict:
    """Every case on ``mesh``: rank 0's recorded wire bytes beside the
    formula, its named terms and the (16, 16) formula; raises when the
    ranks disagree or a record misses formula + terms by ``RTOL``."""
    ranks = run_on_mesh(transfer_rank, mesh, device, args=(sizes, device))
    rows = {}
    for case in CASES:
        got = [r[case]["wire_bytes"] for r in ranks]
        want = analytic(case, sizes, mesh)
        named = terms(case, sizes, mesh)
        held = want + sum(named.values())
        rel = abs(got[0] - held) / held
        if len(set(got)) != 1 or rel > RTOL or not all(
                r[case]["grad_finite"] for r in ranks):
            raise AssertionError(
                f"table3 {case}: recorded {got} bytes a replica, formula "
                f"{want} + terms {named} = {held} (rel {rel}, bar {RTOL})")
        rows[case] = {
            "recorded_bytes": got[0], "analytic_bytes": want,
            "terms": named, "rel_to_analytic_plus_terms": rel,
            "analytic_bytes_16x16": analytic(case, sizes, PAPER_MESH),
            "collectives": ranks[0][case]["collectives"]}
    return {"mesh": list(mesh), "sizes": list(sizes),
            "workload": workload(sizes, mesh),
            "workload_16x16": workload(sizes, PAPER_MESH), "cases": rows}


def main(device="cuda") -> dict:
    res = run(device=device)
    for case, r in res["cases"].items():
        ms = sum(c["ms"] or 0.0 for c in r["collectives"])
        emit(f"table3/{case}", ms * 1e3,
             f"recorded_MB={r['recorded_bytes'] / 1e6:.1f};"
             f"analytic_MB={r['analytic_bytes'] / 1e6:.1f};"
             + "".join(f"{k}_MB={v / 1e6:.3f};"
                       for k, v in r["terms"].items())
             + f"analytic_16x16_MB={r['analytic_bytes_16x16'] / 1e6:.1f};"
             f"alpha={res['workload']['alpha']:.4f};"
             f"mesh={'x'.join(map(str, MESH))};device={device_name(device)};"
             "us=gloo collectives staged through the host, not exchange "
             "time")
    return res
