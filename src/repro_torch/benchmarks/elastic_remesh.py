"""The elastic straggler response, on process meshes: the four chaos
phases of the reference's ``benchmarks/elastic_remesh.py``, through the
port's trainer on gloo ranks (``launch/mesh.py::spawn``).

  * ``chaos``: one data slice of a (4 data x 2 model) mesh turns into a
    sustained straggler (its ranks sleep inside each step); the monitor
    escalates and the trainer commits a checkpoint, drops the slice
    (``shrink_mesh``), re-plans at the new N and resumes. Reported:
    tokens/s healthy -> straggled -> after the remesh, the plan re-priced
    across it, and the loss against a never-straggled run (0.0 before the
    remesh, the reduction-order difference after it);
  * ``reprice``: at a declared α 0.3 on (4, 1) the table exchanges on the
    dense all-reduce, and the shrink to N = 3 flips it to ``mpi_gatherv``;
  * ``flap``: heartbeats on; the straggling slice is named by its own
    beat (its step less its time blocked in collectives), evicted, and
    ``readmit`` grows it back at its index on probation ``RETURN_AFTER``
    steps later; a control run with the same schedule by hand and no
    sleep equals it bit for bit over every step;
  * ``jitter``: stalls too spiky to evict anyone flip the sparse table to
    the bounded-stale push, and back with the drain once they stop; no
    staleness violation, and a control run with the same flips by hand
    equals it bit for bit.

    PYTHONPATH=src python -m repro_torch.benchmarks.elastic_remesh \\
        [--device cpu] [--out results/torch_elastic.json]

The ranks run on the card unless ``device="cpu"``. Several ranks share
one card over gloo, whose collectives stage through the host: the step
times and tokens/s are the ranks' on that host, not an exchange's. Each
phase's rank function takes a spec (model, shape, mesh, run config,
schedule) that ``chip_smoke.py`` also drives at full width.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time

import numpy as np

from repro_torch.benchmarks.common import RESULTS, emit, run_on_mesh

OUT = os.path.join(RESULTS, "torch_elastic.json")
# the reference bench's model and knobs: reduced phi3 at vocab 256, f32
PHI3 = dict(arch="phi3-medium-14b", vocab=256, seq=32, batch=8,
            rc=dict(attention_impl="naive", remat="none",
                    param_dtype="float32", compute_dtype="float32",
                    wire_dtype="float32", link_latency=0.0))
# the stalls: 5x the rank's healthy median step, at least the reference
# bench's 0.3 s, so that a loaded host's slower steps still stand out
CHAOS = dict(PHI3, mesh=(4, 2), steps=20, slow_from=6, sleep="5x",
             sleep_floor=0.3,
             rc=dict(PHI3["rc"], capacity_mode="capped",
                     capacity_factor=2.0),
             tcfg=dict(remesh_cooldown=20, min_data_parallel=2),
             monitor=dict(sustained=3, min_samples=4))
# the flap and the jitter run under the verify gate: the first step after
# each build (a remesh, a regrow, a flip) is checked against its plan
FLAP = dict(CHAOS, steps=26, slow_from=4, slot=1, return_after=4,
            rc=dict(CHAOS["rc"], heartbeat=True, verify_contract=True),
            tcfg=dict(CHAOS["tcfg"], probation_steps=50,
                      probation_sustained=2),
            # wall-time outliers counted from the first slow step, as the
            # heartbeats are: the two escalations reach ``sustained``
            # together
            monitor=dict(sustained=3, min_samples=5))
JITTER = dict(PHI3, mesh=(4, 1), steps=26, jit_from=4, jit_to=14,
              sleep="5x", sleep_floor=0.3, slot=1,
              rc=dict(PHI3["rc"], table_alpha=(("embed", 0.1),),
                      max_staleness=2, verify_contract=True),
              tcfg=dict(stale_on_jitter=True),
              # jitter stays below eviction, one recompile outlier after a
              # flip does not re-trigger, the exit hysteresis drains in time
              monitor=dict(sustained=8, min_samples=6, window=10))
REPRICE = dict(PHI3, mesh=(4, 1), steps=4,
               rc=dict(PHI3["rc"], table_alpha=(("embed", 0.3),)))


# ---------------------------------------------------------------------------
# the ranks (module level: spawned processes import them)
# ---------------------------------------------------------------------------

def _trainer(rank, spec, mesh, **tcfg):
    """The spec's model on ``mesh``: ``vocab`` None keeps the arch's full
    width; ``rc`` a RunConfig or its keywords. Every launch count is set
    to 0 here: the run's launches are this rank's."""
    import torch
    import repro_torch.configs as tc
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import ops
    from repro_torch.runtime.trainer import Trainer, TrainerConfig
    cfg = tc.get_config(spec["arch"])
    if spec.get("vocab"):
        cfg = tc.reduced(cfg, vocab=spec["vocab"])
    shape = tc.ShapeConfig("elastic", spec["seq"], spec["batch"], "train")
    rc = spec["rc"] if isinstance(spec["rc"], tc.RunConfig) else \
        tc.RunConfig(**spec["rc"])
    ops.reset_launch_counts()
    t = Trainer(cfg, shape, rc,
                TrainerConfig(total_steps=spec["steps"],
                              **{**spec.get("tcfg", {}), **tcfg}),
                SyntheticLM(cfg.vocab_size, spec["seq"], spec["batch"],
                            seed=spec.get("seed", 0)),
                mesh=mesh, device=mesh.device)
    for k, v in spec.get("monitor", {}).items():
        setattr(t.monitor, k, v)
    if mesh.device.type == "cuda":
        # the control runs are compared bit for bit: index_add_'s atomics
        # are not deterministic on the card
        torch.use_deterministic_algorithms(True, warn_only=True)
    return t


def _mesh(spec):
    import torch
    from repro_torch.launch.mesh import make_mesh
    dev = torch.device("cpu") if spec["device"] == "cpu" else \
        torch.device("cuda", torch.cuda.current_device())
    return make_mesh(spec["mesh"], ("data", "model"), device=dev)


def _slow(t, when, seconds, hist, floor: float = 0.0):
    """Sleep inside each step for which ``when(step)`` holds: the rank's
    own work grows, the others wait for it at each collective. A rebuild
    of the step (a remesh, a flip) takes it off. ``seconds``: a float, or
    "<k>x": k times the median step time of ``hist`` so far (its first
    step left out), at least ``floor``, taken at the first sleep."""
    step = t.train_step
    fixed = {}

    def sleep_s() -> float:
        if "s" not in fixed:
            fixed["s"] = float(seconds) if not isinstance(seconds, str) \
                else max(floor, float(seconds.rstrip("x")) * float(
                    np.median([h["step_time_s"] for h in hist[1:]]
                              or [0.0])))
        return fixed["s"]

    def slow_step(state, batch):
        if when(t.step):
            time.sleep(sleep_s())
        return step(state, batch)
    slow_step.slowed = True
    t.train_step = slow_step


def _row(t, s, m) -> dict:
    """One step's record: the numbers the phases read, and the plan in
    force after it (the next step's)."""
    return dict(step=s, loss=float(m["loss"]),
               step_time_s=float(m["step_time_s"]),
               tokens_per_s=float(m["tokens_per_s"]),
               remeshes=int(m.get("remeshes", 0)),
               regrows=int(m.get("regrows", 0)),
               straggler_slice=m.get("straggler_slice"),
               heartbeats=m.get("heartbeats"),
               mesh=[int(x) for x in t.mesh.ranks.shape] if t.mesh else None,
               methods=dict(t.plan.table_methods),
               capacity=dict(t.plan.table_capacity),
               stale_flips=int(m.get("stale_flips", 0)),
               staleness_age=m.get("staleness_age"),
               staleness_violation=m.get("staleness_violation"))


def _probe(spec, rank, t, tag):
    """The spec's per-rank check after a change of mesh or plan (a
    module-level ``probe(rank, trainer, tag) -> dict``, e.g. the card
    check's kernel comparison at the new capacities), or None. Its
    launches are not the run's: they are taken off the counts."""
    from repro_torch.kernels import ops
    fn = spec.get("probe")
    if fn is None or not t.live:
        return None
    before = ops.launch_counts()
    out = fn(rank, t, tag)
    _probe_launches.append({k: v - before[k]
                            for k, v in ops.launch_counts().items()})
    return out


_probe_launches: list = []


def _launches() -> dict:
    """This rank's launches since the trainer was built, the probes'
    taken off."""
    from repro_torch.kernels import ops
    out = ops.launch_counts()
    for p in _probe_launches:
        out = {k: v - p.get(k, 0) for k, v in out.items()}
    _probe_launches.clear()
    return out


def chaos_ranks(rank, world, spec) -> dict:
    """``spec["straggle"]``: data slice ``slot`` (default the last) sleeps
    from ``slow_from``; the trainer remeshes on the escalation (after a
    checkpoint into ``spec["ckpt_dir"]`` when given). Else the
    never-straggled run."""
    from repro_torch.checkpoint.ckpt import latest_step
    mesh = _mesh(spec)
    slot = spec.get("slot", mesh.shape["data"] - 1)
    ckpt = spec.get("ckpt_dir") if spec["straggle"] else None
    t = _trainer(rank, spec, mesh, remesh_on_straggle=spec["straggle"],
                 ckpt_dir=ckpt, ckpt_every=10 ** 6)
    tables0 = t.plan.tables()
    hist = []
    if spec["straggle"] and mesh.coords["data"] == slot:
        _slow(t, lambda s: s >= spec["slow_from"], spec["sleep"], hist,
              spec.get("sleep_floor", 0.0))
    t.run(on_metrics=lambda s, m: hist.append(_row(t, s, m)))
    out = {"rank": rank, "live": t.live, "hist": hist, "tables0": tables0,
           "remeshes": t.monitor.remeshes, "step": t.step,
           "latest_ckpt": latest_step(ckpt) if ckpt else None}
    if t.live:
        out.update(tables1=t.plan.tables(), mesh_after=dict(t.mesh.shape))
    return out


def flap_ranks(rank, world, spec) -> dict:
    """Attributed eviction of data slice ``slot`` and its re-admission
    inside the run, ``return_after`` steps later. ``spec["schedule"]``
    (evict step, readmit step): the control run, the same shrink and grow
    by hand, no sleep."""
    from repro_torch.launch.mesh import grow_mesh, shrink_mesh
    mesh = _mesh(spec)
    slot = spec["slot"]
    sched = spec.get("schedule")
    t0 = time.perf_counter()
    t = _trainer(rank, spec, mesh, remesh_on_straggle=sched is None)
    init_s = time.perf_counter() - t0
    methods0 = dict(t.plan.table_methods)
    probes = {"start": _probe(spec, rank, t, "start")}
    hist = []

    def upto(n):
        t.tcfg = dataclasses.replace(t.tcfg, total_steps=n)
        t.run(on_metrics=lambda s, m: hist.append(_row(t, s, m)))

    if sched is not None:
        evict, back = sched
        upto(evict)
        ranks = mesh.ranks[slot]
        t.remesh(shrink_mesh(t.mesh, drop_axis_index=slot))
        upto(back)
        t.remesh(grow_mesh(t.mesh, ranks, insert_axis_index=slot))
        upto(spec["steps"])
        return {"rank": rank, "hist": hist, "grid": t.mesh.ranks.tolist(),
                "launches": _launches()}
    if mesh.coords["data"] == slot:
        _slow(t, lambda s: s >= spec["slow_from"], spec["sleep"], hist,
              spec.get("sleep_floor", 0.0))
    ev = {"evict": None, "back": None, "grid_shrunk": None,
          "probation": None, "evict_s": None, "readmit_s": None}
    last = [time.perf_counter()]

    def cb(s, m):
        if ev["evict"] is None and m.get("remeshes"):
            ev["evict"], ev["grid_shrunk"] = s, t.mesh.ranks.tolist()
            # the eviction's own seconds: since the last step's end, less
            # this step's
            ev["evict_s"] = time.perf_counter() - last[0] - \
                m["step_time_s"]
            probes["shrunk"] = _probe(spec, rank, t, "shrunk")
        elif ev["back"] is None and ev["evict"] is not None and \
                s == ev["evict"] + spec["return_after"]:
            r0 = time.perf_counter()
            t.readmit()               # the host recovered: on probation
            ev["readmit_s"] = time.perf_counter() - r0
            ev["back"] = s
            ev["probation"] = (t.monitor._probation or (None,))[0]
        hist.append(_row(t, s, m))    # the plan the next step runs on
        last[0] = time.perf_counter()
    t.run(on_metrics=cb)
    probes["end"] = _probe(spec, rank, t, "end")
    return {"rank": rank, "hist": hist, **ev, "grid": t.mesh.ranks.tolist(),
            "remeshes": t.monitor.remeshes, "regrows": t.monitor.regrows,
            "probes": probes, "launches": _launches(), "methods0": methods0,
            "init_s": init_s}


def jitter_ranks(rank, world, spec) -> dict:
    """Every other step from ``jit_from`` to ``jit_to`` data slice ``slot``
    stalls. ``spec["schedule"]`` (on, off): the control run, the same
    flips by hand, no stall."""
    mesh = _mesh(spec)
    sched = spec.get("schedule")
    t = _trainer(rank, spec, mesh, stale_on_jitter=sched is None)
    method, stale0 = t.plan.table_methods, list(t.plan.stale_tables)
    hist, probes = [], {}

    def upto(n):
        t.tcfg = dataclasses.replace(t.tcfg, total_steps=n)
        t.run(on_metrics=lambda s, m: hist.append(_row(t, s, m)))

    if sched is not None:
        on, off = sched
        upto(on)
        t._flip_stale(True)
        upto(off)
        t._flip_stale(False)
        upto(spec["steps"])
        return {"rank": rank, "hist": hist, "launches": _launches()}
    lo, hi = spec["jit_from"], spec["jit_to"]

    def arm():
        if mesh.coords["data"] == spec["slot"]:
            _slow(t, lambda s: lo <= s < hi and s % 2 == 0, spec["sleep"],
                  hist, spec.get("sleep_floor", 0.0))

    def cb(s, m):
        hist.append(_row(t, s, m))
        if m.get("stale_flips") and f"flip{m['stale_flips']}" not in probes:
            probes[f"flip{m['stale_flips']}"] = _probe(spec, rank, t,
                                                       "flip")
            arm()                     # the flip rebuilt the step
    arm()
    t.run(on_metrics=cb)
    return {"rank": rank, "hist": hist, "methods": method, "stale0": stale0,
            "flips": t.monitor.stale_flips, "remeshes": t.monitor.remeshes,
            "final_stale": list(t.plan.stale_tables), "probes": probes,
            "launches": _launches()}


def reprice_ranks(rank, world, spec) -> dict:
    """``steps`` // 2 steps on (N, 1), the shrink to N - 1 by hand, the
    rest: the table's method at both world sizes."""
    from repro_torch.launch.mesh import shrink_mesh
    mesh = _mesh(spec)
    t = _trainer(rank, spec, mesh)
    before = t.plan.table_methods["embed"]
    losses = []
    t.tcfg = dataclasses.replace(t.tcfg, total_steps=spec["steps"] // 2)
    t.run(on_metrics=lambda s, m: losses.append(float(m["loss"])))
    t.remesh(shrink_mesh(mesh, drop_axis_index=mesh.shape["data"] - 1))
    t.tcfg = dataclasses.replace(t.tcfg, total_steps=spec["steps"])
    t.run(on_metrics=lambda s, m: losses.append(float(m["loss"])))
    return {"rank": rank, "before": before, "live": t.live,
            "after": t.plan.table_methods["embed"] if t.live else None,
            "losses": losses}


# ---------------------------------------------------------------------------
# the phases
# ---------------------------------------------------------------------------

def _tok(hist, lo, hi) -> float:
    vals = [h["tokens_per_s"] for h in hist if lo <= h["step"] <= hi]
    return float(np.median(vals)) if vals else float("nan")


def _spawn(fn, spec, device):
    spec = {**spec, "device": str(device)}
    return run_on_mesh(_bound, tuple(spec["mesh"]), device,
                       args=(fn.__name__, spec))


def _bound(rank, world, shape, name, spec):
    return globals()[name](rank, world, spec)


def _schedule(spec, res) -> tuple:
    """The schedule a control run of ``spec``'s phase takes from a run:
    (evict step, readmit step) from the lead of a flap, (on, off) from
    rank 0 of a jitter, sent from that rank to every rank."""
    from repro_torch.core import collectives as coll
    if spec["phase"] == "flap":
        src = _flap_lead(spec)
        sched = (res["evict"], res["back"])
    else:
        src = 0
        sched = _flips(res["hist"])
    return tuple(coll.broadcast_object(sched, src=src))


def _flap_lead(spec) -> int:
    """The first rank of a data slice that stays on the mesh throughout."""
    return spec["mesh"][1] if spec["slot"] == 0 else 0


def _flips(hist) -> tuple:
    on = next((h["step"] for h in hist if h["stale_flips"] == 1), -1)
    off = next((h["step"] for h in hist if h["stale_flips"] == 2), -1)
    return on, off


def chain_ranks(rank, world, shape, specs) -> list:
    """Several runs on one mesh in the same ranks, one after another (a
    card's context, the ranks' start-up and the kernels' loading paid
    once): each spec names its ``phase`` ("flap" or "jitter"); a
    ``schedule`` of "previous" is the control of the run before it."""
    import gc
    import torch
    out = []
    for spec in specs:
        if spec.get("schedule") == "previous":
            spec = {**spec, "schedule": _schedule(spec, out[-1])}
        out.append(globals()[f"{spec['phase']}_ranks"](rank, world, spec))
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    return out


def _chain(specs: list, device) -> list:
    """``chain_ranks`` on ``specs`` (one mesh) -> for each spec, every
    rank's result."""
    specs = [{**s, "device": str(device)} for s in specs]
    ranks = run_on_mesh(chain_ranks, tuple(specs[0]["mesh"]), device,
                        args=(specs,))
    return [[r[i] for r in ranks] for i in range(len(specs))]


def chaos(device: str) -> dict:
    import tempfile
    base = _spawn(chaos_ranks, {**CHAOS, "straggle": False}, device)[0]
    with tempfile.TemporaryDirectory(prefix="elastic_ckpt_") as d:
        runs = _spawn(chaos_ranks, {**CHAOS, "straggle": True,
                                    "ckpt_dir": d}, device)
    lead = runs[0]
    at = next((h["step"] for h in lead["hist"] if h["remeshes"]), -1)
    losses = [h["loss"] for h in lead["hist"]]
    base_l = [h["loss"] for h in base["hist"]]
    sf = CHAOS["slow_from"]
    return dict(
        steps=CHAOS["steps"], slow_from=sf, sleep_s=CHAOS["sleep"],
        remesh_at=at, remeshes=lead["remeshes"],
        mesh_before={"data": 4, "model": 2}, mesh_after=lead["mesh_after"],
        tables_before=lead["tables0"], tables_after=lead["tables1"],
        latest_ckpt=lead["latest_ckpt"],
        evicted=[o["rank"] for o in runs if not o["live"]],
        tokens_per_s=dict(healthy=_tok(lead["hist"], 2, sf - 1),
                          straggled=_tok(lead["hist"], sf + 1, at),
                          after_remesh=_tok(lead["hist"], at + 2,
                                            CHAOS["steps"])),
        losses=losses, base_losses=base_l,
        prefix_divergence=max(abs(a - b) for a, b in
                              zip(losses[:at], base_l[:at])),
        post_divergence=max(abs(a - b) for a, b in
                            zip(losses[at:], base_l[at:])))


def flap(device: str, spec: dict = FLAP) -> dict:
    spec = {**spec, "phase": "flap"}
    runs, ctls = _chain([spec, {**spec, "schedule": "previous"}], device)
    return _flap_record(spec, runs, ctls, device)


def _flap_record(spec, runs, ctls, device) -> dict:
    lead = runs[_flap_lead(spec)]
    e, r = lead["evict"], lead["back"]
    ctl = ctls[lead["rank"]]
    losses = [h["loss"] for h in lead["hist"]]
    control = [h["loss"] for h in ctl["hist"]]
    sf, steps = spec["slow_from"], spec["steps"]
    windows = dict(healthy=(2, max(sf, 2)), straggled=(sf + 1, e),
                   shrunk=(e + 2, r), regrown=(r + 2, steps))
    return dict(
        steps=steps, slow_from=sf, sleep_s=spec["sleep"],
        slow_slice=spec["slot"], evict_at=e, readmit_at=r,
        attributed=[h["straggler_slice"] for h in lead["hist"]
                    if h["step"] == e],
        heartbeats_at_evict=next((h["heartbeats"] for h in lead["hist"]
                                  if h["step"] == e), None),
        remeshes=lead["remeshes"], regrows=lead["regrows"],
        probation=lead["probation"], grid_shrunk=lead["grid_shrunk"],
        evict_s=lead["evict_s"], readmit_s=lead["readmit_s"],
        init_s=lead["init_s"],
        grid_final=lead["grid"],
        # steps 1-based; ``slow_from`` counts steps done, so step sf + 1 is
        # the first slow one; the first step after a change left out
        tokens_per_s={k: _tok(lead["hist"], lo, hi)
                      for k, (lo, hi) in windows.items()},
        step_time_s={k: {o["rank"]: float(np.median(
            [h["step_time_s"] for h in o["hist"] if lo <= h["step"] <= hi]
            or [float("nan")])) for o in runs}
            for k, (lo, hi) in windows.items()},
        losses=losses, control_losses=control,
        equal=losses == control and len(losses) == steps,
        divergence=max(abs(a - b) for a, b in zip(losses, control)),
        probes={o["rank"]: o["probes"] for o in runs}, device=device,
        launches_by_rank=[o["launches"] for o in runs],
        control_launches_by_rank=[o["launches"] for o in ctls],
        steps_by_rank=[[h["step"] for h in o["hist"]] for o in runs],
        methods0=lead["methods0"],
        methods_by_step={h["step"]: h["methods"] for h in lead["hist"]},
        capacity_by_step={h["step"]: h["capacity"] for h in lead["hist"]})


def jitter(device: str, spec: dict = JITTER) -> dict:
    spec = {**spec, "phase": "jitter"}
    runs, ctls = _chain([spec, {**spec, "schedule": "previous"}], device)
    return _jitter_record(spec, runs, ctls, device)


def flap_and_jitter(device: str, fspec: dict, jspec: dict) -> tuple:
    """Both phases on one mesh in one set of ranks (``chain_ranks``) ->
    (the flap's record, the jitter's)."""
    fspec, jspec = {**fspec, "phase": "flap"}, {**jspec, "phase": "jitter"}
    runs, fctl, jruns, jctl = _chain(
        [fspec, {**fspec, "schedule": "previous"},
         jspec, {**jspec, "schedule": "previous"}], device)
    return (_flap_record(fspec, runs, fctl, device),
            _jitter_record(jspec, jruns, jctl, device))


def _jitter_record(spec, runs, ctls, device) -> dict:
    lead = runs[0]
    hist = lead["hist"]
    on, off = _flips(hist)
    ctl = ctls[0]
    stale = [h for h in hist if on < h["step"] <= off]
    losses = [h["loss"] for h in hist]
    control = [h["loss"] for h in ctl["hist"]]
    jf = spec["jit_from"]
    return dict(
        steps=spec["steps"], jitter_from=jf, jitter_to=spec["jit_to"],
        sleep_s=spec["sleep"], methods=lead["methods"],
        stale_on_at=on, stale_off_at=off, stale_flips=lead["flips"],
        final_stale_tables=lead["final_stale"], evictions=lead["remeshes"],
        max_staleness_applied=max((h["staleness_age"] or 0 for h in stale),
                                  default=0),
        violations=sum(h["staleness_violation"] or 0 for h in stale),
        tokens_per_s=dict(healthy=_tok(hist, 2, jf - 1),
                          jittery=_tok(hist, jf + 1, on),
                          stale=_tok(hist, on + 2, off),
                          recovered=_tok(hist, off + 2, spec["steps"])),
        losses=losses, control_losses=control, equal=losses == control,
        probes={o["rank"]: o["probes"] for o in runs}, device=device,
        launches_by_rank=[o["launches"] for o in runs],
        control_launches_by_rank=[o["launches"] for o in ctls],
        methods0=lead["methods"],
        methods_by_step={h["step"]: h["methods"] for h in hist})


def reprice(device: str) -> dict:
    runs = _spawn(reprice_ranks, REPRICE, device)
    return dict(method_n4=runs[0]["before"], method_n3=runs[0]["after"],
                losses=runs[0]["losses"])


def check(res: dict) -> None:
    """The reference bench's asserts, on the port's record."""
    c, f, j, r = res["chaos"], res["flap"], res["jitter"], res["reprice"]
    assert c["remeshes"] == 1, "escalation never fired (or thrashed)"
    assert c["mesh_after"] == {"data": 3, "model": 2}, c["mesh_after"]
    assert c["prefix_divergence"] == 0.0, \
        "the escalation machinery perturbed the shared trajectory"
    assert c["post_divergence"] < 5e-2, "post-remesh trajectory diverged"
    assert c["tokens_per_s"]["after_remesh"] > \
        2.0 * c["tokens_per_s"]["straggled"], \
        "evicting the slow slice did not recover throughput"
    assert c["latest_ckpt"] == c["steps"]
    assert f["attributed"] == [f["slow_slice"]], \
        "the heartbeat attribution did not name the straggler"
    assert f["remeshes"] == 1 and f["regrows"] == 1, f
    assert f["grid_final"] == [[0, 1], [2, 3], [4, 5], [6, 7]]
    assert f["probation"] == f["slow_slice"]
    assert f["equal"], "the flap perturbed the synchronous trajectory"
    assert f["tokens_per_s"]["shrunk"] > 2.0 * f["tokens_per_s"]["straggled"]
    assert j["methods"]["embed"] == "mpi_gatherv", j["methods"]
    assert j["stale_flips"] == 2 and j["evictions"] == 0, j
    assert 1 <= j["max_staleness_applied"] <= 2 and j["violations"] == 0
    assert not j["final_stale_tables"] and j["equal"]
    assert all(math.isfinite(x) for x in j["losses"])
    assert (r["method_n4"], r["method_n3"]) == ("allreduce", "mpi_gatherv")


def report(res: dict, device: str) -> None:
    c, f, j, r = res["chaos"], res["flap"], res["jitter"], res["reprice"]
    tp, fp, jp = c["tokens_per_s"], f["tokens_per_s"], j["tokens_per_s"]
    dev = res["device"]
    emit("elastic/chaos_remesh_at", 0.0,
         f"step={c['remesh_at']};mesh={c['mesh_after']};"
         f"tok_s healthy/straggled/after={tp['healthy']:.0f}/"
         f"{tp['straggled']:.0f}/{tp['after_remesh']:.0f};"
         f"prefix_div={c['prefix_divergence']:.1e};"
         f"post_div={c['post_divergence']:.1e};device={dev}")
    emit("elastic/flap", 0.0,
         f"evict={f['evict_at']};attributed={f['attributed']};"
         f"readmit={f['readmit_at']};tok_s healthy/straggled/shrunk/"
         f"regrown={fp['healthy']:.0f}/{fp['straggled']:.0f}/"
         f"{fp['shrunk']:.0f}/{fp['regrown']:.0f};equal={f['equal']};"
         f"device={dev}")
    emit("elastic/jitter", 0.0,
         f"on={j['stale_on_at']};off={j['stale_off_at']};"
         f"max_age={j['max_staleness_applied']:.0f};"
         f"violations={j['violations']:.0f};tok_s healthy/jittery/stale/"
         f"recovered={jp['healthy']:.0f}/{jp['jittery']:.0f}/"
         f"{jp['stale']:.0f}/{jp['recovered']:.0f};equal={j['equal']};"
         f"device={dev}")
    emit("elastic/reprice", 0.0,
         f"N4={r['method_n4']};N3={r['method_n3']};device={dev}")


def run(device: str) -> dict:
    from repro_torch.benchmarks.common import device_name
    t0 = time.perf_counter()
    res = dict(chaos=chaos(device), reprice=reprice(device),
               flap=flap(device), jitter=jitter(device),
               device=device_name(device))
    res["seconds"] = time.perf_counter() - t0
    return res


def main(argv=None, *, device=None) -> dict:
    """Run the four phases, print, check, write the record."""
    ap = argparse.ArgumentParser(prog="repro_torch.benchmarks."
                                      "elastic_remesh")
    ap.add_argument("--device", default=None,
                    help="cpu or cuda (default: the card)")
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    device = str(device or args.device or "cuda")
    res = run(device)
    report(res, device)
    check(res)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=2, default=str)
    print(f"OK: straggle -> checkpoint -> shrink -> re-price -> resume, "
          f"flap -> attributed evict -> probationary re-admit, jitter -> "
          f"bounded-stale -> drain; wrote {args.out}")
    return res


if __name__ == "__main__":
    main()
