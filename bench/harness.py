"""One run of one cell: set-up, the measured window, the traced stretch, the
check against the plain reference, and the result line.

A cell is an entry of ``BENCHMARK.json``'s ``workloads``; everything that
belongs to it is found by name: its configuration file (``configs``'
``file``), its traffic mix (``bench/traffic/<traffic>.json``), its limits
(``bench/limits/<workload>.json``) and a reader for each of its metrics
(``bench/metrics/<metric>.py``, a ``read(run)`` that returns a number or
None). Adding a cell, a mix or a metric adds files and entries and edits
none.

The program is driven through its trainer (``repro_torch.runtime.trainer.
Trainer``, the path ``launch/train.py`` drives), one step a ``run`` call:
``total_steps`` is raised by one and ``run`` trains that step, so the
window ends at a step boundary without anything raised through ``run``.
Set-up builds the trainer, hands it the benchmark's weights
(``weights.py``, drawn on the device from the seed) through
``core/transform.py::load_params_``, and trains the compared steps and the
warm-up through the same call and feed as the window. Its readings of the
compared steps are checked against the reference (``check.py``) once the
window and the trace are over and the trainer is freed.

On a cell of several chips the ranks are started by the port's
``launch/mesh.py::spawn`` over NCCL, one card a rank, on a (ranks, 1) mesh
over ``data``; rank 0 decides when the window ends and tells the others
over a gloo group, so every rank trains the same steps. Ranks hand back
plain numbers; the reference runs in the starting process once they have
ended.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import math
import statistics
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Optional

import numpy as np

from bench import check, counters, reference, weights
from bench import trace as tracing
from bench.traffic import Mix, Stream, load_mix

ROOT = Path(__file__).resolve().parents[1]
TRACE_RANGE = "bench.traced"
# top-level module names a run may not hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# norms are summed in float64 over chunks of this many elements
NORM_CHUNK = 1 << 26


@dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict
    mix: Mix
    end_to_end: list
    per_layer: list
    limits: dict
    root: Path = ROOT

    @property
    def tokens_per_step(self) -> int:
        return self.mix.tokens_per_step


def load_cell(workload: str, root: Path = ROOT) -> Cell:
    """Workload ``workload`` of ``<root>/BENCHMARK.json`` with its files and
    the metrics it reports: an end-to-end metric unless its ``workloads``
    leave the cell out; a per-layer metric where its ``workloads`` name
    the cell or, without the key, where the cell reports what it moves."""
    root = Path(root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r}; known: {sorted(cells)}")
    w = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((root / conf["file"]).read_text())
    mix = load_mix(w["traffic"], root / "bench" / "traffic")
    if mix.ranks != w["chips"]:
        raise ValueError(f"{workload}: traffic {mix.name} has {mix.ranks} "
                         f"ranks, the cell {w['chips']} chips")
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    moves = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (workload in m["workloads"] if "workloads" in m
                 else m["moves"] in moves)]
    return Cell(name=workload, chips=int(w["chips"]), config_name=w["config"],
                config=config, mix=mix, end_to_end=e2e, per_layer=layer,
                limits=check.load_limits(workload, root / "bench" / "limits"),
                root=root)


def reader(name: str, root: Path = ROOT) -> Callable:
    """``read`` of ``<root>/bench/metrics/<name>.py``; a metric named
    ``<base>.<part>`` without a file of its own is read by ``<base>.py``
    (the same quantity, split by the end-to-end metric it moves)."""
    metrics = Path(root) / "bench" / "metrics"
    path = metrics / f"{name}.py"
    if not path.exists() and "." in name:
        path = metrics / f"{name.rsplit('.', 1)[0]}.py"
    spec = importlib.util.spec_from_file_location(
        f"bench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# ---------------------------------------------------------------------------
# what the readers read
# ---------------------------------------------------------------------------

@dataclass
class RankRun:
    """One rank's run, for the per-layer readers: the traced stretch and
    what the benchmark knows of each traced step."""
    cell: Cell
    rank: int
    world: int
    trace: Optional[tracing.Trace]
    # per traced step: {"step", "capacity" (the lookup's buffer rows),
    # "unique" (distinct ids in this rank's rows)}
    steps: list
    table_rows: int            # this rank's rows of the embedding table
    width: int                 # the table's row width
    table_itemsize: int        # bytes of a table element
    wire_itemsize: int         # bytes of a pushed gradient element
    window: dict               # the measured window: {"steps",
                               # "seconds", "step_s"}
    wire_bytes_per_step: Optional[float] = None

    @property
    def flops_per_step(self) -> int:
        """Counted operations of one step on this rank."""
        return counters.train_step_flops(self.cell.config,
                                         self.cell.mix.batch_per_rank,
                                         self.cell.mix.seq_len)


@dataclass
class CellRun:
    """The whole run, for the end-to-end readers: every rank's record
    (rank 0 first) and the set-up time."""
    cell: Cell
    ranks: list
    setup_s: float

    @property
    def window(self) -> dict:
        return self.ranks[0]["window"]


# ---------------------------------------------------------------------------
# the program side
# ---------------------------------------------------------------------------

def port_configs(cell: Cell, seed: int) -> tuple:
    """(ModelConfig, ShapeConfig, RunConfig, TrainerConfig) of the port
    for ``cell``: the port's registered architecture with the numbers of
    the configuration file."""
    from repro_torch.configs import RunConfig, ShapeConfig, get_config
    from repro_torch.runtime.trainer import TrainerConfig
    cfg = cell.config
    base = get_config(cfg["arch"])
    if base.family != cfg["family"]:
        raise ValueError(f"{cell.config_name}: family {cfg['family']} but "
                         f"the port's {cfg['arch']} is {base.family}")
    fields = {f.name for f in dataclasses.fields(base)} - {
        "name", "family", "source"}
    model = dataclasses.replace(base, **{k: v for k, v in cfg.items()
                                         if k in fields})
    shape = ShapeConfig(cell.mix.name, cell.mix.seq_len,
                        cell.mix.global_batch, "train")
    opt = cfg["optimizer"]
    run = RunConfig(param_dtype=cfg["dtype"], compute_dtype=cfg["dtype"],
                    optimizer=opt["name"], learning_rate=opt["lr"],
                    weight_decay=opt["weight_decay"],
                    clip_norm=opt["clip_norm"], seed=int(seed) % (1 << 31),
                    **cfg["run"])
    trainer = TrainerConfig(total_steps=0, log_every=1 << 30,
                            **cfg["trainer"])
    return model, shape, run, trainer


def forbidden_modules() -> list:
    """The names of ``FORBIDDEN`` that this process has loaded, compared by
    whole top-level name."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def norm(a, b=None, b_scale: float = 1.0) -> float:
    """||a - b_scale * b|| (||a|| without ``b``, which may live on another
    device): f32 chunks, summed in float64."""
    import torch
    fa = a.detach().reshape(-1)
    fb = None if b is None else b.detach().reshape(-1)
    acc = 0.0
    for lo in range(0, fa.numel(), NORM_CHUNK):
        d = fa[lo:lo + NORM_CHUNK].float()
        if fb is not None:
            d = d - b_scale * fb[lo:lo + NORM_CHUNK].to(fa.device).float()
        acc = acc + torch.sum(d * d, dtype=torch.float64)
    return math.sqrt(float(acc))


def _canonical(trainer):
    from repro_torch.optim.optimizer import is_fused, unfuse_state
    s = trainer.state
    return unfuse_state(s, trainer.plan.bucket_plan) if is_fused(s) else s


def _whole(t, pp, mesh, shape: tuple):
    """A leaf (this rank's block on a mesh) as the whole tensor."""
    from repro_torch.weights import gather_tensor
    if mesh is None or tuple(t.shape) == tuple(shape):
        return t
    return gather_tensor(t, pp.held, mesh, pp.groups)


def _whole_moment(m, p, pp, mesh, shape: tuple):
    from repro_torch.weights import gather_blocks, opt_dims
    if mesh is not None and tuple(m.shape) != tuple(p.shape):
        m = gather_blocks(m, opt_dims(pp.held, pp.opt_held, mesh), mesh)
    return _whole(m, pp, mesh, shape)


def _moments(trainer, specs: list, mesh):
    """(leaf spec, the whole first moment) of each leaf."""
    st = _canonical(trainer)
    for s in specs:
        yield s, _whole_moment(st.m[s.name], st.params[s.name],
                               trainer.plan.params[s.name], mesh, s.shape)


def moments_on_host(trainer, specs: list, mesh) -> dict:
    """{leaf: the whole first moment}, copied to the host."""
    return {s.name: m.detach().to("cpu", copy=True)
            for s, m in _moments(trainer, specs, mesh)}


def grad_norms(trainer, specs: list, b1: float, mesh,
               before: Optional[dict] = None) -> dict:
    """{leaf: ||g||} of the gradient the optimizer got in the step just
    run, from its first moment: m = b1 m_before + (1 - b1) g, with
    ``before`` (the moments before the step, ``moments_on_host``) zero
    at the first step."""
    return {s.name: norm(m, None if before is None else before[s.name],
                         b1) / (1.0 - b1)
            for s, m in _moments(trainer, specs, mesh)}


def change_norms(trainer, specs: list, seed: int, dtype, device,
                 mesh) -> dict:
    """{leaf: ||p - p0||}, p0 drawn again from the seed leaf by leaf."""
    st = _canonical(trainer)
    out = {}
    for s in specs:
        p = _whole(st.params[s.name], trainer.plan.params[s.name], mesh,
                   s.shape)
        out[s.name] = norm(p, weights.draw_leaf(s, seed, dtype, device))
    return out


class StepLog:
    """The trainer's per-step metrics, as ``Trainer.run`` reports them."""

    def __init__(self):
        self.losses: list = []
        self.dropped: list = []

    def add(self, step: int, metrics: dict) -> None:
        self.losses.append(float(metrics.get("loss", math.nan)))
        self.dropped.append(float(metrics.get("embed_dropped", 0.0)))


def _tensors(tree):
    import torch
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def fault_state_unchanged(trainer) -> None:
    """The step returns its state unchanged (it computes, then every
    parameter and moment is put back)."""
    import torch
    step = trainer.train_step

    def frozen(state, batch):
        leaves = [t for part in (state.params, state.m, state.v)
                  for t in _tensors(part)]
        keep = [t.detach().clone() for t in leaves]
        state, metrics = step(state, batch)
        with torch.no_grad():
            for t, k in zip(leaves, keep):
                t.copy_(k)
        return state, metrics
    trainer.train_step = frozen


def fault_half_batch(trainer) -> None:
    """Half of each batch left out: the step sees the first half of the
    rows, and its loss is the mean over them."""
    step = trainer.train_step

    def half(state, batch):
        return step(state, {k: v[:len(v) // 2] for k, v in batch.items()})
    trainer.train_step = half


def fault_no_exchange(trainer) -> None:
    """The exchange between chips left out: the bucketed all-reduce of the
    dense gradients does nothing and the sparse push's all-gather hands
    back this rank's own buffers."""
    from repro_torch.core import collectives as coll
    coll.all_reduce_async = lambda buf, axes, mesh: None
    coll.all_gather = lambda x, axes, mesh, dim=0: x


def plant_fault(trainer, plant: Callable) -> None:
    """``plant`` the fault, and again on each step a replan builds, so every
    step of the run has it."""
    plant(trainer)
    replan = trainer.maybe_replan

    def replan_and_plant():
        built = trainer.train_step
        diff = replan()
        if trainer.train_step is not built:
            plant(trainer)
        return diff
    trainer.maybe_replan = replan_and_plant


FAULTS = {"state_unchanged": fault_state_unchanged,
          "half_batch": fault_half_batch,
          "no_exchange": fault_no_exchange}


def _sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _stopper(mesh) -> Callable:
    """done (this rank's clock says the window is over) -> stop? The same
    answer on every rank: rank 0's, sent over a gloo group."""
    if mesh is None:
        return lambda done: done
    import torch
    import torch.distributed as dist
    group = dist.new_group(backend="gloo")

    def stop(done: bool) -> bool:
        flag = torch.tensor([int(done)], dtype=torch.int32)
        dist.broadcast(flag, src=0, group=group)
        return bool(flag.item())
    return stop


def setup(cell: Cell, seed: int, *, device, mesh=None,
          fault: Optional[str] = None) -> tuple:
    """Build the trainer on the benchmark's weights and train the compared
    steps through ``Trainer.run``. -> (trainer, step: one more step,
    StepLog, the compared steps' readings)."""
    import torch
    from repro_torch.core.transform import load_params_
    from repro_torch.runtime.trainer import Trainer
    cfg = cell.config
    model_cfg, shape, run_cfg, tcfg = port_configs(cell, seed)
    stream = Stream(cell.mix, cfg["vocab_size"], seed)
    dtype = getattr(torch, cfg["dtype"])
    trainer = Trainer(model_cfg, shape, run_cfg, tcfg, stream, mesh=mesh,
                      device=device)
    specs = reference.leaf_specs(cfg)
    load_params_(trainer.model, weights.draw_all(specs, seed, dtype, device),
                 trainer.plan if mesh is not None else None)
    if fault is not None:
        plant_fault(trainer, FAULTS[fault])
    log = StepLog()

    def step():
        trainer.tcfg.total_steps += 1
        trainer.run(on_metrics=log.add)

    n_cmp, at = compared_steps(cfg)
    b1 = cfg["optimizer"]["b1"]
    grads, plans = {}, []
    for i in range(1, n_cmp + 1):
        before = moments_on_host(trainer, specs, mesh) \
            if i in at and i > 1 else None
        tab = trainer.plan.tables().get("embed", {})
        plans.append([tab.get("method"), tab.get("capacity")])
        step()
        if i in at:
            grads[i] = grad_norms(trainer, specs, b1, mesh, before)
        del before
    readings = {"losses": log.losses[:n_cmp], "grad_norms": grads.pop(1),
                "grad_norms_at": {str(i): g for i, g in grads.items()},
                "change_norms": change_norms(trainer, specs, seed, dtype,
                                             device, mesh),
                "dropped": sum(log.dropped[:n_cmp]), "plans": plans}
    return trainer, step, log, readings


def compare(cell: Cell, got: dict, want: dict) -> dict:
    """The compared numbers of the program's readings against the
    reference's, as the cell's configuration asks (``check.gaps``)."""
    return check.gaps(got, want, cell.config["harness"].get("loss_steps"))


def compared_steps(cfg: dict) -> tuple:
    """(the number of compared steps, the steps, counted from 1, whose
    gradient is compared) of a configuration's ``harness``: the first
    step's always; a later one is, say, the first step after the
    trainer's first replan, on the plan the window runs."""
    h = cfg["harness"]
    at = sorted({1, *h.get("grad_steps", [1])})
    if at[-1] > h["compared_steps"]:
        raise ValueError(f"grad_steps {at} past the {h['compared_steps']} "
                         f"compared steps")
    return int(h["compared_steps"]), at


def release() -> None:
    """Collect what the caller let go (a trainer holds cycles) and hand
    the card's cached blocks back."""
    import torch
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def drive(cell: Cell, seed: int, seconds: float, trace: bool, *, device,
          mesh=None, rank: int = 0, world: int = 1,
          fault: Optional[str] = None) -> dict:
    """One rank's run: set-up, the compared steps' readings, the window
    and, with ``trace``, the traced stretch and the per-layer readers.
    -> the rank's record (plain numbers)."""
    import torch
    from repro_torch.kernels import ops
    on_card = torch.device(device).type == "cuda"
    trainer, step, log, readings = setup(cell, seed, device=device,
                                         mesh=mesh, fault=fault)
    stream = trainer.dataset
    while trainer.step < cell.config["harness"]["warmup_steps"]:
        step()
    stop = _stopper(mesh)
    first = trainer.step
    _sync(device)
    t_start = time.monotonic()
    ends = []
    while True:
        step()
        ends.append(time.monotonic())
        if stop(ends[-1] - t_start >= seconds):
            break
    _sync(device)
    t_end = time.monotonic()
    ends[-1] = t_end
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    window = {"t_start": t_start, "seconds": t_end - t_start,
              "steps": len(ends),
              "step_s": np.diff([t_start] + ends).tolist(),
              "losses": log.losses[first:first + len(ends)]}
    rec = {"readings": readings, "window": window, "peak": int(peak),
           "plan": trainer.plan.tables(), "launches": ops.launch_counts()}
    if trace:
        rec.update(_traced(trainer, step, cell, stream, rank, world, mesh,
                           device, window))
    del trainer, step
    release()
    rec["loaded"] = forbidden_modules()
    return rec


def _traced(trainer, step: Callable, cell: Cell, stream: Stream, rank: int,
            world: int, mesh, device, window: dict) -> dict:
    """The traced stretch (``harness.trace_steps`` steps under
    torch.profiler) and, on a mesh, a stretch of ``harness.record_steps``
    steps under the port's collective record; the per-layer readers run
    here, on this rank's trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    hcfg = cell.config["harness"]
    n = hcfg["trace_steps"]
    steps = []
    _sync(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(TRACE_RANGE):
            for _ in range(n):
                tab = trainer.plan.tables().get("embed", {})
                steps.append({"step": trainer.step,
                              "capacity": tab.get("capacity")})
                with record_function("bench.step"):
                    step()
            _sync(device)
    tr = tracing.from_profiler(prof, TRACE_RANGE, n)
    tokens = cell.mix.batch_per_rank * cell.mix.seq_len
    for s in steps:
        ids = stream.rank_rows(stream.batch(s["step"]), rank)["tokens"]
        s["unique"] = int(np.unique(ids).size)
        s["capacity"] = min(int(s["capacity"] or tokens), tokens)
    wire = None
    if mesh is not None:
        from repro_torch.core import collectives as coll
        k = hcfg["record_steps"]
        with coll.record() as rec:
            for _ in range(k):
                step()
        wire = sum(coll.wire_bytes(ev) for ev in rec.events) / k
    table = trainer.model.get_parameter("embed")
    wire_dtype = getattr(torch, cell.config["run"].get("wire_dtype",
                                                       "bfloat16"))
    run = RankRun(cell=cell, rank=rank, world=world, trace=tr, steps=steps,
                  table_rows=int(table.shape[0]), width=int(table.shape[1]),
                  table_itemsize=table.element_size(),
                  wire_itemsize=torch.empty((), dtype=wire_dtype)
                  .element_size(),
                  window=window, wire_bytes_per_step=wire)
    layer = {}
    for m in cell.per_layer:
        v = reader(m["name"], cell.root)(run)
        if v is not None:
            layer[m["name"]] = float(v)
    return {"layer": layer, "busy_s": tr.busy_s(), "window_s": tr.window_s,
            "breakdown": {"device_ops": tr.top_ops(),
                          "idle_gaps": tr.idle_gaps()}}


def rank_main(rank: int, world: int, workload: str, root: str, seed: int,
              seconds: float, trace: bool, fault: Optional[str]) -> dict:
    """A rank of a cell on several chips (``launch/mesh.py::spawn``)."""
    import torch
    from repro_torch.launch.mesh import make_mesh
    cell = load_cell(workload, Path(root))
    dev = torch.device("cuda", torch.cuda.current_device()) \
        if torch.cuda.is_available() and torch.distributed.get_backend() \
        == "nccl" else torch.device("cpu")
    mesh = make_mesh((world, 1), ("data", "model"), device=dev)
    return drive(cell, seed, seconds, trace, device=dev, mesh=mesh,
                 rank=rank, world=world, fault=fault)


# ---------------------------------------------------------------------------
# the reference side
# ---------------------------------------------------------------------------

def reference_readings(cell: Cell, seed: int, device, *,
                       precision: str = "f32",
                       fault: Optional[str] = None) -> dict:
    """The readings of the plain reference on the cell's compared steps
    (the global batch of each), from the same weights and batches as the
    program. ``precision`` "fp8" is the control; ``fault`` plants
    ``half_batch`` (the first half of the rows) or ``no_exchange`` (rank
    0's rows alone, its gradient 1 / ranks of its mean's, as a step whose
    all-reduce is left out scales it) in the reference in the program's
    place."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = cell.config
    dtype = getattr(torch, cfg["dtype"])
    specs = reference.leaf_specs(cfg)
    stream = Stream(cell.mix, cfg["vocab_size"], seed)
    n_cmp, at = compared_steps(cfg)
    batches = [stream.batch(i) for i in range(n_cmp)]
    scale = 1.0
    if fault == "half_batch":
        batches = [{k: v[:len(v) // 2] for k, v in b.items()}
                   for b in batches]
    elif fault == "no_exchange":
        batches = [stream.rank_rows(b, 0) for b in batches]
        scale = 1.0 / cell.mix.ranks
    elif fault is not None:
        raise ValueError(f"no reference plant for fault {fault!r}")
    params = {s.name: weights.draw_leaf(s, seed, dtype, device).float()
              for s in specs}
    out = reference.train(
        cfg, params,
        [{k: torch.as_tensor(v).to(device) for k, v in b.items()}
         for b in batches],
        reference.Adam.of(cfg["optimizer"]), precision=precision,
        grad_scale=scale, grad_steps=at)
    out["change_norms"] = {
        s.name: norm(params[s.name],
                     weights.draw_leaf(s, seed, dtype, device))
        for s in specs}
    out["dropped"] = 0.0
    del params
    release()
    return out


# ---------------------------------------------------------------------------
# a run of a cell
# ---------------------------------------------------------------------------

def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, *, t0: float,
             device: str = "cuda", fault: Optional[str] = None) -> dict:
    """-> the result line's object (``compared`` last; ``loaded``, the
    forbidden modules each rank held after its window, is the caller's to
    take out)."""
    import torch
    if cell.chips == 1:
        records = [drive(cell, seed, seconds, trace, device=device,
                         fault=fault)]
    else:
        from repro_torch.launch.mesh import spawn
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
        records = spawn(rank_main, cell.chips, backend,
                        torch.device(device).type,
                        args=(cell.name, str(cell.root), seed, seconds,
                              trace, fault),
                        timeout=300)
    release()
    dev0 = torch.device("cuda", 0) if torch.device(device).type == "cuda" \
        else torch.device("cpu")
    ref = reference_readings(cell, seed, dev0)
    numbers = compare(cell, records[0]["readings"], ref)
    ok, shown = check.judge(numbers, cell.limits)
    failed = sum(1 for x in records[0]["window"]["losses"]
                 if not math.isfinite(x))
    run = CellRun(cell=cell, ranks=records,
                  setup_s=records[0]["window"]["t_start"] - t0)
    metrics = {}
    if not trace:
        for m in cell.end_to_end:
            v = reader(m["name"], cell.root)(run)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        for m in cell.per_layer:
            vals = [r["layer"][m["name"]] for r in records
                    if m["name"] in r["layer"]]
            if vals:
                metrics[m["name"]] = {"value": statistics.fmean(vals),
                                      "unit": m["unit"]}
    on_card = dev0.type == "cuda"
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": cell.chips,
           "memory_peak_bytes": max(r["peak"] for r in records)}
    out = {"correct": bool(ok and failed == 0),
           "attempted": records[0]["window"]["steps"], "failed": failed,
           "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = statistics.fmean(r["busy_s"] for r in records)
        dev["window_s"] = statistics.fmean(r["window_s"] for r in records)
        out["breakdown"] = records[0]["breakdown"]
    out["plan"] = records[0]["plan"]
    out["compared_plans"] = records[0]["readings"]["plans"]
    # forbidden modules the ranks loaded (the caller adds its own)
    out["loaded"] = sorted({m for r in records for m in r["loaded"]})
    out["compared"] = shown
    return out
