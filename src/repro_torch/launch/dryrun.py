"""The dry-run: one step of a cell on a record-only mesh, with its
collectives, FLOPs and peak memory read off that step, and the roofline
terms they give (the port of ``repro/launch/dryrun.py``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch parallax-lm \\
        --shape train_4k [--multi-pod | --both-meshes] [--comm-mode hybrid]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --sweep   # all cells

The reference compiles a step for 256 or 512 fake XLA devices and reads
its FLOPs and collective bytes from the HLO. The port has no compiled
text, so it runs the step itself, as rank 0 of a ``launch/mesh.py::
DryMesh`` (the 16x16 or 2x16x16 production mesh of
``make_production_mesh``) with every tensor on the meta device:

  * the model is built on meta, ``analyze`` and ``make_optimizer`` plan
    it, and the state is made from the meta parameters with no seeded
    draw (a draw needs a generator on a real device);
  * one train, prefill or decode step runs on ``_abstract_batch`` (or an
    abstract cache and tokens) under ``collectives.record()``: every
    collective reports the event a real mesh's would and communicates
    nothing; under a dispatch mode that counts the step's operations
    with ``FlopCounterMode``'s formulas (``torch.utils.flop_counter.
    flop_registry``), the kernels' own counts added from
    ``kernels/ops.py::meta_flops``; and under a tracker of the live meta
    storages the step allocates and frees, whose high-water mark is one
    rank's peak.

So the dry-run computes nothing on any device: that is its design, as
the reference's compile on fake devices is. It needs no card and runs on
the host whatever the caller's device.

The H100 record (utils/roofline.py) has a single-tier fabric
(``inter_bw`` None), so a 256-card mesh is priced as if NVLink reached
every card, unless ``RunConfig.hw_profile`` gives an inter-host tier. The
traffic term is utils/traffic.py's model (meta moves no byte).

``run_cell`` returns the reference's dict. Where a key of it names an
XLA artefact, the port gives its counterpart under a key of its own:
``record`` in place of ``hlo`` (``collective_bytes`` the sum of the
events' ``wire_bytes``, ``collective_by_kind`` ``Record.by_kind_axes()``,
``dot_flops`` the counted operations); ``flop_count`` in place of
``xla_cost_analysis``; ``memory_analysis.peak_bytes`` the tracker's peak
(the state is updated in place, so the outputs alias the arguments);
``compile_s`` the host seconds of the dry step. There is no
``f32_collective_scale``: the record sees the dtype each collective
really carries, where the reference halves the f32 bytes that the CPU's
HLO widens. A training cell's record is checked against the plan
(analysis/contract.py): its findings are in ``contract`` and make ``ok``
false.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
import weakref
from dataclasses import dataclass
from typing import Optional, Union

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.analysis.contract import check_contract
from repro_torch.configs import (ALL_ARCHS, SHAPES, RunConfig, ShapeConfig,
                                 get_config, shapes_for)
from repro_torch.core import collectives as coll
from repro_torch.core.runtime import Runtime
from repro_torch.core.transform import (_abstract_batch, analyze,
                                        local_batch, make_decode_step,
                                        make_prefill_step, make_train_step,
                                        moment_shapes, place_params_)
from repro_torch.kernels import ops
from repro_torch.launch.mesh import DryMesh, make_production_mesh
from repro_torch.models.model import build_model
from repro_torch.optim.optimizer import fuse_state, make_optimizer
from repro_torch.runtime.server import hold_for_serving_
from repro_torch.utils.roofline import roofline_from_analysis
from repro_torch.utils.traffic import estimate_traffic
from repro_torch.utils.tree import named_parameters

OUT = "results/dryrun_torch"


# ---------------------------------------------------------------------------
# the peak tracker and the counting dispatch mode
# ---------------------------------------------------------------------------

class PeakTracker:
    """Live bytes of the storages ``note``d and their high-water mark.
    A storage counts from the first time it is noted until it is freed:
    the callback of a weak reference to its Python object, which PyTorch
    keeps as long as the storage lives (a tensor that autograd saves keeps
    it alive after every Python reference to the tensor is gone). A count
    of allocations and frees at the storage level, not a formula."""

    def __init__(self):
        # storage address -> (bytes, the weak reference whose callback
        # frees it), while the storage lives
        self._live: dict = {}
        self.live = 0
        self.peak = 0

    def note(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live:
            return
        n = st.nbytes()
        self._live[key] = (n, weakref.ref(st, lambda _, k=key: self._free(k)))
        self.live += n
        if self.live > self.peak:
            self.peak = self.live

    def note_all(self, tree) -> None:
        """Note every tensor of ``tree`` (dicts, sequences and dataclasses
        such as a TrainState)."""
        if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
            tree = [getattr(tree, f.name) for f in dataclasses.fields(tree)]
        if isinstance(tree, dict):
            tree = list(tree.values())
        if isinstance(tree, (list, tuple)):
            for x in tree:
                self.note_all(x)
        elif isinstance(tree, torch.Tensor):
            self.note(tree)

    def _free(self, key: int) -> None:
        self.live -= self._live.pop(key)[0]


# size and layout queries that a dispatch mode hands back untouched
_QUERIES = {torch.ops.aten.is_contiguous.default,
            torch.ops.aten.is_contiguous.memory_format,
            torch.ops.aten.is_strides_like_format.default,
            torch.ops.aten.is_non_overlapping_and_dense.default,
            torch.ops.aten.size.default, torch.ops.aten.sym_size.default,
            torch.ops.aten.stride.default, torch.ops.aten.sym_stride.default,
            torch.ops.aten.storage_offset.default,
            torch.ops.aten.sym_storage_offset.default,
            torch.ops.aten.numel.default, torch.ops.aten.sym_numel.default,
            torch.ops.aten.dim.default, torch.ops.prim.layout.default}

_COMPOSITE = torch._C.DispatchKey.CompositeImplicitAutograd


def _sig(x):
    """A hashable signature of an operator argument: a tensor's shape,
    strides, dtype and device (a meta tensor holds nothing else)."""
    if isinstance(x, torch.Tensor):
        return (x.shape, x.stride(), x.dtype, x.device.type)
    if isinstance(x, (list, tuple)):
        return tuple([_sig(y) for y in x])
    return x


class DryCount(TorchDispatchMode):
    """Counts a dry step's operations, as ``FlopCounterMode`` does (the
    same ``flop_registry`` formulas, the same decomposition of operators
    it has no formula for), and feeds every meta result to ``tracker``.

    A meta operator only computes its result's shape, strides and dtype,
    often through Python reference code; an operator that neither
    mutates nor aliases its inputs gives the same result for the same
    signature of its arguments, so that result's layout and count are
    kept and the next call with that signature makes an empty tensor of
    the same layout in place of running the meta function again. The
    counts and the tensors are those the uncached calls give
    (``tests/test_torch_dryrun.py``). ``by_op`` (a dict), when given,
    gathers the count by operator and argument shapes:
    ``{"aten.mm (a, b)x(b, c)": [flops, calls]}`` (the dot census of
    ``repro_torch.tools.profile_dots``)."""

    def __init__(self, tracker: Optional[PeakTracker] = None,
                 by_op: Optional[dict] = None):
        super().__init__()
        self.tracker = tracker
        self.by_op = by_op
        self.flops = 0
        self._memo: dict = {}
        self._pure: dict = {}
        self._composite: dict = {}

    def _is_pure(self, func) -> bool:
        pure = self._pure.get(func)
        if pure is None:
            sch = func._schema
            pure = (not sch.is_mutable and len(sch.returns) > 0
                    and all(r.alias_info is None and str(r.type) == "Tensor"
                            for r in sch.returns))
            self._pure[func] = pure
        return pure

    def _note(self, func, args, flops: int) -> None:
        if self.by_op is None or not flops:
            return
        shapes = "x".join(str(tuple(a.shape)) for a in args
                          if isinstance(a, torch.Tensor))
        row = self.by_op.setdefault(f"{func._overloadpacket} {shapes}",
                                    [0, 0])
        row[0] += int(flops)
        row[1] += 1

    def _track(self, outs) -> None:
        if self.tracker is not None:
            for o in outs:
                self.tracker.note(o)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _QUERIES:
            return func(*args, **kwargs)
        key = None
        if self._is_pure(func):
            try:
                key = (func, _sig(args), _sig(tuple(sorted(kwargs.items()))))
                hit = self._memo.get(key)
            except TypeError:
                key, hit = None, None
            if hit is not None:
                layouts, flops = hit
                self.flops += flops
                self._note(func, args, flops)
                outs = [torch.empty_strided(shape, stride, dtype=dtype,
                                            device="meta")
                        for shape, stride, dtype in layouts]
                self._track(outs)
                return outs[0] if len(outs) == 1 else tuple(outs)
        packet = func._overloadpacket
        if packet not in flop_registry and \
                func is not torch.ops.prim.device.default:
            comp = self._composite.get(func)
            if comp is None:
                comp = torch._C._dispatch_has_kernel_for_dispatch_key(
                    func.name(), _COMPOSITE)
                self._composite[func] = comp
            if comp:
                with self:
                    r = func.decompose(*args, **kwargs)
                    if r is not NotImplemented:
                        return r
        out = func(*args, **kwargs)
        flops = (flop_registry[packet](*args, **kwargs, out_val=out)
                 if packet in flop_registry else 0)
        self.flops += flops
        self._note(func, args, flops)
        if isinstance(out, torch.Tensor):
            outs = [out]
        elif isinstance(out, (tuple, list)):
            outs = [o for o in out if isinstance(o, torch.Tensor)]
        else:
            outs = []
        metas = [o for o in outs if o.device.type == "meta"]
        self._track(metas)
        n_out = (1 if isinstance(out, torch.Tensor)
                 else len(out) if isinstance(out, (tuple, list)) else 0)
        if key is not None and metas and len(metas) == n_out:
            self._memo[key] = ([(o.shape, o.stride(), o.dtype)
                                for o in metas], flops)
        return out


# ---------------------------------------------------------------------------
# one dry step
# ---------------------------------------------------------------------------

@dataclass
class DryStep:
    """What one dry step gave: its collectives, its counted operations
    (ATen's and the kernels'), the bytes live when it started (state and
    batch), its peak live bytes, and its host seconds."""
    record: coll.Record
    aten_flops: int
    kernel_flops: int
    kernel_calls: dict
    argument_bytes: int
    peak_bytes: int
    seconds: float

    @property
    def flops(self) -> int:
        return self.aten_flops + self.kernel_flops


def _resolve_shape(shape: Union[str, ShapeConfig]) -> ShapeConfig:
    return SHAPES[shape] if isinstance(shape, str) else shape


def _resolve_mesh(mesh, multi_pod: bool):
    """"production" -> the production mesh; None -> one device; a
    MeshShape -> that shape. -> a DryMesh or None."""
    if isinstance(mesh, str):
        if mesh != "production":
            raise ValueError(f"mesh {mesh!r}: 'production', None or a "
                             "MeshShape")
        mesh = make_production_mesh(multi_pod=multi_pod)
    if mesh is None:
        return None
    return DryMesh(tuple(mesh.shape.values()), mesh.axis_names,
                   hosts=mesh.hosts)


def mesh_name(mesh) -> str:
    return "1" if mesh is None else "x".join(
        str(n) for n in mesh.shape.values())


def build_cell(cfg, shape: ShapeConfig, run_cfg: RunConfig, mesh):
    """Model, runtime, plan and optimizer of a cell on meta (``mesh``: a
    DryMesh or None for one device)."""
    rt = Runtime(cfg, run_cfg, shape, mesh=mesh, device="meta")
    model = build_model(cfg, rt)
    plan = analyze(model, rt)
    rt.plan = plan
    optimizer = make_optimizer(rt)
    if mesh is not None:
        if shape.kind != "train":
            # a server's weights are whole over the batch axes
            hold_for_serving_(model, plan)
        place_params_(model, plan, mesh)
    return model, rt, plan, optimizer


def _step_and_inputs(model, rt, plan, optimizer) -> tuple:
    """(fn, inputs): the cell's step and its abstract inputs."""
    kind = rt.shape_cfg.kind
    if kind == "train":
        own = named_parameters(model)
        # the state from the meta parameters, no seeded draw
        state = optimizer.init(own, shapes=moment_shapes(own, plan))
        step = make_train_step(model, optimizer, rt, plan)
        if plan.fused_apply:
            state = fuse_state(state, plan.bucket_plan)
        return step, (state, local_batch(rt, _abstract_batch(model, rt)))
    if kind == "prefill":
        return (make_prefill_step(model, rt, plan),
                (local_batch(rt, _abstract_batch(model, rt)),))
    b, s = rt.shape_cfg.global_batch, rt.shape_cfg.seq_len
    b_loc = rt.cache_shard(b, s)[0]
    cache = model.init_cache(b, s)          # this rank's block of it
    tokens = torch.empty((b_loc, 1), dtype=torch.int32, device="meta")
    lens = torch.empty((b_loc,), dtype=torch.int32, device="meta")
    return make_decode_step(model, rt, plan), (cache, tokens, lens)


def dry_step(model, rt, plan, optimizer,
             by_op: Optional[dict] = None) -> DryStep:
    """Run the cell's one step on meta under the record, the counting
    mode (``by_op``: its count by operator, ``DryCount``) and the peak
    tracker."""
    fn, inputs = _step_and_inputs(model, rt, plan, optimizer)
    tracker = PeakTracker()
    tracker.note_all([inputs, named_parameters(model)])
    base = tracker.live
    t0 = time.perf_counter()
    with coll.record() as rec, ops.meta_flops() as kernels, \
            DryCount(tracker, by_op) as count:
        out = fn(*inputs)
    seconds = time.perf_counter() - t0
    del out
    return DryStep(record=rec, aten_flops=int(count.flops),
                   kernel_flops=int(kernels["flops"]),
                   kernel_calls=dict(kernels["calls"]),
                   argument_bytes=base, peak_bytes=tracker.peak,
                   seconds=seconds)


def lower_cell(arch: str, shape_name, *, multi_pod: bool,
               run_cfg: RunConfig, mesh="production"):
    """Build one cell on meta and run its dry step. ``shape_name``: a
    ``SHAPES`` name or a ShapeConfig; ``mesh``: "production" (the 16x16
    or 2x16x16 mesh), None (one device) or a MeshShape. -> (DryStep, rt,
    plan, model)."""
    cfg = get_config(arch)
    shape = _resolve_shape(shape_name)
    dmesh = _resolve_mesh(mesh, multi_pod)
    model, rt, plan, optimizer = build_cell(cfg, shape, run_cfg, dmesh)
    return dry_step(model, rt, plan, optimizer), rt, plan, model


def model_flops(cfg, shape: ShapeConfig) -> float:
    """6·N·T for a training step, 2·N·T for prefill and decode (N the
    active parameters; an encoder's layers see seq / enc_ratio frames)."""
    n_active = cfg.active_param_count()
    if cfg.is_encdec and cfg.enc_layers:
        from repro_torch.models.encdec import enc_ratio
        n_layers = cfg.n_layers + cfg.enc_layers
        enc_share = cfg.enc_layers / n_layers
        n_active = n_active * (1 - enc_share + enc_share / enc_ratio(cfg))
    if shape.kind == "train":
        return 6.0 * n_active * shape.tokens
    tokens = shape.tokens if shape.kind == "prefill" else shape.global_batch
    return 2.0 * n_active * tokens


def plan_summary(plan) -> dict:
    """The plan's fields a dry-run cell reports (the reference's)."""
    return {"alpha": plan.alpha, "capacity": plan.capacity,
            "embed_method": plan.embed_method,
            "zero_stage": plan.zero_stage, "methods": plan.methods(),
            "tables": plan.tables(), "census": plan.census()}


def run_cell(arch: str, shape_name, *, multi_pod: bool = False,
             run_cfg: Optional[RunConfig] = None, verbose: bool = True,
             mesh="production", account=None) -> dict:
    """One cell's dry-run -> the reference's dict (module docstring for
    the keys that differ). A cell that cannot be built or stepped gives
    ``ok: false`` and the error. ``account(plan, rt, model, record)``,
    when given, reads the step's record further; its result is the
    dict's ``account``."""
    run_cfg = run_cfg or RunConfig()
    shape = _resolve_shape(shape_name)
    dmesh = _resolve_mesh(mesh, multi_pod)
    name = mesh_name(dmesh)
    chips = 1 if dmesh is None else dmesh.axes_size(dmesh.axis_names)
    try:
        dry, rt, plan, model = lower_cell(arch, shape, multi_pod=multi_pod,
                                          run_cfg=run_cfg, mesh=dmesh)
    except Exception as e:
        return {"arch": arch, "shape": shape.name, "mesh": name,
                "ok": False, "error": f"{type(e).__name__}: {e}",
                "traceback": traceback.format_exc()[-2000:]}

    cfg = get_config(arch)
    rec = dry.record
    wire = sum(coll.wire_bytes(ev) for ev in rec.events)
    by_kind = rec.by_kind_axes()
    traffic = estimate_traffic(cfg, shape, chips=chips,
                               model_shards=rt.model_shards,
                               remat=run_cfg.remat,
                               zero_stage=plan.zero_stage)
    terms = roofline_from_analysis(
        arch=arch, shape=shape.name, mesh=name, chips=chips,
        cost={"flops": dry.flops, "bytes accessed": traffic.total},
        collective_bytes=wire, model_flops_global=model_flops(cfg, shape),
        peak_memory=dry.peak_bytes, collective_breakdown=by_kind)
    findings = []
    outside = {}
    if shape.kind == "train" and dmesh is not None:
        found = check_contract(plan, rec)
        findings = [f.to_dict() for f in found]
        outside = dict(found.outside)
    out = {
        "arch": arch, "shape": shape.name, "mesh": name,
        "ok": not findings, "chips": chips, "compile_s": dry.seconds,
        "memory_analysis": {
            "argument_bytes": dry.argument_bytes,
            "output_bytes": dry.argument_bytes,
            "temp_bytes": dry.peak_bytes - dry.argument_bytes,
            "alias_bytes": dry.argument_bytes,
            "peak_bytes": dry.peak_bytes,
        },
        "flop_count": {"flops": dry.flops, "aten_flops": dry.aten_flops,
                       "kernel_flops": dry.kernel_flops,
                       "kernel_calls": dry.kernel_calls},
        "traffic": traffic.to_dict(),
        "record": {"collective_bytes": wire,
                   "collective_raw_bytes": sum(ev.bytes
                                               for ev in rec.events),
                   "collective_by_kind": by_kind,
                   "collective_count": len(rec.events),
                   "dot_flops": dry.flops},
        "plan": plan_summary(plan),
        "roofline": terms.to_dict(),
        "contract": {"findings": findings, "outside": outside},
        "run_cfg": {"comm_mode": run_cfg.comm_mode,
                    "local_agg": run_cfg.local_agg,
                    "opau": run_cfg.opau, "opsw": run_cfg.opsw,
                    "capacity_mode": run_cfg.capacity_mode,
                    "remat": run_cfg.remat,
                    "explicit_sp": run_cfg.explicit_sp,
                    "dense_strategy": run_cfg.dense_strategy},
    }
    if account is not None:
        out["account"] = account(plan, rt, model, rec)
    if verbose:
        r = terms
        print(f"[{arch} × {shape.name} × {name}] dry step "
              f"{dry.seconds:.1f}s  peak/card {dry.peak_bytes / 1e9:.2f} GB"
              f"  compute {r.compute_s * 1e3:.2f} ms  memory "
              f"{r.memory_s * 1e3:.2f} ms  collective "
              f"{r.collective_s * 1e3:.2f} ms  dominant={r.dominant}  "
              f"roofline={r.roofline_fraction:.3f}"
              + (f"  contract: {findings}" if findings else ""),
              flush=True)
    return out


def _cell_worker(kw: dict) -> dict:
    torch.set_num_threads(1)        # the workers share the host's cores
    return run_cell(**kw)


def run_cells(cells: list, workers: int = 1) -> list:
    """``run_cell(**kw)`` for each kw of ``cells``, in order, on up to
    ``workers`` processes of the host (each a fresh interpreter, stopped
    before this returns). A dry step is single-threaded Python work, so
    independent cells run side by side."""
    if workers <= 1 or len(cells) <= 1:
        return [run_cell(**kw) for kw in cells]
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor
    with ProcessPoolExecutor(min(workers, len(cells)),
                             mp_context=mp.get_context("spawn")) as pool:
        return list(pool.map(_cell_worker, cells))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.dryrun")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--comm-mode", default="hybrid")
    ap.add_argument("--capacity-mode", default="capped")
    ap.add_argument("--no-local-agg", action="store_true")
    ap.add_argument("--no-opau", action="store_true")
    ap.add_argument("--no-opsw", action="store_true")
    ap.add_argument("--remat", default="block")
    ap.add_argument("--explicit-sp", action="store_true")
    ap.add_argument("--dense-strategy", default="tp")
    ap.add_argument("--tag", default="")
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    if not args.sweep and not (args.arch and args.shape):
        ap.error("give --arch and --shape, or --sweep")

    run_cfg = RunConfig(
        comm_mode=args.comm_mode, capacity_mode=args.capacity_mode,
        local_agg=not args.no_local_agg, opau=not args.no_opau,
        opsw=not args.no_opsw, remat=args.remat,
        explicit_sp=args.explicit_sp, dense_strategy=args.dense_strategy)
    os.makedirs(args.out, exist_ok=True)

    cells = ([(a, s) for a in ALL_ARCHS for s in shapes_for(a)]
             if args.sweep else [(args.arch, args.shape)])
    meshes = [False, True] if (args.both_meshes or args.sweep) else \
        [args.multi_pod]
    n_fail = 0
    for arch, shape in cells:
        for mp in meshes:
            res = run_cell(arch, shape, multi_pod=mp, run_cfg=run_cfg)
            tag = f"__{args.tag}" if args.tag else ""
            name = (f"{arch}__{shape}__{'2x16x16' if mp else '16x16'}"
                    f"{tag}.json")
            with open(os.path.join(args.out, name), "w") as f:
                json.dump(res, f, indent=1)
            if not res["ok"]:
                n_fail += 1
                why = res.get("error") or res["contract"]["findings"]
                print(f"FAIL [{arch} × {shape} × "
                      f"{'2x16x16' if mp else '16x16'}]: {why}")
    print(f"dry-run complete: {len(cells) * len(meshes) - n_fail} ok, "
          f"{n_fail} failed")
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
