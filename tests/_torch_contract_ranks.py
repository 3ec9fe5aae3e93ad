"""The ranks of tests/test_torch_contract_mesh.py and test_torch_contract.py:
spawned gloo processes (``launch/mesh.py::spawn``) that record training
steps of reduced models and check them against their plans' exchange
contract (``repro_torch/analysis/contract.py``). They import the port
alone, not the JAX package.

The reference's sweeps lower each step on 8 fake devices; here the ranks
are processes on the CPU, so the sweeps run on (4, 1) in place of (8, 1),
``ps_gather`` on (2, 2) in place of (2, 4) and the two-level pod on
(2, 2, 1) in place of (2, 4, 1)."""
import dataclasses
import json
import os
import tempfile

import torch

import repro_torch.configs as tc
from repro_torch.analysis.contract import ContractViolation, check_contract
from repro_torch.core import collectives as coll
from repro_torch.core.transform import estimate_census, get_runner
from repro_torch.data import SyntheticLM
from repro_torch.launch.mesh import make_mesh

SEQ, BATCH = 32, 8
# the reference sweep's RunConfig
BASE = dict(attention_impl="naive", remat="none", param_dtype="float32",
            compute_dtype="float32", wire_dtype="float32")
ENCDEC = "seamless-m4t-medium"
ZOO = ("phi3-medium-14b", "hymba-1.5b", "rwkv6-7b", "command-r-35b",
       "stablelm-12b")
# the reference's fitted profiles: a latency-free fast link (the argmin
# takes ps_gather at a tiny alpha) and a slow inter-host tier (the bucket
# takes the two-level triple)
HW_FAST = {"link_latency": 1e-9, "link_bw": 1e9}
HW_POD = {"inter_bw": 12.5e9, "inter_latency": 10e-6}
# name -> (arch, mesh shape, mesh axes, RunConfig knobs); hw_profile names
# one of the profiles above
SWEEPS = {
    "encdec": {
        "default": (ENCDEC, (4, 1), None, {}),
        "no_overlap": (ENCDEC, (4, 1), None, {"overlap": False}),
        "no_fused": (ENCDEC, (4, 1), None,
                     {"fused_apply": False, "bucket_bytes": 256 * 1024}),
        "gatherv": (ENCDEC, (4, 1), None,
                    {"comm_mode": "mpi", "bucket_bytes": 256 * 1024}),
    },
    "zoo": {**{a: (a, (4, 1), None, {}) for a in ZOO},
            "unbucketed": ("phi3-medium-14b", (4, 1), None,
                           {"bucket_bytes": 0})},
    "sparse_pod": {
        "ps_gather": ("phi3-medium-14b", (2, 2), None,
                      {"comm_mode": "ps", "hw_profile": "fast",
                       "table_alpha": (("embed", 0.01),)}),
        "two_level": (ENCDEC, (2, 2, 1), ("pod", "data", "model"),
                      {"hw_profile": "pod", "bucket_bytes": 1024 * 1024}),
    },
}
# the mutations' and the gate's buckets: several, as the reference's
MUTATION_KW = {"bucket_bytes": 256 * 1024}


def dataset(cfg) -> SyntheticLM:
    return SyntheticLM(cfg.vocab_size, SEQ, BATCH, is_encdec=cfg.is_encdec,
                       frames_dim=cfg.d_model, frames_len=8)


def shape():
    return tc.ShapeConfig("tiny", SEQ, BATCH, "train")


def _profile(name: str) -> str:
    """A fitted-profile file of ``HW_FAST`` / ``HW_POD`` (each rank its
    own)."""
    prof = {"fast": HW_FAST, "pod": HW_POD}[name]
    fd, path = tempfile.mkstemp(suffix=".json")
    with os.fdopen(fd, "w") as f:
        json.dump(prof, f)
    return path


def _runner(arch, mesh, kw, seed=0):
    cfg = tc.reduced(tc.get_config(arch))
    kw = dict(kw)
    path = None
    if "hw_profile" in kw:
        path = kw["hw_profile"] = _profile(kw["hw_profile"])
    try:
        r = get_runner(cfg, shape(), tc.RunConfig(**BASE, **kw), mesh=mesh,
                       seed=seed)
    finally:
        if path is not None:
            os.unlink(path)
    return r, dataset(cfg)


def sweep_rank(rank, world, group):
    """Each scenario of ``SWEEPS[group]`` whose mesh holds ``world``
    ranks: the plan's buckets and table methods and the findings of one
    recorded step (``Runner.check_contract``)."""
    out, meshes = {}, {}
    for name, (arch, shp, axes, kw) in SWEEPS[group].items():
        axes = axes or ("data", "model")
        if (shp, axes) not in meshes:
            meshes[shp, axes] = make_mesh(shp, axes, device="cpu")
        r, ds = _runner(arch, meshes[shp, axes], kw)
        bp = r.plan.bucket_plan
        findings = r.check_contract(ds.batch(0))
        out[name] = {"buckets": len(bp.buckets) if bp else 0,
                     "schedules": [b.schedule for b in bp.buckets]
                     if bp else [],
                     "methods": dict(r.plan.table_methods),
                     "findings": [str(f) for f in findings],
                     "outside": findings.outside}
    return out


def mutation_rank(rank, world):
    """The reference's seeded mutations on (4, 1), reduced seamless with
    buckets of 256 KB: each clean step's findings; the overlap=False
    step's record against the overlap=True plan; one extra 9,000-element
    all-reduce over ``data`` issued inside a recorded step; the bucketed
    step against its plan with every bucket's wire dtype set to bf16,
    under ``strict_dtype``."""
    mesh = make_mesh((4, 1), ("data", "model"), device="cpu")
    ov, ds = _runner(ENCDEC, mesh, MUTATION_KW)
    base, _ = _runner(ENCDEC, mesh, dict(MUTATION_KW, overlap=False))
    batch = ds.batch(0)
    _, rec_ov = ov.train_step.exchange(ov.live_state, _local(ov, batch))
    _, rec_base = base.train_step.exchange(base.live_state,
                                           _local(base, batch))
    with coll.record() as rec_extra:
        ov.train_step.exchange(ov.live_state, _local(ov, batch))
        coll.all_reduce(torch.ones(9000), "data", mesh)
    bp = ov.plan.bucket_plan
    wrong_wire = dataclasses.replace(ov.plan, bucket_plan=dataclasses.replace(
        bp, buckets=[dataclasses.replace(b, key=(b.key[0], "bfloat16",
                                                 b.key[2]))
                     for b in bp.buckets]))
    kinds = lambda fs: sorted({f.kind for f in fs})
    return {
        "buckets": len(bp.buckets),
        "clean_ov": [str(f) for f in check_contract(ov.plan, rec_ov)],
        "clean_base": [str(f) for f in check_contract(base.plan, rec_base)],
        "overlap_mut": kinds(check_contract(ov.plan, rec_base)),
        "extra_ar_mut": kinds(check_contract(ov.plan, rec_extra)),
        "wire_mut": kinds(check_contract(wrong_wire, rec_ov,
                                         strict_dtype=True)),
        "clean_strict": [str(f) for f in check_contract(
            ov.plan, rec_ov, strict_dtype=True)],
    }


def _local(runner, batch):
    from repro_torch.core.transform import local_batch
    return local_batch(runner.rt, batch)


def gate_rank(rank, world):
    """The verify gate on (4, 1), reduced seamless with buckets of 256 KB:
    the build's first step, a forced replan and its first step, then the
    live step's findings. Then the gate against a plan whose overlap is
    flipped after the build: the first step raises ContractViolation
    before the optimizer applies (the state untouched), and passes once
    the plan is put back."""
    mesh = make_mesh((4, 1), ("data", "model"), device="cpu")
    kw = dict(MUTATION_KW, verify_contract=True)
    r, ds = _runner(ENCDEC, mesh, kw)
    loss0 = float(r.run(ds.batch(0))["loss"])
    diff = r.replan(estimate_census(r.model, r.rt), force=True)
    loss1 = float(r.run(ds.batch(1))["loss"])
    findings = r.check_contract(ds.batch(2))

    f, _ = _runner(ENCDEC, mesh, kw)
    bp = f.plan.bucket_plan
    before = {n: t.detach().clone() for n, t in f.state.params.items()}
    f.plan.bucket_plan = dataclasses.replace(bp, overlap=not bp.overlap)
    try:
        f.run(ds.batch(0))
        raised = []
    except ContractViolation as e:
        raised = sorted({x.kind for x in e.findings})
    untouched = all(torch.equal(before[n], t)
                    for n, t in f.state.params.items())
    f.plan.bucket_plan = bp
    after = float(f.run(ds.batch(0))["loss"])
    return {"rebuilt": diff["rebuilt"],
            "findings": [str(x) for x in findings],
            "losses_finite": all(x == x for x in (loss0, loss1, after)),
            "flipped": raised, "untouched": untouched,
            "steps": [int(f.live_state.step)]}


def bitwise_rank(rank, world):
    """The same seed's 2 steps on (2, 2) and on (4, 1) (reduced
    parallax-lm, buckets on (4, 1)), once with every step recorded (the
    gate on the first step, an outer record on each) and once without:
    the losses, gradient norms and every leaf of the state, as numpy."""
    out = {}
    for shp in ((2, 2), (4, 1)):
        mesh = make_mesh(shp, ("data", "model"), device="cpu")
        for recorded in (False, True):
            r, ds = _runner("parallax-lm", mesh,
                            {"verify_contract": recorded})
            losses, norms = [], []
            for i in range(2):
                if recorded:
                    with coll.record():
                        m = r.run(ds.batch(i))
                else:
                    m = r.run(ds.batch(i))
                losses.append(m["loss"].numpy().copy())
                norms.append(m["grad_norm"].numpy().copy())
            st = r.state
            leaves = {f"params.{n}": t.detach().numpy().copy()
                      for n, t in st.params.items()}
            for k, tree in (("m", st.m), ("v", st.v)):
                for n, t in (tree or {}).items():
                    leaves[f"{k}.{n}"] = t.detach().numpy().copy()
            out[f"{shp}-{recorded}"] = {"losses": losses, "norms": norms,
                                       "leaves": leaves}
    return out
