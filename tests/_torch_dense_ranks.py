"""The ranks of tests/test_torch_dense_mesh.py: spawned processes
(``launch/mesh.py::spawn``) that train the reduced dense transformer on a
gloo process mesh. They import the port alone, not the JAX package."""
import repro_torch.configs as tc
from repro_torch.core.transform import get_runner
from repro_torch.data import SyntheticLM
from repro_torch.launch.mesh import make_mesh
from repro_torch.weights import gather_tensor, load_reference_params

SEQ, BATCH, STEPS = 32, 4, 3
# the reference test's RunConfig (tests/test_transform_correctness.py)
KW = dict(attention_impl="naive", remat="none", param_dtype="float32",
          compute_dtype="float32", wire_dtype="float32")
FLAG_SETS = {
    "hybrid": {"comm_mode": "hybrid"},
    "ps": {"comm_mode": "ps"},
    "mpi": {"comm_mode": "mpi"},
    "no_la": {"comm_mode": "hybrid", "local_agg": False},
    "no_opau": {"comm_mode": "hybrid", "opau": False},
    "no_opsw": {"comm_mode": "hybrid", "opsw": False},
}
# the reference runs command-r (tied embeddings) under these two
TIED_SETS = ("hybrid", "mpi")
CLIP_KW = dict(KW, clip_norm=0.05, learning_rate=0.05)


def cfg(arch: str, **kw):
    return tc.reduced(tc.get_config(arch), **kw)


def shape(seq=SEQ):
    return tc.ShapeConfig("tiny", seq, BATCH, "train")


def batches(vocab: int, seq=SEQ, steps=STEPS):
    ds = SyntheticLM(vocab, seq, BATCH)
    return [ds.batch(i) for i in range(steps)]


def mesh_rank(rank, world, mesh_shape, cases):
    """``cases``: [(arch, [flag set names], named params)]; each flag
    set's 3 steps on this rank of ``mesh_shape``, in one process group."""
    m = make_mesh(mesh_shape, ("data", "model"), device="cpu")
    out = {}
    for arch, names, named in cases:
        c = cfg(arch)
        for name in names:
            r = get_runner(c, shape(), tc.RunConfig(**KW, **FLAG_SETS[name]),
                           mesh=m, params=load_reference_params(named, "cpu"))
            out[f"{arch}/{name}"] = {
                "loss": [float(r.run(b)["loss"])
                         for b in batches(c.vocab_size)],
                "method": r.plan.table_methods["embed"],
                "bucketed": r.plan.bucket_plan is not None}
    return out


def clip_rank(rank, world, named):
    """The reference's clip test: reduced phi3 with one layer, two clipped
    steps on a (4, 2) mesh; the global gradient norms."""
    m = make_mesh((4, 2), ("data", "model"), device="cpu")
    c = cfg("phi3-medium-14b", layers=1)
    r = get_runner(c, shape(16), tc.RunConfig(**CLIP_KW), mesh=m,
                   params=load_reference_params(named, "cpu"))
    return [float(r.run(b)["grad_norm"])
            for b in batches(c.vocab_size, 16, 2)]


# ---------------------------------------------------------------------------
# the phi3 replan cases of the reference's tests/test_replan.py
# ---------------------------------------------------------------------------

REPLAN_VOCAB = 256


def _replan_drive(mesh_shape, kw, replan_at, steps, drift=1.5, ds_kw=None):
    """A static run and an adaptive one (a replan from the observed
    census after step ``replan_at``) of reduced phi3 at vocab 256,
    ``ShapeConfig("tiny", 32, 8)``, on this rank of ``mesh_shape``."""
    from repro_torch.core.sparsity import SparsityProfile, observed_census
    from repro_torch.core.transform import estimate_census
    m = make_mesh(mesh_shape, ("data", "model"), device="cpu")
    c = cfg("phi3-medium-14b", vocab=REPLAN_VOCAB)
    ds = SyntheticLM(REPLAN_VOCAB, SEQ, 8, **(ds_kw or {}))
    out = {}
    for adaptive in (False, True):
        r = get_runner(c, tc.ShapeConfig("tiny", SEQ, 8, "train"),
                       tc.RunConfig(**kw), mesh=m, seed=0)
        first, cap0 = r.plan.embed_method, r.plan.table_capacity["embed"]
        prof, losses, dropped, diff = SparsityProfile(), [], [], None
        for i in range(steps):
            met = r.run(ds.batch(i))
            losses.append(float(met["loss"]))
            dropped.append(float(met["embed_dropped"]))
            prof.update({k: float(v) for k, v in met.items()
                         if getattr(v, "dim", lambda: 1)() == 0})
            if adaptive and i + 1 == replan_at:
                d = r.replan(observed_census(
                    prof, estimate_census(r.model, r.rt), REPLAN_VOCAB,
                    r.rt.run_cfg), capacity_drift=drift)
                diff = {k: d[k] for k in (
                    "flips", "pspecs_changed", "rebuilt", "capacity_grown",
                    "capacity_drifted")}
        out["adaptive" if adaptive else "static"] = dict(
            first=first, last=r.plan.embed_method, cap0=cap0,
            cap=r.plan.table_capacity["embed"], alpha=r.plan.alpha,
            grown=list(r.plan.grown_tables), losses=losses,
            dropped=dropped, diff=diff)
    return out


FLIP_KW = dict(KW, capacity_mode="capped", capacity_factor=2.0,
               link_latency=0.0)
GROWTH_KW = dict(KW, capacity_mode="capped", capacity_factor=2.0,
                 zipf_a=2.0, capacity_growth=1.5, overflow_tolerance=0.5,
                 link_latency=0.0)


def flip_rank(rank, world):
    """(4, 2), a replan after step 4 that flips ps -> ps_gather."""
    return _replan_drive((4, 2), FLIP_KW, 4, 8)


def growth_rank(rank, world):
    """(4, 1), a Zipf(1.3) burst in the first 4 batches against a buffer
    sized for Zipf(2.0); a growth replan after step 6 at drift 50."""
    return _replan_drive((4, 1), GROWTH_KW, 6, 10, drift=50.0,
                         ds_kw=dict(zipf_a=2.0, burst_steps=4,
                                    burst_zipf_a=1.3))


def wire_auto_rank(rank, world):
    """(8, 1), the bucketed step's magnitude census at outlier ratio 0:
    the replan pins every dense parameter to f32 on the wire."""
    from repro_torch.core.sparsity import (SparsityProfile, observed_census,
                                           wire_dtype_hints)
    from repro_torch.core.transform import estimate_census
    from repro_torch.utils.dtypes import dtype_name
    m = make_mesh((8, 1), ("data", "model"), device="cpu")
    c = cfg("phi3-medium-14b", vocab=REPLAN_VOCAB)
    kw = dict(KW, wire_dtype="bfloat16", opsw=True, capacity_mode="capped",
              capacity_factor=2.0, wire_dtype_auto=True,
              wire_outlier_ratio=0.0)
    ds = SyntheticLM(REPLAN_VOCAB, SEQ, 8)
    r = get_runner(c, tc.ShapeConfig("tiny", SEQ, 8, "train"),
                   tc.RunConfig(**kw), mesh=m, seed=0)
    keys0 = sorted({b.key[1] for b in r.plan.bucket_plan.buckets})
    prof = SparsityProfile()
    for i in range(3):
        met = r.run(ds.batch(i))
        prof.update({k: float(v) for k, v in met.items()
                     if getattr(v, "dim", lambda: 1)() == 0})
    gm = [k for k in prof.ema if k.endswith(("_gmax", "_grms"))]
    census = observed_census(prof, estimate_census(r.model, r.rt),
                             REPLAN_VOCAB, r.rt.run_cfg)
    census.wire_dtypes = wire_dtype_hints(prof, r.plan.bucket_plan,
                                          list(r.plan.params),
                                          outlier_ratio=0.0)
    n_buckets = len(r.plan.bucket_plan.buckets)
    d = r.replan(census)
    return {"n_gm": len(gm), "n_buckets": n_buckets,
            "wire_flips": bool(d["wire_flips"]), "rebuilt": d["rebuilt"],
            "pspecs_changed": d["pspecs_changed"],
            "wires": sorted({dtype_name(p.wire_dtype)
                             for p in r.plan.params.values()
                             if not p.sparse}),
            "keys0": keys0,
            "keys1": sorted({b.key[1] for b in r.plan.bucket_plan.buckets}),
            "loss": float(r.run(ds.batch(3))["loss"])}


# ---------------------------------------------------------------------------
# padded q heads: 6 heads on a model axis of 4 pad to 8
# ---------------------------------------------------------------------------

PAD_HEADS, PAD_KV = 6, 2


def pad_q_heads(named: dict, n_heads: int, padded: int, hd: int) -> dict:
    """Unpadded parameters -> the padded layout: zero q-head columns of
    ``wq`` and zero rows of ``wo`` for the heads past ``n_heads``."""
    import numpy as np
    out = dict(named)
    extra = (padded - n_heads) * hd
    wq, wo = named["layers.attn.wq"], named["layers.attn.wo"]
    out["layers.attn.wq"] = np.concatenate(
        [wq, np.zeros(wq.shape[:2] + (extra,), wq.dtype)], axis=2)
    out["layers.attn.wo"] = np.concatenate(
        [wo, np.zeros((wo.shape[0], extra, wo.shape[2]), wo.dtype)], axis=1)
    return out


def padded_rank(rank, world, named):
    """Reduced phi3 with 6 q heads (2 KV) on (2, 4) under hybrid: the plan
    pads the q heads to 8, whose outputs are zeroed before the o-proj."""
    m = make_mesh((2, 4), ("data", "model"), device="cpu")
    c = cfg("phi3-medium-14b", heads=PAD_HEADS, kv_heads=PAD_KV)
    r = get_runner(c, shape(), tc.RunConfig(**KW), mesh=m,
                   params=load_reference_params(
                       pad_q_heads(named, PAD_HEADS, 8, c.head_dim), "cpu"))
    assert r.rt.pad_heads(PAD_HEADS) == 8
    losses = [float(r.run(b)["loss"]) for b in batches(c.vocab_size)]
    cut = PAD_HEADS * c.head_dim
    # each rank holds its block of the q heads (tensor-parallel over
    # model): the padded heads are the last rank's; gather them whole
    wq, wo = (gather_tensor(r.model.get_parameter(n).detach(),
                            r.plan.params[n].held, m)
              for n in ("layers.attn.wq", "layers.attn.wo"))
    return {"loss": losses,
            "padded_max": max(float(wq[..., cut:].abs().max()),
                              float(wo[:, cut:].abs().max()))}
