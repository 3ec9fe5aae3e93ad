"""Static vs adaptive planning on a Zipf-skewed workload (the paper's
profile -> re-optimize loop, §5), replayed through the port: the two
phases of the reference's ``benchmarks/adaptive_replan.py``, each on 8
ranks of a (4 data x 2 model) process mesh started by
``launch/mesh.py::spawn`` over gloo.

Phase 1 runs reduced phi3 at vocab 256 twice on the same Zipf(1.3) batches,
once with the build-time plan and once with a replan from the observed
census after step 4, and reports the estimated (uniform and analytic
Zipf) and observed α, the embedding's method and capacity before and
after, the loss divergence of the two runs (the correctness contract
across a hot-swap) and the step times before and after the replan.

Phase 2 runs reduced parallax-nmt with two tables (a Zipf-skewed decoder
vocab and a declared near-dense encoder table) through a workload burst:
one ``analyze()`` gives the tables different methods and capacities, and
the replan every 4 steps grows the overflowing table's capacity.

    PYTHONPATH=src python -m repro_torch.benchmarks.adaptive_replan \\
        [--device cpu] [--out PATH]

``main`` makes the reference's checks (the adaptive run replanned; the
loss divergence < 5e-3; the two tables on different methods and
capacities; the capacity grew) and writes the record to ``--out`` (by
default a file under the system's temporary directory). The ranks run on
the card unless ``device="cpu"``; several ranks share one card over gloo,
so the step times are not exchange times.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np

ZIPF_A = 1.3
STEPS, PROFILE_STEPS = 16, 4          # phase 1: replan after step 4
REPLAN_EVERY = 4                      # phase 2
MESH = (4, 2)
OUT = os.path.join(tempfile.gettempdir(), "repro_torch_replan.json")
# link_latency=0 pins the paper's pure-byte Table-3 argmin, so the toy-sized
# table plans onto the row-sharded ps path (as in the reference)
SINGLE_KW = dict(attention_impl="naive", remat="none", param_dtype="float32",
                 compute_dtype="float32", wire_dtype="float32",
                 capacity_mode="capped", capacity_factor=1.5,
                 link_latency=0.0)
# decoder vocab table: declared steady skew Zipf(2.0), a tight capped
# buffer overflowed by a Zipf(1.3) burst in the first 4 batches; encoder
# table: declared near-dense (α 0.99), fed uniform source ids
TWO_TABLE_KW = dict(attention_impl="naive", remat="none",
                    param_dtype="float32", compute_dtype="float32",
                    wire_dtype="float32", capacity_mode="capped",
                    capacity_factor=2.0, link_latency=0.0, zipf_a=2.0,
                    capacity_growth=1.5, overflow_tolerance=0.5,
                    table_zipf=(("embed", 2.0),),
                    table_alpha=(("enc_embed", 0.99),))


def _scalars(metrics: dict) -> dict:
    return {k: float(v) for k, v in metrics.items()
            if getattr(v, "dim", lambda: 1)() == 0}


def single_table_rank(rank: int, world: int, device: str,
                      params=None) -> dict:
    """Phase 1 on this rank. ``params`` ({name: array}) replaces the
    seeded init (a comparison with the reference loads its init)."""
    from repro_torch.configs import RunConfig, ShapeConfig, get_config, \
        reduced
    from repro_torch.core.sparsity import (SparsityProfile, expected_unique,
                                           expected_unique_zipf,
                                           observed_census)
    from repro_torch.core.transform import estimate_census, get_runner
    from repro_torch.data import SyntheticLM
    from repro_torch.launch.mesh import make_mesh, rank_device
    from repro_torch.weights import load_reference_params
    dev = rank_device(device, rank)
    cfg = reduced(get_config("phi3-medium-14b"), vocab=256)
    shape = ShapeConfig("bench", seq_len=32, global_batch=8, kind="train")
    ds = SyntheticLM(cfg.vocab_size, 32, 8, zipf_a=ZIPF_A)
    mesh = make_mesh(MESH, ("data", "model"), device=dev)

    def drive(adaptive: bool) -> dict:
        run = get_runner(cfg, shape, RunConfig(**SINGLE_KW), mesh=mesh,
                         params=None if params is None else
                         load_reference_params(params, dev))
        before = dict(method=run.plan.embed_method,
                      capacity=run.plan.capacity, alpha=run.plan.alpha)
        prof = SparsityProfile()
        losses, times, replan = [], [], None
        for i in range(STEPS):
            t0 = time.perf_counter()
            m = run.run(ds.batch(i))
            loss = float(m["loss"])          # host sync closes the step
            times.append(time.perf_counter() - t0)
            losses.append(loss)
            prof.update(_scalars(m))
            if adaptive and i + 1 == PROFILE_STEPS:
                census = observed_census(
                    prof, estimate_census(run.model, run.rt),
                    cfg.vocab_size, run.rt.run_cfg)
                d = run.replan(census)
                replan = dict(step=i + 1, flips=[list(f) for f in
                                                 d["flips"]],
                              capacity=list(d["capacity"]),
                              alpha=list(d["alpha"]), rebuilt=d["rebuilt"])
        after = dict(method=run.plan.embed_method,
                     capacity=run.plan.capacity, alpha=run.plan.alpha)
        return dict(before=before, after=after, replan=replan,
                    losses=losses, observed_alpha=prof.alpha(cfg.vocab_size),
                    # the first step and the first after the swap dropped
                    pre_ms=float(np.median(times[1:PROFILE_STEPS]) * 1e3),
                    post_ms=float(np.median(times[PROFILE_STEPS + 1:])
                                  * 1e3))

    static = drive(adaptive=False)
    adaptive = drive(adaptive=True)
    local_tokens = shape.tokens // MESH[0]
    return dict(
        local_tokens=local_tokens, vocab=cfg.vocab_size,
        alpha_uniform=expected_unique(local_tokens, cfg.vocab_size)
        / cfg.vocab_size,
        alpha_zipf_analytic=expected_unique_zipf(
            local_tokens, cfg.vocab_size, ZIPF_A) / cfg.vocab_size,
        static=static, adaptive=adaptive,
        max_loss_divergence=max(abs(a - b) for a, b in
                                zip(static["losses"], adaptive["losses"])))


def two_table_rank(rank: int, world: int, device: str) -> dict:
    """Phase 2 on this rank."""
    from repro_torch.configs import RunConfig, ShapeConfig, get_config, \
        reduced
    from repro_torch.core.sparsity import SparsityProfile, observed_census
    from repro_torch.core.transform import estimate_census, get_runner
    from repro_torch.data import SyntheticLM
    from repro_torch.launch.mesh import make_mesh, rank_device
    dev = rank_device(device, rank)
    cfg = reduced(get_config("parallax-nmt"), vocab=256)
    shape = ShapeConfig("bench", seq_len=32, global_batch=8, kind="train")
    ds = SyntheticLM(cfg.vocab_size, 32, 8, is_encdec=True, src_zipf_a=0.0,
                     zipf_a=2.0, burst_steps=4, burst_zipf_a=1.3)
    mesh = make_mesh(MESH, ("data", "model"), device=dev)
    run = get_runner(cfg, shape, RunConfig(**TWO_TABLE_KW), mesh=mesh)
    trajectory = [dict(step=0, tables=run.plan.tables(), replanned=False)]
    prof = SparsityProfile()
    losses = []
    for i in range(STEPS):
        m = run.run(ds.batch(i))
        losses.append(float(m["loss"]))
        prof.update(_scalars(m))
        if (i + 1) % REPLAN_EVERY == 0:
            census = observed_census(
                prof, estimate_census(run.model, run.rt),
                cfg.vocab_size, run.rt.run_cfg)
            d = run.replan(census)
            trajectory.append(dict(
                step=i + 1, tables=run.plan.tables(),
                replanned=d["rebuilt"],
                capacity_grown=d["capacity_grown"],
                dropped={t: prof.dropped_for(t)
                         for t in ("embed", "enc_embed")}))
    return dict(trajectory=trajectory, losses=losses,
                final_tables=run.plan.tables())


def run(device: str = "cuda", params=None, timeout: float = 900.0) -> dict:
    """Both phases, each in 8 fresh ranks; rank 0's records (every rank
    plans and reports the same)."""
    from repro_torch.launch.mesh import spawn
    world = MESH[0] * MESH[1]
    single = spawn(single_table_rank, world, "gloo", device,
                   args=(device, params), timeout=timeout)[0]
    two = spawn(two_table_rank, world, "gloo", device, args=(device,),
                timeout=timeout)[0]
    return dict(single_table=single, two_table=two)


def check(res: dict) -> None:
    """The reference benchmark's own checks; raises AssertionError."""
    r = res["single_table"]["adaptive"]["replan"]
    assert r is not None and r["rebuilt"], "adaptive run never replanned"
    assert res["single_table"]["max_loss_divergence"] < 5e-3, \
        "replan changed the math, not just the wire schedule"
    two = res["two_table"]
    final = two["final_tables"]
    grew = [p for p in two["trajectory"] if p.get("capacity_grown")]
    assert set(final) == {"embed", "enc_embed"}, final
    assert final["embed"]["method"] != final["enc_embed"]["method"], final
    assert final["embed"]["capacity"] != final["enc_embed"]["capacity"], \
        final
    assert grew, "sustained overflow never grew the embed capacity"
    assert all(p["tables"].keys() == final.keys()
               for p in two["trajectory"])


def report(res: dict) -> None:
    single, two = res["single_table"], res["two_table"]
    st, ad = single["static"], single["adaptive"]
    print(f"workload: {single['local_tokens']} local tokens, "
          f"vocab {single['vocab']}, Zipf a={ZIPF_A}")
    print(f"alpha estimate  uniform={single['alpha_uniform']:.4f}  "
          f"zipf-analytic={single['alpha_zipf_analytic']:.4f}  "
          f"observed={ad['observed_alpha']:.4f}")
    print(f"static plan:    method={st['before']['method']} "
          f"capacity={st['before']['capacity']} "
          f"alpha={st['before']['alpha']:.4f} (never changes)")
    r = ad["replan"] or {}
    print(f"adaptive plan:  {ad['before']['method']} -> "
          f"{ad['after']['method']}  capacity {ad['before']['capacity']} "
          f"-> {ad['after']['capacity']}  (replanned at step "
          f"{r.get('step')}, flips={r.get('flips')})")
    print(f"step time:      static {st['pre_ms']:.1f} ms -> "
          f"{st['post_ms']:.1f} ms | adaptive {ad['pre_ms']:.1f} ms -> "
          f"{ad['post_ms']:.1f} ms")
    print(f"max loss divergence static vs adaptive: "
          f"{single['max_loss_divergence']:.2e}")
    print("two-table per-parameter plan (parallax-nmt reduced):")
    for t, e in sorted(two["final_tables"].items()):
        print(f"  {t:10s} method={e['method']:12s} "
              f"capacity={e['capacity']:4d} wire={e['wire_dtype']}  "
              f"grown={e['grown']}")
    print("capacity trajectory (embed):  " + " -> ".join(
        str(p["tables"]["embed"]["capacity"]) for p in two["trajectory"]))


def main(argv=None, *, device=None) -> dict:
    """Run both phases, print, check, write the record; -> the record."""
    ap = argparse.ArgumentParser(prog="repro_torch.benchmarks."
                                      "adaptive_replan")
    ap.add_argument("--device", default=None,
                    help="cpu or cuda (default: the card)")
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    device = device or args.device or "cuda"
    res = run(str(device))
    report(res)
    check(res)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=2)
    print(f"OK: replan changed the plan, not the math; per-table plans "
          f"diverged and overflow grew capacity; wrote {args.out}")
    return res


if __name__ == "__main__":
    main()
