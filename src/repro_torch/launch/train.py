"""Training launcher (the port of ``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch parallax-lm \\
        --steps 100 --seq 20 --batch 128 [--devices 4 --mesh 2x2] \\
        [--ckpt-dir DIR] [--replan-every 4 --capacity-mode capped]

Runs on the card unless the caller passes ``device="cpu"`` to ``main``.
The flags are the reference's; argv is parsed in ``main(argv=None, *,
device=None)``, not at import. ``--devices N --mesh DxM`` starts N ranks
(``launch/mesh.py::spawn``), NCCL when there is a card per rank, gloo
otherwise, each running the trainer on its shard of the mesh.

Mapped or refused, never ignored:
  * ``--arch``: the port trains the LSTM family (parallax-lm,
    parallax-nmt), the dense family (the default ``phi3-medium-14b``,
    command-r-35b, ...), moe (grok-1-314b, llama4-maverick-400b-a17b:
    expert-parallel on a mesh whose model axis divides the experts), vlm
    (chameleon-34b), hybrid (hymba-1.5b), ssm (rwkv6-7b, its WKV through
    the chunked form under autograd) and audio (seamless-m4t-medium, whose
    batches carry ``frames`` (B, seq // 4, d_model));
  * ``--embed-impl``: ``pallas`` (the default here) means the hand-written
    CUDA kernels on the card, their plain versions on the CPU, dispatched
    on the tensor's device; ``jnp`` (plain versions on the card) is
    refused;
  * ``--kernel-autotune`` reaches ``RunConfig.kernel_autotune``: on the
    card each table's scatter tile is measured and cached
    (kernels/autotune.py); on the CPU nothing is measured;
  * ``--attention`` is ``RunConfig.attention_impl`` (every attention
    family's; no LSTM reads it); ``pallas`` is refused for training (the
    flash kernel is forward-only, as the reference's);
  * the elastic flags (``--remesh-on-straggle``, ``--remesh-cooldown``,
    ``--min-data-parallel``, ``--heartbeat``, ``--no-attribution``,
    ``--probation-*``, ``--max-staleness``, ``--stale-on-jitter``) reach
    ``TrainerConfig`` and ``RunConfig`` (runtime/trainer.py): on a mesh a
    straggling data slice is evicted and its ranks wait off the mesh; the
    record of such a rank says ``live`` False, and the lead rank of the
    live mesh prints.
"""
from __future__ import annotations

import argparse
import logging
import math
import sys
import time

import torch

from repro_torch.configs import RunConfig, ShapeConfig, get_config, reduced
from repro_torch.core.runtime import check_ported
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.launch.mesh import make_mesh, spawn
from repro_torch.models.transformer import check_trainable

TRAINABLE = ("lstm", "dense", "moe", "vlm", "hybrid", "ssm", "audio")


def _parse(argv=None):
    ap = argparse.ArgumentParser(prog="repro_torch.launch.train")
    ap.add_argument("--arch", default="phi3-medium-14b")
    ap.add_argument("--reduced", action="store_true",
                    help="use the reduced smoke config of the arch")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--devices", type=int, default=0)
    ap.add_argument("--mesh", default="", help="e.g. 2x4 => data=2,model=4")
    ap.add_argument("--comm-mode", default="hybrid")
    ap.add_argument("--no-local-agg", action="store_true")
    ap.add_argument("--no-opau", action="store_true")
    ap.add_argument("--no-opsw", action="store_true")
    ap.add_argument("--capacity-mode", default="exact",
                    choices=("exact", "capped"))
    ap.add_argument("--capacity-factor", type=float, default=1.0)
    ap.add_argument("--bucket-bytes", type=int, default=4 * 1024 * 1024,
                    help="fused dense-gradient bucket size; 0 = per-tensor")
    ap.add_argument("--embed-impl", dest="embed_route", default="pallas",
                    choices=("jnp", "pallas"),
                    help="pallas: the hand-written CUDA kernels on the "
                         "card (their plain versions on the CPU); jnp is "
                         "refused")
    ap.add_argument("--zipf-a", type=float, default=1.3,
                    help="skew of the synthetic token distribution")
    ap.add_argument("--plan-zipf", action="store_true",
                    help="let the planner assume the declared --zipf-a "
                         "skew (default: the uniform-draw bound)")
    ap.add_argument("--table-zipf", default="",
                    help="per-table declared skew, e.g. "
                         "'embed=1.3,enc_embed=1.05'")
    ap.add_argument("--capacity-growth", type=float, default=1.5)
    ap.add_argument("--overflow-tolerance", type=float, default=0.5)
    ap.add_argument("--wire-auto", action="store_true",
                    help="profiled per-parameter wire dtypes from the "
                         "gradient magnitude census")
    ap.add_argument("--wire-outlier-ratio", type=float, default=64.0)
    ap.add_argument("--hw-profile", default=None,
                    help="fitted hardware profile JSON for the planner")
    ap.add_argument("--no-fused-apply", action="store_true")
    ap.add_argument("--kernel-autotune", action="store_true")
    ap.add_argument("--no-overlap", action="store_true")
    ap.add_argument("--replan-every", type=int, default=0,
                    help="profile->replan period in steps (0 = static)")
    ap.add_argument("--replan-warmup", type=int, default=2)
    ap.add_argument("--replan-drift", type=float, default=1.5)
    ap.add_argument("--profile-decay", type=float, default=0.9)
    ap.add_argument("--remesh-on-straggle", action="store_true")
    ap.add_argument("--remesh-cooldown", type=int, default=50)
    ap.add_argument("--min-data-parallel", type=int, default=1)
    ap.add_argument("--heartbeat", action="store_true")
    ap.add_argument("--no-attribution", action="store_true")
    ap.add_argument("--probation-steps", type=int, default=100)
    ap.add_argument("--probation-sustained", type=int, default=2)
    ap.add_argument("--max-staleness", type=int, default=0)
    ap.add_argument("--stale-on-jitter", action="store_true")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--remat", default="block")
    ap.add_argument("--attention", default="naive")
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


def _check(args, cfg) -> None:
    """Refuse, by name, what the port does not train or run."""
    if cfg.family not in TRAINABLE:
        raise NotImplementedError(
            f"training {cfg.name} (family {cfg.family!r}) is not ported: "
            f"the port trains the families {TRAINABLE}")
    if cfg.family != "lstm":
        check_trainable(RunConfig(attention_impl=args.attention))
    if args.embed_route == "jnp":
        raise NotImplementedError(
            "--embed-impl jnp: the port has no plain embedding route on "
            "the card; its kernels dispatch on the tensor's device (the "
            "plain versions on the CPU), which is --embed-impl pallas")
    if args.devices > 1 and not args.mesh:
        raise ValueError("--devices N needs --mesh DxM (the ranks' mesh)")


def _configs(args):
    """-> (model, shape, run and trainer configs); what the port does not
    run is refused here, before any rank starts."""
    from repro_torch.runtime.trainer import TrainerConfig
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    _check(args, cfg)
    shape = ShapeConfig("cli", args.seq, args.batch, "train")
    table_zipf = tuple(
        (k, float(v)) for k, v in
        (kv.split("=", 1) for kv in args.table_zipf.split(",") if kv))
    run_cfg = RunConfig(
        comm_mode=args.comm_mode, local_agg=not args.no_local_agg,
        opau=not args.no_opau, opsw=not args.no_opsw,
        capacity_mode=args.capacity_mode,
        capacity_factor=args.capacity_factor,
        capacity_growth=args.capacity_growth,
        overflow_tolerance=args.overflow_tolerance,
        zipf_a=args.zipf_a if args.plan_zipf else None,
        table_zipf=table_zipf,
        wire_dtype_auto=args.wire_auto,
        wire_outlier_ratio=args.wire_outlier_ratio,
        hw_profile=args.hw_profile, overlap=not args.no_overlap,
        fused_apply=not args.no_fused_apply,
        kernel_autotune=args.kernel_autotune,
        bucket_bytes=args.bucket_bytes, learning_rate=args.lr,
        remat=args.remat, attention_impl=args.attention, seed=args.seed,
        heartbeat=args.heartbeat, max_staleness=args.max_staleness)
    check_ported(run_cfg)
    tcfg = TrainerConfig(total_steps=args.steps, ckpt_dir=args.ckpt_dir,
                         ckpt_every=args.ckpt_every,
                         log_every=args.log_every,
                         replan_every=args.replan_every,
                         replan_warmup=args.replan_warmup,
                         replan_drift=args.replan_drift,
                         profile_decay=args.profile_decay,
                         remesh_on_straggle=args.remesh_on_straggle,
                         remesh_cooldown=args.remesh_cooldown,
                         min_data_parallel=args.min_data_parallel,
                         attribution=not args.no_attribution,
                         probation_steps=args.probation_steps,
                         probation_sustained=args.probation_sustained,
                         stale_on_jitter=args.stale_on_jitter)
    return cfg, shape, run_cfg, tcfg


def _mesh_dims(args) -> tuple:
    dims = tuple(int(x) for x in args.mesh.split("x"))
    axes = ("data", "model") if len(dims) == 2 else ("pod", "data", "model")
    if args.devices and math.prod(dims) != args.devices:
        raise ValueError(f"--mesh {args.mesh} holds {math.prod(dims)} "
                         f"ranks, --devices says {args.devices}")
    return dims, axes


def train(args, device=None, mesh=None) -> dict:
    """One process's run: build the trainer, restore, train. Returns its
    losses, the plan before and after, the replans and the step times."""
    from repro_torch.runtime.trainer import Trainer
    cfg, shape, run_cfg, tcfg = _configs(args)
    ds = SyntheticLM(cfg.vocab_size, args.seq, args.batch, seed=args.seed,
                     zipf_a=args.zipf_a, is_encdec=cfg.is_encdec,
                     frames_dim=cfg.d_model if cfg.family == "audio" else 0,
                     frames_len=max(args.seq // 4, 1))
    trainer = Trainer(cfg, shape, run_cfg, tcfg, ds, mesh=mesh,
                      device=device)
    plan0 = trainer.plan.tables()
    trainer.maybe_restore()
    history = []

    def on_metrics(step, m):
        history.append({k: v for k, v in m.items()
                        if isinstance(v, (int, float, bool))})
        if trainer.writer and step % args.log_every == 0:
            extra = ""
            if "observed_alpha" in m:
                extra = (f"  alpha {m['observed_alpha']:.4f}"
                         f"  replans {int(m.get('replans', 0))}")
            over = {t: v for t, v in m.get("overflow", {}).items() if v > 0}
            if over:
                extra += "  dropped " + ",".join(
                    f"{t}:{v:.1f}" for t, v in sorted(over.items()))
            if m.get("ckpt_retries"):
                extra += f"  ckpt-retries {int(m['ckpt_retries'])}"
            if "apply_seconds" in m:
                extra += f"  apply {m['apply_seconds'] * 1e6:.0f}us"
            if "ckpt_error" in m:
                extra += f"  CKPT-ERROR {m['ckpt_error']}"
            print(f"step {step:5d}  loss {m.get('loss', float('nan')):.4f}"
                  f"  {m.get('tokens_per_s', 0):.0f} tok/s  "
                  f"gnorm {m.get('grad_norm', float('nan')):.3f}{extra}",
                  flush=True)

    t0 = time.perf_counter()
    trainer.run(on_metrics=on_metrics)
    dt = time.perf_counter() - t0
    if trainer.writer and trainer.live:
        print(f"done: {len(history)} steps in {dt:.1f}s "
              f"({len(history) * shape.tokens / max(dt, 1e-9):.0f} tok/s "
              "avg)", flush=True)
    return {"losses": [h["loss"] for h in history],
            "step_time_s": [h["step_time_s"] for h in history],
            "tokens_per_s": [h["tokens_per_s"] for h in history],
            "history": history, "seconds": dt, "step": trainer.step,
            "live": trainer.live,
            "plan0": plan0, "plan": trainer.plan.tables(),
            "replans": [{k: d[k] for k in (
                "step", "flips", "pspecs_changed", "capacity_drifted",
                "capacity_grown", "table_capacity", "rebuild_s")}
                for d in trainer.replan_history],
            "trainer": trainer if mesh is None else None}


def _rank_main(rank: int, world: int, argv: list, device: str,
               dims: tuple, axes: tuple) -> dict:
    """One rank of ``--devices N --mesh DxM`` (launch/mesh.py::spawn).
    Its record carries the rank's kernel launches (``launches``)."""
    from repro_torch.kernels import ops
    dev = torch.device("cpu") if device == "cpu" else \
        torch.device("cuda", torch.cuda.current_device())
    mesh = make_mesh(dims, axes, device=dev)
    ops.reset_launch_counts()
    out = train(_parse(argv), device=dev, mesh=mesh)
    out["launches"] = ops.launch_counts()
    return {k: v for k, v in out.items() if k != "trainer"}


def main(argv=None, *, device=None):
    """Run the launcher. ``device`` (default: the card) lets a caller run
    it on the CPU. One process: returns ``train``'s record (its
    ``trainer`` included); on a mesh: every rank's record."""
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    argv = sys.argv[1:] if argv is None else list(argv)
    args = _parse(argv)
    _configs(args)                      # refuse before any rank starts
    dev = torch.device("cuda" if device is None else device)
    print(f"torch {torch.__version__}  device={dev}", flush=True)
    if not args.mesh:
        return train(args, device=dev)
    dims, axes = _mesh_dims(args)
    world = math.prod(dims)
    backend = "nccl" if dev.type == "cuda" and \
        torch.cuda.device_count() >= world else "gloo"
    return spawn(_rank_main, world, backend, dev.type,
                 args=(argv, dev.type, dims, axes),
                 timeout=3600)


if __name__ == "__main__":
    main()
