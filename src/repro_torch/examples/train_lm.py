"""End-to-end training driver: train a phi3-family language model for a
few hundred steps with checkpointing, resume and throughput accounting
(the port of the reference's ``examples/train_lm.py``).

``--size 10m`` (the default) is a ~10M-parameter model; ``--size 100m``
a ~100M one (same code path).

    PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 300
    PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 300 --resume

Runs on the card; ``main(argv, device="cpu")`` runs it on the CPU. The
default checkpoint directory lies under the system's temporary directory.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile

from repro_torch.configs import RunConfig, ShapeConfig, get_config
from repro_torch.data import SyntheticLM

SIZES = {
    # layers, d_model, heads, kv, d_ff, vocab  (~params)
    "10m": (4, 256, 8, 4, 1024, 8192),
    "100m": (12, 768, 12, 4, 3072, 32768),
}


def _parse(argv=None):
    ap = argparse.ArgumentParser(prog="repro_torch.examples.train_lm")
    ap.add_argument("--size", default="10m", choices=list(SIZES))
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_lm"))
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--zipf-a", type=float, default=1.3,
                    help="token skew (natural-text-like embedding sparsity)")
    ap.add_argument("--bucket-bytes", type=int, default=4 * 1024 * 1024,
                    help="fused dense-gradient bucket size; 0 = per-tensor")
    ap.add_argument("--replan-every", type=int, default=0,
                    help="profile->replan period in steps (0 = static plan)")
    return ap.parse_args(argv)


def main(argv=None, *, device=None) -> dict:
    """Train; -> {"losses", "step", "replans", "tables"}."""
    from repro_torch.runtime.trainer import Trainer, TrainerConfig
    args = _parse(argv)
    n_layers, d, h, kv, f, v = SIZES[args.size]
    cfg = dataclasses.replace(
        get_config("phi3-medium-14b"), name=f"lm-{args.size}",
        n_layers=n_layers, d_model=d, n_heads=h, n_kv_heads=kv, d_ff=f,
        vocab_size=v, head_dim=d // h)
    print(f"model: {cfg.param_count() / 1e6:.1f}M params")
    shape = ShapeConfig("train", args.seq, args.batch, "train")
    rc = RunConfig(attention_impl="chunked", attention_chunk=128,
                   remat="none", learning_rate=1e-3,
                   capacity_mode="capped" if args.replan_every else "exact",
                   capacity_factor=1.5, bucket_bytes=args.bucket_bytes)
    ds = SyntheticLM(cfg.vocab_size, args.seq, args.batch,
                     zipf_a=args.zipf_a)
    tcfg = TrainerConfig(total_steps=args.steps, ckpt_dir=args.ckpt_dir,
                         ckpt_every=100, log_every=20,
                         replan_every=args.replan_every)
    trainer = Trainer(cfg, shape, rc, tcfg, ds, device=device)
    if args.resume:
        trainer.maybe_restore()
        print(f"resumed at step {trainer.step}")

    losses = []

    def on_metrics(step, m):
        losses.append(m.get("loss"))
        if step % 20 == 0:
            extra = ""
            if "observed_alpha" in m:
                extra = (f"  alpha {m['observed_alpha']:.4f}"
                         f"  replans {int(m.get('replans', 0))}")
            print(f"step {step:4d}  loss {m['loss']:.4f}  "
                  f"{m['tokens_per_s']:.0f} tok/s  "
                  f"step_time {m['step_time_s'] * 1e3:.0f} ms{extra}")

    trainer.run(on_metrics=on_metrics)
    if trainer.ckpt:
        trainer.ckpt.wait()
    if trainer.monitor.replans:
        print(f"adaptive replans: {trainer.monitor.replans}  "
              f"(plan alpha {trainer.plan.alpha:.4f}, "
              f"capacity {trainer.plan.capacity})")
        for t, e in sorted(trainer.plan.tables().items()):
            print(f"  table {t}: method={e['method']} "
                  f"capacity={e['capacity']} wire={e['wire_dtype']}"
                  + ("  [overflow-grown]" if e["grown"] else ""))
    if losses:
        print(f"final loss {losses[-1]:.4f} (start {losses[0]:.4f}); "
              f"checkpoints in {args.ckpt_dir}")
    return {"losses": losses, "step": trainer.step,
            "replans": trainer.monitor.replans,
            "tables": trainer.plan.tables()}


if __name__ == "__main__":
    main()
