"""Quickstart: the two-line Parallax API (paper Table 2) on a tiny LM, the
port of the reference's ``examples/quickstart.py``.

    PYTHONPATH=src python -m repro_torch.examples.quickstart

Runs on the card; ``main(device="cpu")`` runs it on the CPU.
"""
from __future__ import annotations

import repro_torch
from repro_torch.configs import RunConfig, ShapeConfig


def main(*, device=None, steps: int = 20) -> list:
    """Train the reduced phi3 for ``steps`` steps; -> the losses."""
    # 1. a single-device model config (any assigned arch; reduced here)
    cfg = repro_torch.reduced(repro_torch.get_config("phi3-medium-14b"))
    shape = ShapeConfig("quickstart", seq_len=64, global_batch=4,
                        kind="train")

    # 2. data, with the paper's shard() API
    ds = repro_torch.shard(repro_torch.SyntheticLM(
        cfg.vocab_size, shape.seq_len, shape.global_batch),
        replica_id=0, num_replicas=1)

    # 3. get_runner transforms the single-device step into the
    #    distributed one (one device here; pass mesh=make_mesh(...) from
    #    launch/mesh.py on a process group: the model code is identical)
    runner = repro_torch.get_runner(
        cfg, shape, RunConfig(attention_impl="naive", remat="none",
                              learning_rate=3e-3), device=device)

    print(f"comm plan: {runner.plan.methods()}  "
          f"(sparse α={runner.plan.alpha:.3f}, embed via "
          f"{runner.plan.embed_method})")
    losses = []
    for step in range(steps):
        metrics = runner.run(ds.batch(step))
        losses.append(float(metrics["loss"]))
        if step % 5 == 0:
            print(f"step {step:3d}  loss {losses[-1]:.4f}")
    print("done — loss should have dropped by ~0.5 from step 0")
    return losses


if __name__ == "__main__":
    main()
