"""Runtime handle threaded through model code: configs, plan, dtypes and
the device (the port of ``repro/core/runtime.py``, single device).

The device is explicit: ``None`` means the card (``"cuda"``); tests pass
``"cpu"``. Nothing moves to the CPU on its own when no card is found.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch

from repro_torch.configs.base import ModelConfig, RunConfig, ShapeConfig
from repro_torch.core.embedding import EmbedCtx
from repro_torch.utils.dtypes import torch_dtype


def resolve_device(device=None) -> torch.device:
    """``None`` -> the card. An explicit device is taken as given."""
    return torch.device("cuda" if device is None else device)


def check_ported(run_cfg: RunConfig, mesh: Any = None) -> None:
    """Refuse, by name, what this slice of the port does not run, rather
    than silently ignoring it."""
    refusals = [
        (mesh is not None, "a device mesh", "slice 2 (the distributed "
                                            "main path)"),
        (run_cfg.heartbeat, "RunConfig.heartbeat", "slice 7 (elasticity)"),
        (run_cfg.max_staleness > 0, "RunConfig.max_staleness > 0",
         "slice 7 (elasticity)"),
        (run_cfg.kernel_autotune, "RunConfig.kernel_autotune",
         "slice 8 (tooling)"),
        (run_cfg.verify_contract, "RunConfig.verify_contract",
         "slice 8 (tooling)"),
    ]
    for hit, what, where in refusals:
        if hit:
            raise NotImplementedError(
                f"{what} is not ported yet: ROADMAP {where}")


@dataclass
class Runtime:
    model_cfg: ModelConfig
    run_cfg: RunConfig
    shape_cfg: ShapeConfig
    mesh: Any = None
    plan: Optional[Any] = None          # core/plan.py Plan
    device: Any = None

    def __post_init__(self):
        check_ported(self.run_cfg, self.mesh)
        self.device = resolve_device(self.device)

    # ---- dtypes ----
    @property
    def dtype(self) -> torch.dtype:
        return torch_dtype(self.run_cfg.compute_dtype)

    @property
    def param_dtype(self) -> torch.dtype:
        return torch_dtype(self.run_cfg.param_dtype)

    @property
    def wire_dtype(self) -> torch.dtype:
        # OPSW: cast to the cheap wire dtype before collectives; baseline f32
        return (torch_dtype(self.run_cfg.wire_dtype) if self.run_cfg.opsw
                else torch.float32)

    def pad_heads(self, h: int) -> int:
        """q heads padded to the model-axis shard count: 1 on one device,
        so the identity. (The reference's ``constrain`` pins shardings and
        has no single-device meaning; the port has none.)"""
        return h

    @property
    def padded_vocab(self) -> int:
        # the vocab rounded up to the model-axis shard count: 1 on one device
        return self.model_cfg.vocab_size

    # ---- the sparse path (per table) ----
    def embed_ctx(self, name: str = "embed") -> EmbedCtx:
        wire = self.wire_dtype
        if self.plan is not None:
            wire = self.plan.table_wire.get(name, wire)
        return EmbedCtx(
            method="dense",
            vocab_padded=self.padded_vocab,
            wire_dtype=wire,
            local_agg=self.run_cfg.local_agg,
            exact=self.run_cfg.capacity_mode == "exact",
            census=self.shape_cfg.kind != "decode",
        )

    def embed_capacity_for(self, name: str = "embed") -> int:
        if self.plan is not None:
            cap = self.plan.table_capacity.get(name, self.plan.capacity)
            if cap:
                return cap
        # exact fallback: the token count (one replica holds them all)
        toks = self.shape_cfg.tokens
        if self.shape_cfg.kind == "decode":
            toks = max(self.shape_cfg.global_batch, 1)
        return max(min(toks, self.padded_vocab), 8)
