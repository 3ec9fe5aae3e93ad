"""Model factory (the port of ``repro/models/model.py``).

``build_model(cfg, rt)`` returns an ``nn.Module`` with ``specs()``,
``param_specs()``, ``input_specs()``, ``forward(batch)`` and
``loss_fn(batch) -> (loss, metrics)``. This slice ports the ``lstm``
family's decoder-only model; the other families are refused by name.
"""
from __future__ import annotations

from repro_torch.models.lstm import LSTMLM

# family -> the ROADMAP slice that ports it
_LATER = {
    "dense": "slice 4 (the dense transformer)",
    "vlm": "slice 6 (the other families)",
    "moe": "slice 6 (the other families)",
    "ssm": "slice 6 (the other families)",
    "hybrid": "slice 6 (the other families)",
    "audio": "slice 6 (the other families)",
}


def build_model(cfg, rt) -> LSTMLM:
    if cfg.family == "lstm":
        return LSTMLM(cfg, rt)
    where = _LATER.get(cfg.family, "a later slice")
    raise NotImplementedError(
        f"family {cfg.family!r} ({cfg.name}) is not ported yet: ROADMAP "
        f"{where}")
