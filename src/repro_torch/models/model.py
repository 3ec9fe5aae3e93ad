"""Model factory (the port of ``repro/models/model.py``).

``build_model(cfg, rt)`` returns an ``nn.Module`` that holds its
parameters, with ``specs()``, ``param_specs()``, ``input_specs()``,
``loss_fn(batch)``, ``prefill_fn(batch)``, ``decode_fn(cache, tokens,
cache_len)``, ``init_cache(batch, seq)`` and ``prefill_cache_fn(tokens)``
(None for a family whose recurrent state cannot be bucket-prefilled under
padding). Ported families: ``lstm`` (the paper's LM and its LSTM
encoder-decoder NMT, trained; the NMT is not served, as in the reference),
``dense`` (phi3, command-r and kin: trained and served) and ``ssm``
(rwkv6, served; its training waits for a WKV backward, ROADMAP slice 6
item 18, and ``RwkvLM.loss_fn`` refuses it). The others are refused by
name.
"""
from __future__ import annotations

from repro_torch.models.lstm import LSTMLM
from repro_torch.models.transformer import DenseLM, RwkvLM

# family -> the ROADMAP slice that ports it
_LATER = {
    "vlm": "slice 6 (the other families)",
    "moe": "slice 6 (the other families)",
    "hybrid": "slice 6 (the other families)",
    "audio": "slice 6 item 16 (models/encdec.py)",
}


def build_model(cfg, rt):
    if cfg.family == "lstm":
        return LSTMLM(cfg, rt)
    if cfg.family == "dense":
        return DenseLM(cfg, rt)
    if cfg.family == "ssm":
        return RwkvLM(cfg, rt)
    where = _LATER.get(cfg.family, "a later slice")
    raise NotImplementedError(
        f"family {cfg.family!r} ({cfg.name}) is not ported yet: ROADMAP "
        f"{where}")
