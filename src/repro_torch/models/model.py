"""Model factory (the port of ``repro/models/model.py``).

``build_model(cfg, rt)`` returns an ``nn.Module`` that holds its
parameters, with ``specs()``, ``param_specs()``, ``input_specs()``,
``loss_fn(batch)``, ``prefill_fn(batch)``, ``decode_fn(cache, tokens,
cache_len)``, ``init_cache(batch, seq)`` and ``prefill_cache_fn(tokens)``
(None for a family whose cache cannot be bucket-prefilled under padding, or
whose prefill needs encoder inputs). Ported families, each trained and
served:
  * ``lstm``: the paper's LM and its LSTM encoder-decoder NMT (the NMT is
    not served, as in the reference);
  * ``dense`` (phi3, stablelm, command-r, mistral), ``moe`` (grok-1,
    llama4-maverick: ``models/moe.py``'s experts in place of the MLP) and
    ``vlm`` (chameleon, the dense layers plus frontend ``embeds``): the
    paged engine;
  * ``ssm`` (rwkv6) and ``hybrid`` (hymba, attention beside a selective
    SSM): ``ToyServer``'s decode loop;
  * ``audio`` (seamless-m4t, ``models/encdec.py``): ``ToyServer``.
"""
from __future__ import annotations

from repro_torch.models.encdec import EncDecLM
from repro_torch.models.lstm import LSTMLM
from repro_torch.models.transformer import DenseLM, HybridLM, RwkvLM

_FAMILIES = {"dense": DenseLM, "moe": DenseLM, "vlm": DenseLM,
             "ssm": RwkvLM, "hybrid": HybridLM}


def build_model(cfg, rt):
    if cfg.family == "lstm":
        return LSTMLM(cfg, rt)
    if cfg.is_encdec:
        return EncDecLM(cfg, rt)
    if cfg.family not in _FAMILIES:
        raise NotImplementedError(f"family {cfg.family!r} ({cfg.name}) has "
                                  "no model in the port")
    return _FAMILIES[cfg.family](cfg, rt)
