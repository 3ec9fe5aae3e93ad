"""parallax-nmt — the paper's NMT (GNMT-style): 4-layer LSTMs of 1024 units,
bidirectional encoder, 1024-dim embeddings, WMT De-En vocab (~32k BPE per
side; paper Table 1: 94M dense / 75M sparse params).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="parallax-nmt",
    family="lstm",
    n_layers=4,
    d_model=1024,
    n_heads=0,
    n_kv_heads=0,
    d_ff=1024,
    vocab_size=36548,       # WMT14 de-en shared BPE-ish
    head_dim=0,
    is_encdec=True,
    enc_layers=4,
    source="paper §7.1 / GNMT arXiv:1609.08144",
))
