"""rwkv6-7b [ssm] — Finch, data-dependent decay, attention-free
[arXiv:2404.05892; hf]."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="rwkv6-7b",
    family="ssm",
    n_layers=32,
    d_model=4096,
    n_heads=64,           # rwkv6 heads = d_model / head_size(64)
    n_kv_heads=64,
    d_ff=14336,
    vocab_size=65536,
    head_dim=64,
    source="arXiv:2404.05892; hf",
))
