"""stablelm-12b [dense] [hf:stabilityai/stablelm-2-1_6b; hf]."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="stablelm-12b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_ff=13824,
    vocab_size=100352,
    head_dim=160,  # 5120 / 32
    rope_theta=10000.0,
    source="hf:stabilityai/stablelm-2-1_6b; hf",
))
