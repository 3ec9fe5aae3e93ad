"""hymba-1.5b [hybrid] — parallel attn+mamba heads [arXiv:2411.13676; hf]."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    d_ff=5504,
    vocab_size=32001,
    head_dim=64,           # 1600 / 25
    ssm_state=16,
    conv_width=4,
    rope_theta=10000.0,
    source="arXiv:2411.13676; hf",
))
