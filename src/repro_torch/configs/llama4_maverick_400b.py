"""llama4-maverick-400b-a17b [moe] — MoE 128e top-1, early fusion
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,               # expert d_ff
    vocab_size=202048,
    head_dim=128,
    n_experts=128,
    experts_per_token=1,
    shared_expert=True,
    rope_theta=500000.0,
    source="hf:meta-llama/Llama-4-Scout-17B-16E; unverified",
))
