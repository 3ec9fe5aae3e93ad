"""chameleon-34b [vlm] — early-fusion VQ image tokens [arXiv:2405.09818; unverified].

Early fusion means image patches are VQ-quantized into the shared vocab; the
VQ tokenizer is the modality frontend and is a STUB here — ``input_specs()``
provides token ids drawn from the unified text+image vocabulary.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="chameleon-34b",
    family="vlm",
    n_layers=48,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22016,
    vocab_size=65536,
    head_dim=128,
    frontend_stub=True,
    rope_theta=10000.0,
    source="arXiv:2405.09818; unverified",
))
