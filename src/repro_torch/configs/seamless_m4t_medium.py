"""seamless-m4t-medium [audio] — enc-dec, multimodal [arXiv:2308.11596; hf].

The speech frontend (fbank + conformer adaptor) is a STUB: ``input_specs()``
provides precomputed frame embeddings of shape (batch, frames, d_model) for
the encoder; the decoder consumes text token ids from the 256206 vocab.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="seamless-m4t-medium",
    family="audio",
    n_layers=12,            # decoder layers
    enc_layers=12,          # encoder layers
    is_encdec=True,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,          # MHA
    d_ff=4096,
    vocab_size=256206,
    head_dim=64,            # 1024 / 16
    frontend_stub=True,
    source="arXiv:2308.11596; hf",
))
