"""parallax-lm — the paper's own LM (Jozefowicz et al. BIGLSTM family):
1-layer LSTM of 2048 units projected to a 512-dim embedding, 800K vocab
(One Billion Word). The paper's canonical *sparse* model (Table 1: 9M dense /
814M sparse params). Used for the Table-1/4 reproductions.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="parallax-lm",
    family="lstm",
    n_layers=1,
    d_model=512,            # embedding/projection dim
    n_heads=0,
    n_kv_heads=0,
    d_ff=2048,              # LSTM hidden units
    vocab_size=800000,
    head_dim=0,
    source="paper §7.1 / arXiv:1602.02410",
))
