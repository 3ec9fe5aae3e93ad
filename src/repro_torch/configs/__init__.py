"""Architecture registry. Importing this package registers every config."""
from repro_torch.configs.base import (
    ModelConfig, ShapeConfig, RunConfig, SHAPES,
    TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K,
    get_config, all_configs, reduced, register,
)

# assigned architectures (10) — import for registration side effect
from repro_torch.configs import phi3_medium_14b      # noqa: F401
from repro_torch.configs import stablelm_12b         # noqa: F401
from repro_torch.configs import command_r_35b        # noqa: F401
from repro_torch.configs import mistral_large_123b   # noqa: F401
from repro_torch.configs import llama4_maverick_400b # noqa: F401
from repro_torch.configs import grok_1_314b          # noqa: F401
from repro_torch.configs import chameleon_34b        # noqa: F401
from repro_torch.configs import rwkv6_7b             # noqa: F401
from repro_torch.configs import hymba_1_5b           # noqa: F401
from repro_torch.configs import seamless_m4t_medium  # noqa: F401
# paper's own models
from repro_torch.configs import parallax_lm          # noqa: F401
from repro_torch.configs import parallax_nmt         # noqa: F401

ALL_ARCHS = [
    "phi3-medium-14b",
    "stablelm-12b",
    "command-r-35b",
    "mistral-large-123b",
    "llama4-maverick-400b-a17b",
    "grok-1-314b",
    "chameleon-34b",
    "rwkv6-7b",
    "hymba-1.5b",
    "seamless-m4t-medium",
]

PAPER_ARCHS = ["parallax-lm", "parallax-nmt"]


def shapes_for(arch: str) -> list[str]:
    """The shape cells that apply to an arch (skips noted in DESIGN.md)."""
    cfg = get_config(arch)
    names = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.subquadratic:
        names.append("long_500k")
    return names
