"""repro_torch — the Parallax reproduction ported to PyTorch and CUDA on an
NVIDIA H100, beside the JAX package ``repro`` (the reference).

Its layout mirrors the reference (configs/, data/, core/, models/, optim/,
kernels/, utils/) so each module's counterpart is easy to find. It imports
torch and numpy only: never jax, never anything under ``repro``.
Entry points run on the card unless the caller passes ``device="cpu"``.

The top level carries the reference's API (``repro/__init__.py``): the
paper's two lines (Table 2)

    runner = repro_torch.get_runner(cfg, shape, RunConfig())
    metrics = runner.run(ds.batch(i))

and ``shard`` / ``SyntheticLM`` for the data. The configs and the data
import no torch; ``Runtime``, ``Plan``, ``analyze`` and ``get_runner``
load ``core/`` (and torch) on first use, so ``import repro_torch.configs``
stays light.
"""

__version__ = "0.1.0"

from repro_torch.configs import (  # noqa: F401
    ModelConfig, ShapeConfig, RunConfig, SHAPES, ALL_ARCHS, PAPER_ARCHS,
    get_config, all_configs, reduced, shapes_for,
)
from repro_torch.data import shard, SyntheticLM  # noqa: F401

# name -> the core module that defines it
_CORE = {"Runtime": "repro_torch.core.runtime",
         "Plan": "repro_torch.core.plan",
         "analyze": "repro_torch.core.transform",
         "get_runner": "repro_torch.core.transform"}


def __getattr__(name: str):
    if name in _CORE:
        import importlib
        value = getattr(importlib.import_module(_CORE[name]), name)
        globals()[name] = value
        return value
    raise AttributeError(f"module 'repro_torch' has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + list(_CORE))
