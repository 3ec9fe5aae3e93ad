"""repro_torch — the Parallax reproduction ported to PyTorch and CUDA on an
NVIDIA H100, beside the JAX package ``repro`` (the reference).

Its layout mirrors the reference (configs/, data/, core/, models/, optim/,
kernels/, utils/) so each module's counterpart is easy to find. It imports
torch and numpy only: never jax, never anything under ``repro``.
Entry points run on the card unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
