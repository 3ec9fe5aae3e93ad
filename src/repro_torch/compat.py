"""Capability probes for the port: is there a card, is it Hopper, where is
``nvcc``, which torch is this, which ``torch.distributed`` backends exist.

The JAX package's version shims (``repro/compat``) have no counterpart:
PyTorch has one spelling of everything this port calls. These probes only
*report*; nothing here switches a path to the CPU — entry points run on the
card unless the caller asks for ``device="cpu"`` — and nothing picks a
process-group backend: that is always the caller's explicit choice
(``launch/mesh.py::spawn``), never probed for and never swapped for
another.
"""
from __future__ import annotations

import os
import shutil
from typing import Optional

import torch
import torch.distributed as dist

# the one target the CUDA kernels are compiled for (sm_90a: H100 / H200)
HOPPER = (9, 0)


def cuda_available() -> bool:
    return torch.cuda.is_available()


def capability(device: int = 0) -> Optional[tuple]:
    """Compute capability of a card, or None without CUDA."""
    if not cuda_available():
        return None
    return tuple(torch.cuda.get_device_capability(device))


def is_hopper(device: int = 0) -> bool:
    return capability(device) == HOPPER


def nvcc_path() -> Optional[str]:
    """``nvcc`` on PATH, else under $CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root:
            cand = os.path.join(root, "bin", "nvcc")
            if os.path.isfile(cand) and os.access(cand, os.X_OK):
                return cand
    return None


def torch_version() -> str:
    return torch.__version__



def nccl_available() -> bool:
    """Was this torch built with NCCL (one card per rank)?"""
    return dist.is_available() and dist.is_nccl_available()


def gloo_available() -> bool:
    """Was this torch built with gloo (CPU tensors; on CUDA tensors only
    broadcast and all-reduce)?"""
    return dist.is_available() and dist.is_gloo_available()
