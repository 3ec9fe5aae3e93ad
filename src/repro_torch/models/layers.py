"""Parameter-spec system and basic layers (the port of
``repro/models/layers.py``).

Parameters are declared once as ``ParamSpec`` trees (nested dicts) with
logical axes; the same spec tree serves initialization and the sparsity
census (core/sparsity.py). Trees are walked in JAX's flatten order
(utils/tree.py), so init draws, census entries and plan records line up
with the reference leaf for leaf.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Optional

import torch
from torch import nn

from repro_torch.core import collectives as coll
from repro_torch.utils.tree import flatten


@dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    axes: tuple[Optional[str], ...]          # logical axis names, len == ndim
    init: str = "normal"                     # normal | zeros | ones | embed
    scale: Optional[float] = None            # stddev override for normal
    dtype: Any = None                        # None -> run param dtype
    sparse: bool = False                     # True: rows accessed via int gather
    fan_in_axes: tuple[int, ...] = ()        # axes contributing to fan-in

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes}")


def is_spec(x) -> bool:
    return isinstance(x, ParamSpec)


def stacked(spec: ParamSpec, n: int, axis_name: str = "layers") -> ParamSpec:
    """Add a leading stacked-layers dim."""
    return ParamSpec(
        (n, *spec.shape), (axis_name, *spec.axes),
        init=spec.init, scale=spec.scale, dtype=spec.dtype, sparse=spec.sparse,
        fan_in_axes=tuple(a + 1 for a in spec.fan_in_axes),
    )


def stack_tree(tree: dict, n: int) -> dict:
    return {k: stack_tree(v, n) if isinstance(v, dict) else stacked(v, n)
            for k, v in tree.items()}


def flatten_specs(specs: Any) -> list:
    """[(dotted_name, ParamSpec)] in JAX's flatten order."""
    return flatten(specs, is_leaf=is_spec)


def init_std(spec: ParamSpec) -> float:
    """The standard deviation of a ``normal`` or ``embed`` parameter's
    draw."""
    if spec.init == "embed":
        return 0.02
    if spec.scale is not None:
        return spec.scale
    fan_in = 1
    for a in (spec.fan_in_axes or (0,)):
        fan_in *= spec.shape[a]
    return 1.0 / math.sqrt(max(fan_in, 1))


def init_param(generator: torch.Generator, spec: ParamSpec,
               default_dtype: torch.dtype) -> torch.Tensor:
    """One parameter, drawn on the generator's device. The draws differ
    from ``jax.random`` for the same seed; parity tests load the
    reference's parameters instead (weights.py)."""
    dtype = spec.dtype or default_dtype
    device = generator.device
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dtype, device=device)
    x = torch.randn(spec.shape, generator=generator, dtype=torch.float32,
                    device=device)
    return x.mul_(init_std(spec)).to(dtype)


def init_tree(generator: torch.Generator, specs: Any,
              default_dtype: torch.dtype = torch.bfloat16) -> dict:
    """{dotted_name: tensor}: one draw per leaf, in flatten order."""
    return {name: init_param(generator, s, default_dtype)
            for name, s in flatten_specs(specs)}


class ParamTree(nn.Module):
    """A nested spec dict as nested modules: parameter ``a.b.c`` of the
    spec tree is ``named_parameters()`` entry ``a.b.c``, allocated
    uninitialized in the spec's dtype (or ``dtype``) on ``device``."""

    def __init__(self, specs: dict, dtype: torch.dtype, device):
        super().__init__()
        for name in sorted(specs):
            s = specs[name]
            if isinstance(s, dict):
                self.add_module(name, ParamTree(s, dtype, device))
            else:
                self.register_parameter(name, nn.Parameter(torch.empty(
                    s.shape, dtype=s.dtype or dtype, device=device)))


# ---------------------------------------------------------------------------
# functional layers
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm in f32, cast back to x's dtype."""
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * weight.float()).to(dt)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor, mesh=None) -> torch.Tensor:
    """SwiGLU MLP. ``mesh``: the weights are this rank's d_ff block
    (column-parallel ``w_gate`` / ``w_up``, row-parallel ``w_down``) and
    the block runs tensor-parallel over ``model`` in Megatron's form: the
    input's gradient summed over ``model`` (``copy_to``), the output summed
    over it (``reduce_from``). The reference's ``constrain`` pins the same
    d_ff sharding on its global-semantics product."""
    if mesh is not None:
        x = coll.copy_to(x, "model", mesh)
    h = torch.nn.functional.silu(x @ w_gate) * (x @ w_up)
    out = h @ w_down
    return out if mesh is None else coll.reduce_from(out, "model", mesh)
