"""Parameter naming and enumeration order, shared across the port.

A parameter is known everywhere by its dotted name (``embed``,
``layers.w_x``): ParamPlan.name, Census.tables keys,
RunConfig.table_zipf/table_alpha and the census metric prefixes. Names are
those the JAX package's ``utils/tree.py::path_name`` renders from a pytree
path.

Order matters too. The reference walks parameters in JAX's flatten order,
which sorts dict keys at every level; init, the global-norm sum and the
optimizer walk all follow it, and a different order changes the last bits
of the norm. ``nn.Module`` registration order is not that order, so the
port enumerates through ``flatten`` / ``flatten_order`` below.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Iterable

import torch


def path_name(path: Iterable) -> str:
    """Render a path (dict keys and sequence indices) as a dotted name."""
    return ".".join(str(p) for p in path)


def flatten(tree: Any, is_leaf: Callable[[Any], bool] = lambda x: False,
            _prefix: tuple = ()) -> list:
    """[(dotted_name, leaf)] in JAX's flatten order: dict keys sorted,
    sequences in index order, ``None`` an empty subtree."""
    if tree is None:
        return []
    if is_leaf(tree):
        return [(path_name(_prefix), tree)]
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += flatten(tree[k], is_leaf, _prefix + (k,))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += flatten(v, is_leaf, _prefix + (i,))
        return out
    return [(path_name(_prefix), tree)]


def _order_key(name: str) -> tuple:
    return tuple((0, int(p), "") if p.isdigit() else (1, 0, p)
                 for p in name.split("."))


def flatten_order(names: Iterable[str]) -> list:
    """Dotted names sorted into JAX's flatten order."""
    return sorted(names, key=_order_key)


def named_parameters(module) -> dict:
    """{dotted_name: parameter} of an ``nn.Module`` in JAX's flatten order."""
    params = dict(module.named_parameters())
    return {n: params[n] for n in flatten_order(params)}


# ---------------------------------------------------------------------------
# byte and count helpers (the reference's, over tensors — meta tensors
# included, whose shape and dtype are all they hold — and over the port's
# dicts of named tensors)
# ---------------------------------------------------------------------------

def _is_leaf(x: Any) -> bool:
    return isinstance(x, torch.Tensor)


def named_leaves(tree: Any) -> list:
    """[(dotted_name, leaf)] for every leaf of the tree, in JAX's flatten
    order (``flatten``); a leaf is a tensor or any non-container value."""
    return flatten(tree, _is_leaf)


def leaf_count(leaf) -> int:
    """Elements of a leaf: the product of its shape (1 for a scalar or a
    leaf without one)."""
    shape = getattr(leaf, "shape", None)
    if shape is None:
        return 1
    return int(math.prod(shape)) if len(shape) else 1


def leaf_bytes(leaf) -> int:
    """Bytes of a leaf at its dtype (4 a element when it has none)."""
    dtype = getattr(leaf, "dtype", None)
    if isinstance(dtype, torch.dtype):
        itemsize = dtype.itemsize
    elif dtype is not None:
        itemsize = getattr(dtype, "itemsize", 4)
    else:
        itemsize = 4
    return leaf_count(leaf) * itemsize


def tree_count(tree: Any) -> int:
    """Total number of scalar elements in the tree."""
    return sum(leaf_count(l) for _, l in named_leaves(tree))


def tree_bytes(tree: Any) -> int:
    """Total bytes of the tree at its leaf dtypes."""
    return sum(leaf_bytes(l) for _, l in named_leaves(tree))
