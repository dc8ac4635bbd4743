"""Parameter-tree arithmetic over flat dicts of tensors.

The port keeps a model's parameters as one flat ``dict[str, Tensor]`` with
'/'-joined names (``"blocks/0/attn/wq"``), the leaves of the JAX package's
nested pytree.  The FL algorithms work on whole trees (``Delta_i = y_i - x``,
``x <- x + eta_g * Delta``); these helpers keep that arithmetic readable.
"""
from __future__ import annotations

import numpy as np
import torch

Tree = dict  # str -> torch.Tensor


def tree_zeros_like(tree: Tree, dtype: torch.dtype | None = None) -> Tree:
    return {k: torch.zeros_like(v, dtype=dtype) for k, v in tree.items()}


def tree_copy(tree: Tree) -> Tree:
    return {k: v.clone() for k, v in tree.items()}


def tree_sub(a: Tree, b: Tree) -> Tree:
    return {k: a[k] - b[k] for k in a}


def tree_sq_norm(tree: Tree) -> torch.Tensor:
    """Sum of squares across all leaves, in fp32."""
    return sum(torch.sum(v.float() ** 2) for v in tree.values())


def tree_count_params(tree: Tree) -> int:
    return sum(v.numel() for v in tree.values())


def flatten(tree, prefix: str = "") -> dict:
    """A nested dict (numpy arrays or tensors at the leaves) -> flat dict
    with '/'-joined keys, in the nested dict's key order."""
    out = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flatten(v, name + "/"))
        else:
            out[name] = v
    return out


def to_torch(tree: dict, device) -> Tree:
    """Flat dict of numpy arrays -> flat dict of tensors on ``device``."""
    return {k: torch.from_numpy(np.array(v)).to(device) for k, v in tree.items()}
