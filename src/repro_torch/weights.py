"""Parameters of the JAX package, as the port's flat dicts.

``repro.models.model.Model.init`` returns a nested pytree whose per-layer
leaves are stacked on a leading ``[L, ...]`` axis.  The port keeps one flat
dict per model with the layer index in the key, so :func:`params_from_jax`
unstacks ``blocks`` into ``blocks/{i}/...``.  Dense weights stay ``[in, out]``
(the port applies them as ``x @ w``, as the JAX package does), so nothing is
transposed.  The input is numpy arrays (``np.asarray`` of each JAX leaf);
this module imports no JAX.
"""
from __future__ import annotations

import numpy as np

from .configs.base import ArchConfig
from .utils.pytree import flatten, to_torch


def params_from_jax(np_tree: dict, cfg: ArchConfig, device) -> dict:
    """A JAX param tree (numpy leaves) -> the port's flat dict on ``device``."""
    flat = {}
    for name, leaf in flatten(np_tree).items():
        if name.startswith("blocks/"):
            leaf = np.asarray(leaf)
            if leaf.shape[0] != cfg.n_layers:
                raise ValueError(f"{name}: leading axis {leaf.shape[0]} != n_layers {cfg.n_layers}")
            rest = name[len("blocks/"):]
            flat.update({f"blocks/{i}/{rest}": leaf[i] for i in range(cfg.n_layers)})
        else:
            flat[name] = leaf
    return to_torch(flat, device)
