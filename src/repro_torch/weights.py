"""Parameters of the JAX package, as the port's flat dicts.

``repro.models.model.Model.init`` returns a nested pytree whose per-layer
leaves are stacked on a leading ``[L, ...]`` axis.  The port keeps one flat
dict per model with the layer index in the key, so :func:`params_from_jax`
unstacks ``blocks`` into ``blocks/{i}/...`` (and an encoder-decoder's
``enc_blocks`` into ``enc_blocks/{i}/...``).  Dense weights stay ``[in, out]``
(the port applies them as ``x @ w``, as the JAX package does), so nothing is
transposed; every leaf keeps its dtype (a bf16 model's fp32 SSD leaves
``A_log``, ``dt_bias``, ``D`` and ``branch_scale`` too).
:func:`cache_from_jax` carries a serving cache across.
:func:`server_state_from_jax` carries a whole JAX
``ServerState`` across (params, optimizer state and the per-client bank,
whose stacked leaves are ``[N+1, L, ...]``), so a run can continue in the
port from a JAX state taken mid-run.  The input is numpy arrays
(``np.asarray`` of each JAX leaf); this module imports no JAX.
:func:`params_to_jax` and :func:`server_state_to_jax` are the exact
inverses: the port's trees as the JAX package's, numpy leaves (the
checkpoint module writes and reads the JAX package's files through them).
"""
from __future__ import annotations

from typing import TYPE_CHECKING

import numpy as np
import torch

from .configs.base import ArchConfig
from .utils.pytree import STACKS, flatten, np_to_tensor, to_torch, unflatten, wire_layout

if TYPE_CHECKING:     # fed imports utils.checkpoint, which imports this module
    from .fed.server import ServerState


def tensor_to_np(t) -> np.ndarray:
    """A tensor (any device) as a numpy array of its dtype; bf16 as
    ``ml_dtypes.bfloat16``, the type ``np.asarray`` of a JAX bf16 array
    has (imported only for a bf16 tensor)."""
    if not isinstance(t, torch.Tensor):
        return np.asarray(t)
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes

        return t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def params_to_jax(params: dict, *, axis: int = 0) -> dict:
    """The inverse of :func:`params_from_jax`: a port tree (a flat dict, or
    nested dicts of them; tensors on any device) -> the JAX package's nested
    tree of numpy arrays, ``blocks/{i}/...`` and ``enc_blocks/{i}/...``
    restacked on layer axis ``axis`` (1 in a per-client bank)."""
    flat = flatten(params)
    return unflatten({path: tensor_to_np(flat[path]) if names == [path] else
                      tensor_to_np(torch.stack([flat[n] for n in names], dim=axis))
                      for path, names in wire_layout(flat)})


def params_from_jax(np_tree: dict, cfg: ArchConfig | None, device, *, axis: int = 0) -> dict:
    """A JAX param tree (numpy leaves) -> the port's flat dict on ``device``.
    The layer axis of a ``blocks`` (``cfg.n_layers``) or ``enc_blocks``
    (``cfg.enc_layers``) leaf is ``axis`` (1 in a per-client bank, whose
    leaves lead with the bank axis); with ``cfg`` None the leaves' own layer
    axis gives the count."""
    flat = {}
    for name, leaf in flatten(np_tree).items():
        stack, _, rest = name.partition("/")
        if stack in STACKS:
            leaf = np.asarray(leaf)
            n = leaf.shape[axis] if cfg is None else \
                cfg.n_layers if stack == "blocks" else cfg.enc_layers
            if leaf.shape[axis] != n:
                raise ValueError(f"{name}: layer axis {leaf.shape[axis]} != {n} layers")
            flat.update({f"{stack}/{i}/{rest}": np.take(leaf, i, axis=axis) for i in range(n)})
        else:
            flat[name] = leaf
    return to_torch(flat, device)


def server_state_from_jax(np_state, cfg: ArchConfig | None, device) -> ServerState:
    """A JAX ``ServerState`` (numpy leaves, e.g. ``jax.tree.map(np.asarray,
    state)``) -> the port's ``ServerState`` on ``device``: params and each
    optimizer-state tree unstacked like :func:`params_from_jax` (heavy-ball's
    or MVR's ``m``, exact MVR's ``x_prev``, SCAFFOLD's ``c``, adam's ``mu``
    and ``nu``), the round counter as an int, and the client bank ``{name:
    {field: params-like}}`` (SCAFFOLD's ``"scaffold"`` / ``"c"``, the comm
    plane's ``"uplink"`` / ``"downlink"`` entries) unstacked along the layer
    axis after the bank axis; a field that is one array (the buffered
    server's ``"fleet"`` counters, ``[N+1]``) stays one tensor."""
    from .fed.server import ServerState

    clients = None
    if np_state.clients is not None:
        clients = {name: {field: params_from_jax(tree, cfg, device, axis=1)
                          if isinstance(tree, dict) else np_to_tensor(tree).to(device)
                          for field, tree in entry.items()}
                   for name, entry in np_state.clients.items()}
    return ServerState(
        params=params_from_jax(np_state.params, cfg, device),
        opt={k: params_from_jax(v, cfg, device) for k, v in np_state.opt.items()},
        rnd=int(np_state.rnd), clients=clients)


def server_state_to_jax(state: ServerState) -> ServerState:
    """The inverse of :func:`server_state_from_jax`: the port's
    ``ServerState`` with the JAX package's leaves: params and each
    optimizer-state tree restacked like :func:`params_to_jax`, the bank's
    trees on layer axis 1, and the round counter a 0-d int32 array."""
    from .fed.server import ServerState

    clients = None
    if state.clients is not None:
        clients = {name: {field: params_to_jax(tree, axis=1) if isinstance(tree, dict)
                          else tensor_to_np(tree) for field, tree in entry.items()}
                   for name, entry in state.clients.items()}
    return ServerState(params=params_to_jax(state.params),
                       opt={k: params_to_jax(v) for k, v in state.opt.items()},
                       rnd=np.asarray(int(state.rnd), np.int32), clients=clients)


def cache_from_jax(np_cache: dict, device) -> dict:
    """A JAX serving cache (``Model.prefill``'s, numpy leaves) -> the port's
    ``{"layers": {name: [L, B, ...] tensor}, "pos": int}`` on ``device``,
    every entry carried (an encoder-decoder's ``xk`` and ``xv`` too)."""
    return {"layers": {k: np_to_tensor(v).to(device) for k, v in np_cache["layers"].items()},
            "pos": int(np_cache["pos"])}
