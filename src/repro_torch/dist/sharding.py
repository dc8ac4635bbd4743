"""Sharding rules: parameter name -> partition spec, and the tree helpers
that lay a tree out on a ``DeviceMesh`` (the port of
``repro.dist.sharding``).

The rules are the JAX package's Megatron/GSPMD layout:

* column-parallel weights (``wq``/``wk``/``wv``/``gate``/``up``/...) shard
  the *output* (last) dim over the tensor-parallel axis;
* row-parallel weights (``wo``/``down``/``out_proj``) shard the *input*
  (second-to-last) dim, so each TP rank consumes the activation shard the
  column-parallel product before it made;
* the token embedding shards the vocab dim; ``lm_head`` is column-parallel;
* MoE expert stacks ``[..., E, D, F]`` shard the expert dim over the TP axis
  (expert parallelism);
* norms, biases, gates and conv kernels are replicated.

Every rule degrades when its dim does not divide the axis size: a matched
but indivisible parameter gets an all-None spec of its rank, an unmatched
one the empty spec ``P()``.  ``fsdp=("data",)`` also shards the other
weight dim over the given axes: the input dim of a column-parallel weight,
the last dim of a row-parallel, embedding or expert weight.

The JAX package stacks each layer's weights on a leading ``[L, ...]`` axis
under ``blocks``; the port keeps one tensor a layer (``blocks/3/attn/wq``).
Every rule counts its dims from the end, so a port leaf gets the JAX
leaf's spec less the leading None of the layer axis.

A spec is :class:`P`, one entry a tensor dim: None, an axis name, or a
tuple of axis names.  ``mesh`` is anything that names its axis sizes: a
``DeviceMesh`` with ``mesh_dim_names``, or an object whose ``.shape`` maps
names to sizes.  :func:`placements` turns a spec into DTensor placements:
``Shard(d)`` on each mesh dim whose axis names tensor dim d, ``Replicate()``
elsewhere; a dim over several axes (``("pod", "data")``) takes them in mesh
order, the JAX package's major-to-minor order.
"""
from __future__ import annotations

from typing import Any

import torch

# leaf name -> which dim (from the end) the tp axis shards
_COL_PARALLEL = {
    "wq", "wk", "wv", "gate", "up", "wdkv", "wkr", "wuk", "wuv",
    "in_proj", "router", "lm_head", "patch_proj", "mtp_proj",
}
_ROW_PARALLEL = {"wo", "down", "out_proj"}
_EMBED = {"embed"}


class P(tuple):
    """A partition spec: one entry a tensor dim (None, an axis name or a
    tuple of names); ``P()`` replicates a tensor of any rank."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def axis_sizes(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh`` or a duck-typed mesh."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


def _axis_size(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    sizes = axis_sizes(mesh)
    s = 1
    for a in axes:
        s *= sizes[a]
    return s


def _divides(dim: int, mesh, axes) -> bool:
    n = _axis_size(mesh, axes)
    return n > 0 and dim % n == 0


def param_spec(path: str, shape: tuple, mesh, *, tp: str = "model", fsdp: Any = None) -> P:
    """The spec of one parameter: ``path`` its '/'-joined name
    (``"blocks/0/attn/wq"``), ``shape`` its shape, ``fsdp`` an axis name or
    a tuple of them for fully-sharded data parallelism, or None."""
    rank = len(shape)
    parts = path.split("/")
    leaf = parts[-1]
    spec: list = [None] * rank

    if "experts" in parts and rank >= 3:      # expert stacks: experts over the tp axis
        tp_dim = rank - 3
        if not _divides(shape[tp_dim], mesh, tp):
            return P(*spec)
    elif leaf in _EMBED and rank == 2:
        tp_dim = 0
        if not _divides(shape[0], mesh, tp):
            return P(*spec)
    elif leaf in _COL_PARALLEL and rank >= 2:
        tp_dim = rank - 1
        if not _divides(shape[-1], mesh, tp):
            return P(*spec)
    elif leaf in _ROW_PARALLEL and rank >= 2:
        tp_dim = rank - 2
        if not _divides(shape[-2], mesh, tp):
            return P(*spec)
    else:                                     # norms, biases, scalars, conv kernels
        return P()
    spec[tp_dim] = tp

    if fsdp:
        axes = (fsdp,) if isinstance(fsdp, str) else tuple(fsdp)
        # the other weight dim: the input dim of a column-parallel weight,
        # the last of a row-parallel, embedding or expert weight
        fsdp_dim = rank - 2 if tp_dim == rank - 1 else rank - 1
        if spec[fsdp_dim] is None and _divides(shape[fsdp_dim], mesh, axes):
            spec[fsdp_dim] = axes
    return P(*spec)


def params_specs(params: dict, mesh, *, tp: str = "model", fsdp: Any = None) -> dict:
    """{name: spec} of a flat parameter dict under :func:`param_spec`."""
    return {k: param_spec(k, tuple(v.shape), mesh, tp=tp, fsdp=fsdp) for k, v in params.items()}


def _dim_spec(shape, mesh, axes, dim: int) -> P:
    spec: list = [None] * len(shape)
    if dim < len(shape) and _divides(shape[dim], mesh, axes):
        spec[dim] = axes if isinstance(axes, str) else tuple(axes)
    return P(*spec)


def _map(tree, fn):
    """``fn`` on each leaf (a tensor, or a spec) of nested dicts, tuples
    and named tuples; None stays None."""
    if tree is None:
        return None
    if isinstance(tree, P) or not isinstance(tree, (dict, tuple, list)):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(_map(v, fn) for v in tree))
    return type(tree)(_map(v, fn) for v in tree)


def batch_specs(data, mesh, *, client_axis) -> dict:
    """Vmapped-cohort batches, leaves [C, K, B, ...]: the client dim over the
    data axes (one cohort slot a dp slice)."""
    return _map(data, lambda t: _dim_spec(t.shape, mesh, client_axis, 0))


def seq_batch_specs(data, mesh, *, dp_axis) -> dict:
    """Sequential-cohort batches, leaves [C, K, B, ...]: each scanned
    client's local batch B over the data axes (the whole mesh serves one
    client at a time)."""
    return _map(data, lambda t: _dim_spec(t.shape, mesh, dp_axis, 2))


def cache_specs(layers, mesh, *, dp_axis, shard_seq: bool = False) -> dict:
    """Decode caches, leaves [L, B, S|H, ...]: the batch over the data axes,
    and with ``shard_seq`` (batch-1 long-context serving) the sequence or
    state dim over ``"model"``."""

    def one(t):
        spec = list(_dim_spec(t.shape, mesh, dp_axis, 1))
        if shard_seq and len(t.shape) >= 3 and _divides(t.shape[2], mesh, "model"):
            spec[2] = "model"
        return P(*spec)

    return _map(layers, one)


def placements(spec: P, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh`` (a ``DeviceMesh``):
    ``Shard(d)`` on each mesh dim of more than one rank whose axis the spec
    gives tensor dim d, ``Replicate()`` on the rest."""
    from torch.distributed.tensor import Replicate, Shard

    by_axis = {}
    for d, entry in enumerate(spec):
        for a in ((entry,) if isinstance(entry, str) else (entry or ())):
            if a in by_axis:
                raise ValueError(f"axis {a!r} shards two dims of {spec}")
            by_axis[a] = d
    names = mesh.mesh_dim_names
    unknown = set(by_axis) - set(names)
    if unknown:
        raise ValueError(f"{spec} names axes {sorted(unknown)} the mesh {names} lacks")
    for entry in spec:       # a dim over several axes takes them in mesh order
        if isinstance(entry, tuple) and list(entry) != sorted(entry, key=names.index):
            raise ValueError(f"{spec}: {entry} is not in the mesh's order {names}")
    sizes = axis_sizes(mesh)
    # a mesh dim of one rank holds the whole tensor either way; replicated,
    # a size-1 dim stays free to be squeezed (DTensor will not reshape a
    # sharded one)
    return tuple(Shard(by_axis[a]) if a in by_axis and sizes[a] > 1 else Replicate()
                 for a in names)


def shardings(specs, mesh):
    """A tree of specs -> the same tree of ``(mesh, placements)``."""
    return _map(specs, lambda s: (mesh, placements(s, mesh)))


def params_shardings(params: dict, mesh, *, tp: str = "model", fsdp: Any = None) -> dict:
    return shardings(params_specs(params, mesh, tp=tp, fsdp=fsdp), mesh)


def batch_shardings(data, mesh, *, client_axis) -> dict:
    return shardings(batch_specs(data, mesh, client_axis=client_axis), mesh)


def seq_batch_shardings(data, mesh, *, dp_axis) -> dict:
    return shardings(seq_batch_specs(data, mesh, dp_axis=dp_axis), mesh)


def cache_shardings(layers, mesh, *, dp_axis, shard_seq: bool = False) -> dict:
    return shardings(cache_specs(layers, mesh, dp_axis=dp_axis, shard_seq=shard_seq), mesh)


def distribute(tree, shardings_tree):
    """A tree of tensors (nested dicts, tuples, or the named tuples of the
    round's state and batch) -> the same tree of DTensors under
    ``shardings_tree``, a tree of the same structure with ``(mesh,
    placements)`` at the leaves.  Every rank holds each whole tensor
    (weights and data come from one seed), so each keeps its own shard and
    nothing is sent; a ``meta`` tensor gives a ``meta`` shard.  A leaf that
    is not a tensor (a cache's ``pos``) stays as it is."""
    if isinstance(tree, torch.Tensor):
        from torch.distributed.tensor import distribute_tensor

        from .tensor import register_rules

        register_rules()
        mesh, pl = shardings_tree
        return distribute_tensor(tree, mesh, pl, src_data_rank=None)
    if isinstance(tree, dict):
        return {k: distribute(v, shardings_tree[k]) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(distribute(x, s) for x, s in zip(tree, shardings_tree)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(distribute(x, s) for x, s in zip(tree, shardings_tree))
    return tree
