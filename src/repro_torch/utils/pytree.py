"""Parameter-tree arithmetic over flat dicts of tensors.

The port keeps a model's parameters as one flat ``dict[str, Tensor]`` with
'/'-joined names (``"blocks/0/attn/wq"``), the leaves of the JAX package's
nested pytree.  The FL algorithms work on whole trees (``Delta_i = y_i - x``,
``x <- x + eta_g * Delta``); these helpers keep that arithmetic readable.
Per-client state banks nest such trees in dicts (``{"downlink": {"ref":
tree}}``); :func:`tree_map` walks them.

The **wire view** (:func:`to_wire` / :func:`from_wire`) lays a tree out as
the JAX package's leaves: the JAX model stacks each per-layer weight on a
leading ``[L, ...]`` axis under ``blocks`` and ``jax.tree.flatten`` walks
nested-dict keys sorted.  The comm plane's codecs key their random streams
by leaf index and chunk each leaf, so they walk this view to draw the JAX
package's random bits and pay its wire bits.
"""
from __future__ import annotations

import math

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
    with '/'-joined keys, in the nested dict's key order; two leaves that
    join to one key raise."""
    out = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        sub = flatten(v, name + "/") if isinstance(v, dict) else {name: v}
        if out.keys() & sub.keys():
            raise ValueError(f"two leaves flatten to {sorted(out.keys() & sub.keys())}")
        out.update(sub)
    return out


def unflatten(flat: dict) -> dict:
    """The inverse of :func:`flatten`: '/'-joined keys -> nested dicts."""
    out: dict = {}
    for name, v in flat.items():
        *parents, leaf = name.split("/")
        node = out
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def np_to_tensor(a) -> torch.Tensor:
    """A numpy array (a copy of it) as a CPU tensor of the same dtype."""
    a = np.array(a)
    if a.dtype.name == "bfloat16":   # ml_dtypes' bfloat16 (JAX's), which torch cannot read
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def to_torch(tree: dict, device) -> Tree:
    """Flat dict of numpy arrays (bfloat16 ones too) -> flat dict of tensors
    on ``device``, of the same dtypes."""
    return {k: np_to_tensor(v).to(device) for k, v in tree.items()}


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts of tensors (``rest`` has the
    same structure as ``tree``)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


STACKS = ("blocks", "enc_blocks")     # the JAX trees' layer-stacked subtrees


def wire_layout(tree: Tree) -> list[tuple[str, list[str]]]:
    """The JAX package's leaves over the port's flat keys, in its order:
    ``[(path, keys)]``.  ``blocks/{i}/<name>`` for every layer ``i`` make one
    leaf ``blocks/<name>`` (keys in layer order), and likewise
    ``enc_blocks``; every other key is a leaf of its own, whose one key is
    its path.  Leaves are sorted by the tuple of their ``/`` parts, as
    ``jax.tree.flatten`` orders a nested dict.  For CharLM: 9 stacked block
    leaves, then ``embed``, ``final_norm/scale`` and ``lm_head``."""
    groups: dict[tuple, list] = {}
    for name in tree:
        parts = name.split("/")
        if len(parts) > 2 and parts[0] in STACKS and parts[1].isdigit():
            path, layer = (parts[0], *parts[2:]), int(parts[1])
        else:
            path, layer = tuple(parts), 0
        groups.setdefault(path, []).append((layer, name))
    return [("/".join(p), [n for _, n in sorted(groups[p])]) for p in sorted(groups)]


def to_wire(tree: Tree):
    """Yield ``(path, [C, n])`` for a ``[C]``-stacked tree in the JAX
    package's leaf order (:func:`wire_layout`).  A stacked leaf is the
    layer-major concatenation of its layers' flattened ``[C, ...]`` leaves,
    so a chunk of it may straddle two layers.  Leaves keep their dtype.  The
    other leaves are views; a stacked leaf is a copy, made when it is
    yielded, so a consumer that goes leaf by leaf holds one at a time.  All
    of them at once copy 3.65 GB for the CharLM-100M cohort of 8 (fp32)."""
    for path, names in wire_layout(tree):
        parts = [tree[k].reshape(tree[k].shape[0], -1) for k in names]
        yield path, parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)


def from_wire(wire, like: Tree) -> Tree:
    """The inverse of :func:`to_wire`: ``[(path, [C, n])]`` -> a tree with
    ``like``'s keys and shapes (views of the wire tensors, no copy)."""
    layout = dict(wire_layout(like))
    out = {}
    for path, v in wire:
        off = 0
        for k in layout[path]:
            m = math.prod(like[k].shape[1:])
            out[k] = v[:, off:off + m].reshape(like[k].shape)
            off += m
    return {k: out[k] for k in like}


def wire_shapes(tree: Tree) -> list[tuple[str, torch.Tensor]]:
    """One client's wire leaves for an (unstacked) tree, shapes only:
    ``[(path, meta tensor [n] of the leaf's dtype)]`` — what wire accounting
    charges for."""
    return [(path, torch.empty(sum(tree[k].numel() for k in names),
                               dtype=tree[names[0]].dtype, device="meta"))
            for path, names in wire_layout(tree)]
