"""The model's few explicit layout steps for DTensor inputs.

A step given DTensors (``launch/specs.py`` with a mesh) runs its ops through
DTensor's sharding propagation; where an op has no sharding rule, or
DTensor would pick a layout that cannot be reached (a vocab-parallel
lookup's partial sums reduce-scattered, heads split out of a projection
whose shards do not hold whole heads), the model calls one of these first.
Each is the identity on a plain tensor, so a step without a mesh runs as it
did; on a DTensor each is a redistribution, in the open, where
``CommDebugMode`` and the dry run's collective count see it.

Under ``torch.func.vmap`` (the vmapped cohort mode) a DTensor arrives
wrapped in a batched tensor: the layout is read from the DTensor beneath,
its dims shifted past the vmapped ones, and the redistribution runs there
(:class:`_Relayout`'s vmap rule).
"""
from __future__ import annotations

import functools

import torch
from torch._C._functorch import (get_unwrapped, is_batchedtensor,
                                 is_functorch_wrapped_tensor, maybe_get_bdim)


@functools.cache
def register_rules() -> None:
    """Sharding rules DTensor lacks in some PyTorch releases, registered once
    (``register_sharding``): ``aten.flip`` (a cumsum's backward flips),
    replicated, a partial sum, or sharded on a dim it does not flip."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding

    @register_sharding(torch.ops.aten.flip.default)
    def flip(x, dims):
        flipped = {d % x.ndim for d in dims}
        out = [([Replicate()], [Replicate(), None]), ([Partial()], [Partial(), None])]
        return out + [([Shard(d)], [Shard(d), None]) for d in range(x.ndim) if d not in flipped]


def _base(t):
    """(the DTensor beneath ``t``'s functorch levels (vmap's batching, the
    grad transform of ``models/remat.py``'s recompute) or None, the vmap
    levels' batch dims, outermost first)."""
    bdims = []
    while is_functorch_wrapped_tensor(t):
        if is_batchedtensor(t):
            bdims.append(maybe_get_bdim(t))
        t = get_unwrapped(t)
    from torch.distributed.tensor import DTensor

    return (t if isinstance(t, DTensor) else None), bdims


def _dtensor(t):
    if not isinstance(t, torch.Tensor) or (
            type(t) is torch.Tensor and not is_functorch_wrapped_tensor(t)):
        return None, []        # the meshless path's tensors stop here
    return _base(t)


def is_dtensor(t) -> bool:
    """A DTensor (not one beneath vmap's batching: the kernels, which are
    never vmapped, take the local shards of a bare one)."""
    if type(t) is torch.Tensor or not isinstance(t, torch.Tensor):
        return False
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def is_distributed(t) -> bool:
    """A DTensor over more than one rank, bare or beneath functorch's
    wrappers (a one-rank mesh runs the meshless ops)."""
    base = _dtensor(t)[0]
    return base is not None and base.device_mesh.size() > 1


def is_sharded(t, dim: int) -> bool:
    """``t``'s dim ``dim`` sharded over a mesh dim of more than one rank (a
    DTensor, bare or beneath functorch's wrappers)."""
    base, bdims = _dtensor(t)
    if base is None:
        return False
    d = _base_dim(t, dim, bdims)
    return any(p.is_shard(d) and n > 1 for p, n in zip(base.placements, base.device_mesh.shape))


class _Relayout(torch.autograd.Function):
    """``t.redistribute`` to ``target`` (the placements of the DTensor
    beneath any vmap level), with a vmap rule that runs it there; the
    gradient goes back to the source placements (a partial sum's as
    replicated, DTensor's own rule)."""

    @staticmethod
    def forward(t, target):
        return t.redistribute(t.device_mesh, target)

    @staticmethod
    def setup_context(ctx, inputs, output):
        base = _base(inputs[0])[0]       # beneath the grad transform's wrapper
        ctx.src = tuple(base.placements)

    @staticmethod
    def backward(ctx, g):
        # through this Function again: under remat's recompute the
        # cotangent is wrapped by the grad transform
        from torch.distributed.tensor import Replicate

        return _Relayout.apply(g, tuple(Replicate() if p.is_partial() else p
                                        for p in ctx.src)), None

    @staticmethod
    def vmap(info, in_dims, t, target):
        return _Relayout.apply(t, target), in_dims[0]


def _relayout(t, base, target):
    return t if tuple(target) == tuple(base.placements) else _Relayout.apply(t, tuple(target))


def settle(t: torch.Tensor) -> torch.Tensor:
    """Pending partial sums of a DTensor reduced (an all-reduce on each
    mesh dim that holds one); its shards stay."""
    base, _ = _dtensor(t)
    if base is None:
        return t
    from torch.distributed.tensor import Replicate

    return _relayout(t, base, [Replicate() if p.is_partial() else p for p in base.placements])


def _base_dim(t, dim: int, bdims: list) -> int:
    """``t``'s dim ``dim`` as a dim of the DTensor beneath its vmap levels."""
    d = dim % t.ndim
    for b in bdims:
        d = d + 1 if d >= b else d
    return d


def whole(t: torch.Tensor, *dims: int) -> torch.Tensor:
    """``t`` with its dims ``dims`` gathered on every rank and its partial
    sums reduced: before a gather of the label's logit along the vocab, or
    index arithmetic that folds a dim into another (the MoE dispatch's
    priority cumsum).  A dim vmap batches over stays as it is."""
    base, bdims = _dtensor(t)
    if base is None:
        return t
    from torch.distributed.tensor import Replicate

    ds = {_base_dim(t, dim, bdims) for dim in dims}
    return _relayout(t, base, [Replicate() if p.is_partial() or any(p.is_shard(d) for d in ds)
                               else p for p in base.placements])


def splittable(t: torch.Tensor, dim: int, lead: int) -> torch.Tensor:
    """``t`` ready for its dim ``dim`` to be split into [lead, rest] (heads
    out of a projection's output, KV groups out of the heads): a DTensor
    whose shards of that dim do not divide ``lead`` gathers it first."""
    base, bdims = _dtensor(t)
    if base is None:
        return t
    from torch.distributed.tensor import Replicate

    d = _base_dim(t, dim, bdims)
    sizes = base.device_mesh.shape
    n = 1
    for i, p in enumerate(base.placements):
        if p.is_shard(d):
            n *= sizes[i]
    if lead % n == 0:
        return t
    return _relayout(t, base, [Replicate() if p.is_shard(d) else p for p in base.placements])


def shard_model(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t``'s dim ``dim`` sharded over the mesh's ``"model"`` axis, its
    other shards kept (sequence parallelism of the residual stream,
    ``cfg.opt_seq_shard``); a partial sum is reduce-scattered.  The dim
    stays as it is where ``"model"`` shards another dim or does not divide
    it."""
    base, bdims = _dtensor(t)
    if base is None:
        return t
    from torch.distributed.tensor import Replicate, Shard

    names = base.device_mesh.mesh_dim_names or ()
    if "model" not in names:
        return t
    i = names.index("model")
    d = _base_dim(t, dim, bdims)
    p = base.placements[i]
    if (p.is_shard() and not p.is_shard(d)) or base.shape[d] % base.device_mesh.shape[i]:
        return t
    target = [Replicate() if q.is_partial() else q for q in base.placements]
    target[i] = Shard(d)
    return _relayout(t, base, target)


class _GradLayout(torch.autograd.Function):
    """The identity, whose gradient is made :func:`splittable` at (dim,
    lead), or with lead 0 :func:`whole` at dim: the backward of a merge of
    [lead, rest] splits the gradient again, and a row-parallel product
    after the merge hands back a gradient sharded over the merged dim."""

    @staticmethod
    def forward(t, dim, lead):
        return t.view_as(t)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.dim, ctx.lead = inputs[1], inputs[2]

    @staticmethod
    def backward(ctx, g):
        g = splittable(g, ctx.dim, ctx.lead) if ctx.lead else whole(g, ctx.dim)
        return g, None, None

    @staticmethod
    def vmap(info, in_dims, t, dim, lead):
        b = in_dims[0]
        d = dim % (t.ndim - 1)
        return _GradLayout.apply(t, d + 1 if d >= b else d, lead), b


def merged(t: torch.Tensor, dim: int, lead: int) -> torch.Tensor:
    """``t``, the merge of [lead, rest] into its dim ``dim``, with its
    gradient :func:`splittable` there (the identity on a plain tensor, and
    on a DTensor outside autograd)."""
    base, _ = _dtensor(t)
    if base is None or not torch.is_grad_enabled():
        return t
    return _GradLayout.apply(t, dim, lead)


def whole_grad(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t``, with its gradient :func:`whole` at ``dim``: a computation that
    gathered its inputs' ``dim`` (the SSD scan of the train loss on a mesh)
    takes its output's gradient gathered too."""
    base, _ = _dtensor(t)
    if base is None or not torch.is_grad_enabled():
        return t
    return _GradLayout.apply(t, dim, 0)
