"""Rematerialisation: a layer body whose activations the backward pass
recomputes instead of keeping (``cfg.remat == "full"``, the port's
counterpart of the JAX package's ``jax.checkpoint`` of a layer body).

:func:`checkpoint` runs ``body(*xs)`` without recording it for autograd
and keeps its inputs alone; the backward pass runs the body again under
``torch.func.vjp`` and pulls the output cotangents back through it.  It is
a ``torch.autograd.Function`` with ``setup_context`` and
``generate_vmap_rule``, so one mechanism serves both cohort modes: the
sequential mode's ``torch.autograd.grad`` of a client's loss, and the
vmapped mode's loss under ``torch.func.vmap`` with one
``torch.autograd.grad`` outside it (where ``torch.utils.checkpoint``
raises: its saved-tensor hooks see tensors of the vmap level).  The
recompute issues the same operations on the same inputs, so the
gradients are those of the plain body, bit for bit.

``body`` must be a function of its tensor inputs alone: a tensor it
captured from a vmapped caller would be batched in the forward pass and
unbatched in the recompute.  An input that is not floating point (the
positions) gets no cotangent.  A body may return one tensor or a tuple of
them (the moe block's ``(h, aux)``).
"""
from __future__ import annotations

from typing import Callable

import torch


def recompute_vjp(body: Callable, xs: tuple, cts: tuple) -> list:
    """The cotangents of ``body``'s inputs ``xs`` for the cotangents
    ``cts`` of its outputs, from a second run of ``body`` under
    ``torch.func.vjp``; ``None`` for an input that is not floating point."""
    diff = [i for i, x in enumerate(xs) if x.is_floating_point()]

    def of_diff(*d):
        full = list(xs)
        for i, x in zip(diff, d):
            full[i] = x
        return body(*full)

    _, pullback = torch.func.vjp(of_diff, *(xs[i] for i in diff))
    out = [None] * len(xs)
    for i, g in zip(diff, pullback(cts if len(cts) > 1 else cts[0])):
        out[i] = g
    return out


class _Checkpoint(torch.autograd.Function):
    generate_vmap_rule = True

    @staticmethod
    def forward(body, *xs):
        return body(*xs)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.body = inputs[0]
        ctx.save_for_backward(*inputs[1:])

    @staticmethod
    def backward(ctx, *cts):
        return (None, *recompute_vjp(ctx.body, ctx.saved_tensors, cts))


def checkpoint(body: Callable, *xs: torch.Tensor):
    """``body(*xs)``, keeping ``xs`` alone for the backward pass."""
    return _Checkpoint.apply(body, *xs)
