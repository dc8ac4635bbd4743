"""Local client work: per-step transform chains over masked RR epochs.

The non-identical-local-steps regime (different |D_i|, E_i) runs a loop over
``K_max`` steps with a per-step {0,1} mask.  A masked step still takes its
gradient and applies ``y - (eta * 0) * g``, exactly as the JAX package's
masked ``lax.scan`` does, so NaN behaviour and results match it step for
step.

Step-size convention (Algorithm 4): client i uses ``eta_l / c_i`` per local
step (FedShuffle: c_i = K_i, the number of local steps; FedAvg/FedNova:
c_i = 1).  Every update is fp32 math cast back to the parameter dtype.

``local_sgd`` / ``local_mvr`` are the frozen references;
:func:`build_local_step` runs a chain of :class:`ClientTransform` links, and
the empty chain and the ``("mvr",)`` chain reproduce them bit for bit.
Gradients come from autograd.

:func:`build_cohort_step` runs the same chain for a whole cohort at once,
every client's steps batched over a leading ``[C]`` axis (the JAX package's
``jax.vmap`` of the per-client step).  The per-client loss runs vmapped,
forward only (:func:`cohort_loss`), and one ``torch.autograd.grad`` of the
cohort's summed loss gives every slot its own gradient: slot c's loss reads
slot c's parameters and data alone.  Autograd records the batched operations
the vmapped forward issues, so the backward pass is batched too and needs
no per-operation batching rules.

The port's counterpart of ``repro.core.local``; the ``scaffold`` / ``prox``
/ ``clip`` transforms and persistent per-client chain state are not ported
yet.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from ..utils.pytree import tree_sub


def value_and_grad(loss_fn: Callable, params: dict, mb: dict):
    """(loss, {name: d loss / d param}) of ``loss_fn(params, mb)``."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    with torch.enable_grad():
        loss, _ = loss_fn(leaves, mb)
        grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), dict(zip(leaves, grads))


def grad(loss_fn: Callable, params: dict, mb: dict) -> dict:
    """{name: d loss / d param} of ``loss_fn(params, mb)``."""
    return value_and_grad(loss_fn, params, mb)[1]


def _step_batch(data: dict, k: int) -> dict:
    return {n: v[k] for n, v in data.items()}


def _sum_steps(losses: list) -> torch.Tensor:
    """The steps' masked losses added in step order.  A masked step adds an
    exact zero, so a run over a K-step prefix of the mask (the bucketed
    layout) sums to the same bits as the run over all K_max steps; a
    reduction kernel over the stack could group the terms by its length."""
    total = losses[0]
    for loss in losses[1:]:
        total = total + loss
    return total


def local_sgd(loss_fn: Callable, params: dict, data: dict, step_mask: torch.Tensor,
              lr: torch.Tensor):
    """RR-epoch local SGD (reference; the empty chain reproduces it).

    loss_fn(params, microbatch) -> (scalar, metrics-dict)
    data: dict, leaves [K_max, B, ...]; step_mask [K_max]; lr 0-d tensor
    (already eta_l / c_i).  Returns (delta = y - x, mean masked loss).
    """
    y, losses = params, []
    for k in range(step_mask.shape[0]):
        m = step_mask[k]
        loss, g = value_and_grad(loss_fn, y, _step_batch(data, k))
        s = lr * m
        y = {n: (a.float() - s * g[n].float()).to(a.dtype) for n, a in y.items()}
        losses.append(loss * m)
    denom = torch.clamp_min(step_mask.sum(), 1.0)
    return tree_sub(y, params), _sum_steps(losses) / denom


def local_mvr(loss_fn: Callable, params: dict, momentum: dict, data: dict,
              step_mask: torch.Tensor, lr: torch.Tensor, a: float):
    """MVR-corrected local steps (reference; the ("mvr",) chain reproduces it).

    Paper eq. 12-13:

    d_{i,e,j} = a*g(y) + (1-a)*m + (1-a)*(g(y) - g(x))
              = g(y) + (1-a)*(m - g(x))
    where g(.) is the gradient of the *same* RR sample at the local iterate y
    and at the round-start point x.  Two gradient passes per step; the
    reported loss rides along with the g(y) pass.
    """
    y, losses = params, []
    for k in range(step_mask.shape[0]):
        m = step_mask[k]
        mb = _step_batch(data, k)
        loss, gy = value_and_grad(loss_fn, y, mb)
        gx = grad(loss_fn, params, mb)
        d = {n: gy[n].float() + (1.0 - a) * (momentum[n].float() - gx[n].float())
             for n in y}
        y = {n: (p.float() - (lr * m) * d[n]).to(p.dtype) for n, p in y.items()}
        losses.append(loss * m)
    denom = torch.clamp_min(step_mask.sum(), 1.0)
    return tree_sub(y, params), _sum_steps(losses) / denom


class StepCtx(NamedTuple):
    """What one local step exposes to the transform chain: the round-start
    point ``x``, the current iterate ``y``, the step's microbatch ``mb`` and
    {0,1} ``mask``, the client's step size ``eta``, the ``loss`` / ``grad``
    of the loss at ``y`` on ``mb``, and the server ``momentum`` tree the
    round handed down (the mvr opt's gradient estimate; zeros when the
    server opt keeps none)."""

    x: Any
    y: Any
    mb: Any
    mask: Any
    eta: Any
    loss: Any
    grad: Any
    momentum: Any = None


class ClientTransform(NamedTuple):
    """One link of a local-update chain.  ``init(params) -> carry`` builds
    the per-round carry (a dict of tensors, ``{}`` if none);
    ``update(step: StepCtx, d, carry) -> (d', carry')`` maps the fp32
    descent direction.  Carry updates on masked steps are discarded.
    ``client_init`` marks a transform with persistent per-client state (the
    JAX package's stateful transforms); binding one is not ported yet.
    ``needs`` lists the server opt-state keys / capability tags the
    transform reads (``bind_strategy`` refuses server opts that do not
    provide them)."""

    name: str
    init: Callable
    update: Callable
    client_init: Callable | None = None
    needs: tuple = ()


def build_local_step(transforms: tuple, loss_fn: Callable) -> Callable:
    """The per-client local update of a transform chain:

        one_client(params, data, step_mask, eta, momentum=None) -> (delta, loss)

    ``momentum`` is the server tree the steps see as ``StepCtx.momentum``.
    """

    def one_client(params, data, step_mask, eta, momentum=None):
        y, losses = params, []
        carries = [t.init(params) for t in transforms]
        for k in range(step_mask.shape[0]):
            m = step_mask[k]
            mb = _step_batch(data, k)
            loss, g = value_and_grad(loss_fn, y, mb)
            d = {n: v.float() for n, v in g.items()}
            ctx = StepCtx(x=params, y=y, mb=mb, mask=m, eta=eta, loss=loss, grad=g,
                          momentum=momentum)
            for i, t in enumerate(transforms):
                d, new = t.update(ctx, d, carries[i])
                # a masked step must be an exact no-op for carry state too
                carries[i] = {n: torch.where(m > 0, new[n], c) for n, c in carries[i].items()}
            s = eta * m
            y = {n: (p.float() - s * d[n]).to(p.dtype) for n, p in y.items()}
            losses.append(loss * m)
        denom = torch.clamp_min(step_mask.sum(), 1.0)
        return tree_sub(y, params), _sum_steps(losses) / denom

    return one_client


def mvr_transform(loss_fn: Callable, fl) -> ClientTransform:
    """MVR-corrected direction (paper eq. 12-13):
    ``d' = d + (1-a) * (m - g(x))`` with ``g(x)`` the same RR sample's
    gradient at the round-start point (each slot's own, stacked, when the
    chain is resolved over :func:`cohort_loss` for the batched cohort step).
    Needs a server *gradient estimate* in
    ``opt['m']``, declared as the tag ``grad_estimate`` so that only the
    ``mvr`` server opt satisfies it (heavy-ball's ``m`` is a momentum of
    aggregated deltas, another quantity at another scale)."""
    a = fl.mvr_a

    def update(step: StepCtx, d, carry):
        gx = grad(loss_fn, step.x, step.mb)
        d = {n: dl + (1.0 - a) * (step.momentum[n].float() - gx[n].float())
             for n, dl in d.items()}
        return d, carry

    return ClientTransform(name="mvr", init=lambda params: {}, update=update,
                           needs=("grad_estimate",))


def _masked_mean(grad_at: Callable, like: dict, step_mask: torch.Tensor,
                 bcast: Callable) -> dict:
    """fp32 sum over steps k of ``m_k * grad_at(k)``, over max(sum m_k, 1):
    ``step_mask``'s last axis is k, and ``bcast(v, leaf)`` shapes a mask
    value (or the count) to broadcast over a leaf of ``like``."""
    acc = {n: torch.zeros(v.shape, dtype=torch.float32, device=v.device)
           for n, v in like.items()}
    for k in range(step_mask.shape[-1]):
        m, g = step_mask[..., k], grad_at(k)
        acc = {n: A + bcast(m, A) * g[n].to(A.dtype) for n, A in acc.items()}
    denom = torch.clamp_min(step_mask.sum(-1), 1.0)
    return {n: A / bcast(denom, A) for n, A in acc.items()}


def full_local_gradient(loss_fn: Callable, params: dict, data: dict,
                        step_mask: torch.Tensor) -> dict:
    """Masked-mean gradient over the client's local data (one unbiased pass
    per epoch; across the whole RR stream the mean equals grad f_i up to the
    wrap padding of partial batches).  Used by exact FedShuffleMVR (eq. 14)."""
    return _masked_mean(lambda k: grad(loss_fn, params, _step_batch(data, k)), params,
                        step_mask, lambda v, like: v)


# ---------------------------------------------------------------------------
# The cohort at once: every client's steps batched over a leading [C] axis
# ---------------------------------------------------------------------------


def cohort_loss(loss_fn: Callable) -> Callable:
    """``loss_fn`` over a leading [C] client axis of params and microbatch:
    ``(params [C, ...], mb [C, B, ...]) -> (sum of the C losses, losses [C])``.

    The gradient of the sum w.r.t. the stacked params is each slot's own
    gradient, stacked, so :func:`grad` of this loss at a stacked point is a
    per-client gradient for every slot (what a chain link sees as its loss
    in :func:`build_cohort_step`)."""
    per_slot = torch.func.vmap(lambda p, mb: loss_fn(p, mb)[0])

    def loss(params, mb):
        losses = per_slot(params, mb)
        return losses.sum(), losses

    return loss


def _per_slot(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A [C] vector shaped to broadcast over ``like``'s [C, ...] slots."""
    return v.view(-1, *([1] * (like.dim() - 1)))


def _cohort_start(params: dict, C: int, stacked: bool) -> dict:
    # a shared tree as its stride-0 [C] broadcast (a view: no copy)
    return params if stacked else {n: v.expand(C, *v.shape) for n, v in params.items()}


def build_cohort_step(transforms: tuple, loss_fn: Callable) -> Callable:
    """The local update of a transform chain for the whole cohort at once:

        cohort(params, data, step_mask, eta, momentum=None, *, stacked=False)
            -> (deltas [C, ...], losses [C])

    ``data`` leaves are [C, K, B, ...], ``step_mask`` [C, K] and ``eta``
    [C].  ``params`` is the one tree every client starts from or, with
    ``stacked``, a [C, ...] tree of per-slot start points; ``momentum`` is
    the server tree every slot sees.  ``loss_fn`` is the per-client loss;
    ``transforms`` must be resolved over :func:`cohort_loss` of it, because
    their StepCtx carries the leading [C] axis (``x``, ``y``, ``mb``,
    ``loss``, ``grad``; ``mask`` and ``eta`` are [C]).  Every slot follows
    :func:`build_local_step`'s update rule element for element."""
    closs = cohort_loss(loss_fn)

    def value_and_grads(y, mb):
        # value_and_grad of the summed cohort loss, keeping the losses [C]
        leaves = {k: v.detach().requires_grad_(True) for k, v in y.items()}
        with torch.enable_grad():
            total, losses = closs(leaves, mb)
            grads = torch.autograd.grad(total, list(leaves.values()))
        return losses.detach(), dict(zip(leaves, grads))

    def cohort(params, data, step_mask, eta, momentum=None, *, stacked=False):
        x = _cohort_start(params, step_mask.shape[0], stacked)
        y, losses = x, []
        carries = [t.init(x) for t in transforms]
        for k in range(step_mask.shape[1]):
            m = step_mask[:, k]
            mb = {n: v[:, k] for n, v in data.items()}
            loss, g = value_and_grads(y, mb)
            d = {n: v.float() for n, v in g.items()}
            ctx = StepCtx(x=x, y=y, mb=mb, mask=m, eta=eta, loss=loss, grad=g,
                          momentum=momentum)
            for i, t in enumerate(transforms):
                d, new = t.update(ctx, d, carries[i])
                # a masked step must be an exact no-op for carry state too
                carries[i] = {n: torch.where(_per_slot(m, c) > 0, new[n], c)
                              for n, c in carries[i].items()}
            s = eta * m
            y = {n: (p.float() - _per_slot(s, p) * d[n]).to(p.dtype) for n, p in y.items()}
            losses.append(loss * m)
        denom = torch.clamp_min(step_mask.sum(1), 1.0)
        return tree_sub(y, x), _sum_steps(losses) / denom

    return cohort


def cohort_full_local_gradient(loss_fn: Callable, params: dict, data: dict,
                               step_mask: torch.Tensor) -> dict:
    """:func:`full_local_gradient` of every slot at one shared point
    ``params``: ``data`` [C, K, B, ...], ``step_mask`` [C, K]; returns the
    per-slot masked-mean gradients [C, ...]."""
    closs = cohort_loss(loss_fn)
    x = _cohort_start(params, step_mask.shape[0], stacked=False)
    return _masked_mean(lambda k: grad(closs, x, {n: v[:, k] for n, v in data.items()}), x,
                        step_mask, _per_slot)
