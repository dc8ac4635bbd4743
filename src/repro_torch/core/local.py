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
Gradients come from autograd.  The port's counterpart of
``repro.core.local``; the ``scaffold`` / ``prox`` / ``clip`` transforms and
persistent per-client chain state are not ported yet.
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
    return tree_sub(y, params), torch.stack(losses).sum() / denom


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
    return tree_sub(y, params), torch.stack(losses).sum() / denom


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
        return tree_sub(y, params), torch.stack(losses).sum() / denom

    return one_client


def mvr_transform(loss_fn: Callable, fl) -> ClientTransform:
    """MVR-corrected direction (paper eq. 12-13):
    ``d' = d + (1-a) * (m - g(x))`` with ``g(x)`` the same RR sample's
    gradient at the round-start point.  Needs a server *gradient estimate* in
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


def full_local_gradient(loss_fn: Callable, params: dict, data: dict,
                        step_mask: torch.Tensor) -> dict:
    """Masked-mean gradient over the client's local data (one unbiased pass
    per epoch; across the whole RR stream the mean equals grad f_i up to the
    wrap padding of partial batches).  Used by exact FedShuffleMVR (eq. 14)."""
    acc = {n: torch.zeros_like(v, dtype=torch.float32) for n, v in params.items()}
    for k in range(step_mask.shape[0]):
        m = step_mask[k]
        g = grad(loss_fn, params, _step_batch(data, k))
        acc = {n: A + m * g[n].to(A.dtype) for n, A in acc.items()}
    denom = torch.clamp_min(step_mask.sum(), 1.0)
    return {n: A / denom for n, A in acc.items()}
