"""Local client work: per-step transform chains over masked RR epochs.

The non-identical-local-steps regime (different |D_i|, E_i) runs a loop over
``K_max`` steps with a per-step {0,1} mask.  A masked step still takes its
gradient and applies ``y - (eta * 0) * g``, exactly as the JAX package's
masked ``lax.scan`` does, so NaN behaviour and results match it step for
step.

Step-size convention (Algorithm 4): client i uses ``eta_l / c_i`` per local
step (FedShuffle: c_i = K_i, the number of local steps; FedAvg/FedNova:
c_i = 1).  Every update is fp32 math cast back to the parameter dtype.

**Client-transform chains.**  A local update rule is a chain of
:class:`ClientTransform` links (a :class:`ClientChain` names them through
:data:`CLIENT_TRANSFORMS`).  Every local step computes the fp32 direction
``d = g(y)`` and threads it through the chain; the runner then applies the
masked descent ``y <- (y - eta*m*d).to(dtype)``.  A transform may keep

* **per-round carry state** (``init`` / ``update``), reset every round;
  carry updates on masked steps are discarded;
* **persistent per-client state** (``client_init`` / ``finalize``), e.g.
  SCAFFOLD's control variates: the round step banks one ``[N+1, ...]``
  row set per stateful transform on ``ServerState.clients``, gathers the
  cohort's rows and commits the finalized rows back (``fed.rounds``);
* a **shipped-update hook** (``finalize_delta``), applied in chain order
  after the local steps; a chain without one adds no operation.

``local_sgd`` / ``local_mvr`` are the frozen references;
:func:`build_local_step` runs a chain, and the empty chain and the
``("mvr",)`` chain reproduce them bit for bit.  Gradients come from
autograd.

:func:`build_cohort_step` runs the same chain for a whole cohort at once,
every client's steps batched over a leading ``[C]`` axis (the JAX package's
``jax.vmap`` of the per-client step).  The per-client loss runs vmapped,
forward only (:func:`cohort_loss`), and one ``torch.autograd.grad`` of the
cohort's summed loss gives every slot its own gradient: slot c's loss reads
slot c's parameters and data alone.  Autograd records the batched operations
the vmapped forward issues, so the backward pass is batched too and needs
no per-operation batching rules.  A transform sees the cohort form by its
``StepCtx.mask`` (``[C]`` there, 0-d for one client) and keeps each slot's
arithmetic its own: per-slot ``eta`` and step counts, and a per-slot norm.

The port's counterpart of ``repro.core.local``.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from ..utils.pytree import tree_sub, tree_zeros_like


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
    {0,1} ``mask``, the client's step size ``eta``, the server ``momentum``
    tree the round handed down (the mvr opt's gradient estimate; zeros when
    the server opt keeps none), the server opt-state dict ``opt`` (read
    only; a transform declares the keys it reads in ``needs``), and the
    ``loss`` / ``grad`` of the loss at ``y`` on ``mb``.  In the cohort form
    ``x``, ``y``, ``mb``, ``loss`` and ``grad`` lead with the [C] slot axis
    and ``mask`` and ``eta`` are [C]; ``momentum`` and ``opt`` are shared."""

    x: Any
    y: Any
    mb: Any
    mask: Any
    eta: Any
    momentum: Any
    opt: Any
    loss: Any
    grad: Any


class RoundEnd(NamedTuple):
    """Round-end context for ``finalize`` / ``finalize_delta``: the
    round-start point ``x``, the final iterate ``y``, ``delta = y - x``, the
    realized step count ``steps`` (``mask.sum()``; 0 for a padding slot, so
    clamp before dividing), the step size ``eta`` and the server
    ``momentum`` / ``opt`` ([C] ``steps`` and ``eta`` in the cohort form)."""

    x: Any
    y: Any
    delta: Any
    steps: Any
    eta: Any
    momentum: Any
    opt: Any


class ClientTransform(NamedTuple):
    """One link of a local-update chain.

    ``init(params) -> carry`` builds the per-round carry (a dict of tensors,
    ``{}`` if none); ``update(step: StepCtx, d, carry, cstate) -> (d',
    carry')`` maps the fp32 descent direction (``cstate`` is the client's
    persistent state, None for a stateless transform).  Persistent
    per-client state: ``client_init(params)`` returns one client's state
    template (the round step banks it ``[N+1, ...]``) and ``finalize(end:
    RoundEnd, carry, cstate) -> cstate'`` commits the round's update.
    ``finalize_delta(end: RoundEnd, delta) -> delta'`` rewrites the shipped
    update after the local steps (``end.delta`` stays the raw one; hooks
    apply in chain order).  ``needs`` lists the server opt-state keys /
    capability tags the transform reads (``bind_strategy`` refuses server
    opts that do not provide them)."""

    name: str
    init: Callable
    update: Callable
    client_init: Callable | None = None
    finalize: Callable | None = None
    needs: tuple = ()
    finalize_delta: Callable | None = None


class ClientChain(NamedTuple):
    """A declared local-update rule: a named composition of transforms,
    registry names (resolved through :data:`CLIENT_TRANSFORMS` at bind time)
    and/or factories ``make(loss_fn, fl) -> ClientTransform``.  The empty
    chain is plain RR-SGD."""

    name: str
    transforms: tuple = ()


# name -> make(loss_fn, fl) -> ClientTransform
CLIENT_TRANSFORMS: dict[str, Callable] = {}


def register_client_transform(name: str, make: Callable, *, overwrite: bool = False) -> None:
    """Register ``make(loss_fn, fl) -> ClientTransform`` under ``name``."""
    if not overwrite and name in CLIENT_TRANSFORMS:
        raise ValueError(
            f"client transform {name!r} already registered (pass overwrite=True to replace)")
    CLIENT_TRANSFORMS[name] = make


def resolve_chain(chain: ClientChain, loss_fn: Callable, fl) -> tuple:
    """Instantiate a chain's transforms against (loss_fn, fl)."""
    out = []
    for t in chain.transforms:
        if isinstance(t, str):
            if t not in CLIENT_TRANSFORMS:
                raise ValueError(
                    f"local update {chain.name!r}: unknown client transform "
                    f"{t!r}; have {sorted(CLIENT_TRANSFORMS)}")
            t = CLIENT_TRANSFORMS[t]
        out.append(t(loss_fn, fl))
    names = [t.name for t in out if t.client_init is not None]
    if len(names) != len(set(names)):
        raise ValueError(
            f"local update {chain.name!r}: stateful transforms must have "
            f"unique names (the name keys the client state bank), got {names}")
    return tuple(out)


def chain_client_template(transforms: tuple) -> Callable | None:
    """``params -> {transform name: one client's persistent state}`` for the
    stateful links of a resolved chain, or None when the chain is stateless."""
    stateful = [t for t in transforms if t.client_init is not None]
    if not stateful:
        return None

    def template(params):
        return {t.name: t.client_init(params) for t in stateful}

    return template


def _round_end(transforms: tuple, carries: list, cstate: dict, end_fn: Callable, delta):
    """The chain's round end: each stateful link's ``finalize``, then the
    ``finalize_delta`` hooks in chain order; ``end_fn()`` builds the
    RoundEnd, only when a link needs it (a chain with neither adds no op)."""
    stateful = any(t.client_init is not None for t in transforms)
    shippers = [t for t in transforms if t.finalize_delta is not None]
    if not (stateful or shippers):
        return delta, cstate
    end = end_fn(delta)
    new_cstate = dict(cstate)
    for t, c in zip(transforms, carries):
        if t.client_init is not None:
            new_cstate[t.name] = t.finalize(end, c, cstate[t.name])
    for t in shippers:
        delta = t.finalize_delta(end, delta)
    return delta, new_cstate


def build_local_step(transforms: tuple, loss_fn: Callable) -> Callable:
    """Compile a resolved transform chain into the per-client local update

        one_client(params, momentum, opt, data, step_mask, eta, cstate)
            -> (delta, loss, cstate')

    For the empty chain this is bitwise :func:`local_sgd`; for the ``mvr``
    transform, :func:`local_mvr`.  ``cstate`` maps the stateful transforms'
    names to this client's persistent state (``{}`` for a stateless chain).
    """

    def one_client(params, momentum, opt, data, step_mask, eta, cstate):
        y, losses = params, []
        carries = [t.init(params) for t in transforms]
        for k in range(step_mask.shape[0]):
            m = step_mask[k]
            mb = _step_batch(data, k)
            loss, g = value_and_grad(loss_fn, y, mb)
            d = {n: v.float() for n, v in g.items()}
            ctx = StepCtx(x=params, y=y, mb=mb, mask=m, eta=eta, momentum=momentum, opt=opt,
                          loss=loss, grad=g)
            for i, t in enumerate(transforms):
                cs = cstate.get(t.name) if t.client_init is not None else None
                d, new = t.update(ctx, d, carries[i], cs)
                # a masked step must be an exact no-op for carry state too
                carries[i] = {n: torch.where(m > 0, new[n], c) for n, c in carries[i].items()}
            s = eta * m
            y = {n: (p.float() - s * d[n]).to(p.dtype) for n, p in y.items()}
            losses.append(loss * m)
        denom = torch.clamp_min(step_mask.sum(), 1.0)
        delta, cstate = _round_end(
            transforms, carries, cstate,
            lambda dl: RoundEnd(x=params, y=y, delta=dl, steps=step_mask.sum(), eta=eta,
                                momentum=momentum, opt=opt), tree_sub(y, params))
        return delta, _sum_steps(losses) / denom, cstate

    return one_client


# ---------------------------------------------------------------------------
# Built-in transforms (factories: make(loss_fn, fl) -> ClientTransform).
# Each serves both forms: one client's 0-d mask and eta, or the cohort's [C].
# ---------------------------------------------------------------------------


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

    def update(step: StepCtx, d, carry, cstate):
        gx = grad(loss_fn, step.x, step.mb)
        d = {n: dl + (1.0 - a) * (step.momentum[n].float() - gx[n].float())
             for n, dl in d.items()}
        return d, carry

    return ClientTransform(name="mvr", init=lambda params: {}, update=update,
                           needs=("grad_estimate",))


def scaffold_transform(loss_fn: Callable, fl) -> ClientTransform:
    """SCAFFOLD control variates under client sampling (Karimireddy et al.
    2020).  Per step ``d' = d + (c - c_i)`` with ``c_i`` the client's
    persistent control variate (the state bank) and ``c = opt['c']`` the
    server's; at round end (option II) ``c_i+ = c_i - c + (x - y) / (K_i *
    eta_i)``, each slot with its own realized K_i and eta_i.  The paired
    ``scaffold`` server opt folds the cohort's ``c_i`` deltas into ``c``."""

    def client_init(params):
        return {"c": tree_zeros_like(params)}

    def update(step: StepCtx, d, carry, cstate):
        d = {n: dl + (step.opt["c"][n].float() - cstate["c"][n].float())
             for n, dl in d.items()}
        return d, carry

    def finalize(end: RoundEnd, carry, cstate):
        ke = torch.clamp_min(end.steps, 1.0) * end.eta
        # c_i+ = c_i - c + (x - y)/(K eta)  and  x - y = -delta
        return {"c": {n: (ci.float() - end.opt["c"][n].float()
                          - end.delta[n].float() / _per_slot(ke, ci)).to(ci.dtype)
                      for n, ci in cstate["c"].items()}}

    return ClientTransform(name="scaffold", init=lambda params: {}, update=update,
                           client_init=client_init, finalize=finalize, needs=("c",))


def prox_transform(loss_fn: Callable, fl) -> ClientTransform:
    """FedProx proximal term (Li et al. 2020): ``d' = d + mu * (y - x)``."""
    mu = fl.prox_mu
    if not mu > 0:
        raise ValueError(
            f"local update 'fedprox' needs fl.prox_mu > 0 (the proximal "
            f"coefficient), got {mu!r}")

    def update(step: StepCtx, d, carry, cstate):
        d = {n: dl + mu * (step.y[n].float() - step.x[n].float()) for n, dl in d.items()}
        return d, carry

    return ClientTransform(name="prox", init=lambda params: {}, update=update)


def _sq_norm(d: dict, cohort: bool) -> torch.Tensor:
    """The squared global norm of a direction tree: one client's (0-d), or
    each slot's over all of its leaves ([C]).  A slot's sums run over its own
    rows, one reduction a leaf as for a single client, so they do not depend
    on how many slots the batch holds."""
    if not cohort:
        return sum(torch.sum(x * x) for x in d.values())
    C = next(iter(d.values())).shape[0]
    return torch.stack([sum(torch.sum(x[c] * x[c]) for x in d.values()) for c in range(C)])


def clip_transform(loss_fn: Callable, fl) -> ClientTransform:
    """Per-step global-norm clip of the descent direction to
    ``fl.clip_norm``, each client by its own norm; composable after any
    direction-producing transform."""
    limit = fl.clip_norm
    if not limit > 0:
        raise ValueError(
            f"local update 'local_clip' needs fl.clip_norm > 0 (the per-step "
            f"direction-norm bound), got {limit!r}")

    def update(step: StepCtx, d, carry, cstate):
        nrm = torch.sqrt(_sq_norm(d, step.mask.dim() > 0))
        scale = torch.clamp_max(limit / torch.clamp_min(nrm, 1e-12), 1.0)
        return {n: x * _per_slot(scale, x) for n, x in d.items()}, carry

    return ClientTransform(name="clip", init=lambda params: {}, update=update)


for _name, _make in (("mvr", mvr_transform), ("scaffold", scaffold_transform),
                     ("prox", prox_transform), ("clip", clip_transform)):
    register_client_transform(_name, _make)


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
    """A [C] vector shaped to broadcast over ``like``'s [C, ...] slots (a 0-d
    one, a single client's, as it is)."""
    return v if v.dim() == 0 else v.view(-1, *([1] * (like.dim() - 1)))


def _cohort_start(params: dict, C: int, stacked: bool) -> dict:
    # a shared tree as its stride-0 [C] broadcast (a view: no copy)
    return params if stacked else {n: v.expand(C, *v.shape) for n, v in params.items()}


def build_cohort_step(transforms: tuple, loss_fn: Callable) -> Callable:
    """The local update of a transform chain for the whole cohort at once:

        cohort(params, momentum, opt, data, step_mask, eta, cstate, *,
               stacked=False) -> (deltas [C, ...], losses [C], cstate')

    ``data`` leaves are [C, K, B, ...], ``step_mask`` [C, K], ``eta`` [C]
    and the ``cstate`` leaves [C, ...] (the cohort's rows of the stateful
    transforms' bank; ``{}`` for a stateless chain).  ``params`` is the one
    tree every client starts from or, with ``stacked``, a [C, ...] tree of
    per-slot start points; ``momentum`` and ``opt`` are the server's trees
    every slot sees.  ``loss_fn`` is the per-client loss; ``transforms``
    must be resolved over :func:`cohort_loss` of it, because their StepCtx
    carries the leading [C] axis.  Every slot follows
    :func:`build_local_step`'s update rule element for element."""
    closs = cohort_loss(loss_fn)

    def value_and_grads(y, mb):
        # value_and_grad of the summed cohort loss, keeping the losses [C]
        leaves = {k: v.detach().requires_grad_(True) for k, v in y.items()}
        with torch.enable_grad():
            total, losses = closs(leaves, mb)
            grads = torch.autograd.grad(total, list(leaves.values()))
        return losses.detach(), dict(zip(leaves, grads))

    def cohort(params, momentum, opt, data, step_mask, eta, cstate, *, stacked=False):
        x = _cohort_start(params, step_mask.shape[0], stacked)
        y, losses = x, []
        carries = [t.init(x) for t in transforms]
        for k in range(step_mask.shape[1]):
            m = step_mask[:, k]
            mb = {n: v[:, k] for n, v in data.items()}
            loss, g = value_and_grads(y, mb)
            d = {n: v.float() for n, v in g.items()}
            ctx = StepCtx(x=x, y=y, mb=mb, mask=m, eta=eta, momentum=momentum, opt=opt,
                          loss=loss, grad=g)
            for i, t in enumerate(transforms):
                cs = cstate.get(t.name) if t.client_init is not None else None
                d, new = t.update(ctx, d, carries[i], cs)
                # a masked step must be an exact no-op for carry state too
                carries[i] = {n: torch.where(_per_slot(m, c) > 0, new[n], c)
                              for n, c in carries[i].items()}
            s = eta * m
            y = {n: (p.float() - _per_slot(s, p) * d[n]).to(p.dtype) for n, p in y.items()}
            losses.append(loss * m)
        denom = torch.clamp_min(step_mask.sum(1), 1.0)
        deltas, cstate = _round_end(
            transforms, carries, cstate,
            lambda dl: RoundEnd(x=x, y=y, delta=dl, steps=step_mask.sum(1), eta=eta,
                                momentum=momentum, opt=opt), tree_sub(y, x))
        return deltas, _sum_steps(losses) / denom, cstate

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
