"""The federated round step — a thin driver over a bound FedStrategy.

``build_round_step(loss_fn, strategy, fl, num_clients, plane=, device=)``
returns

    round_step(state: ServerState, batch, lr_mult) -> (ServerState, metrics)

The driver owns only cohort execution; local step sizes, aggregation
coefficients and the server optimizer come from the bound strategy hooks
(``repro_torch.fed.strategy``).  The cohort runs ``sequential``: a Python loop
over the slots, each client on the whole device, accumulating

    Delta = sum_i coeff_i * (y_i - x),   coeff_i = valid_i * w~_i / q_i^S
    x    <- x + eta_g * Delta            (+ server optimizer state)

in slot order into an ``fl.accum_dtype`` accumulator, with per-client local
steps y <- y - (eta_l / c_i) * g over the masked RR stream.

The step consumes either a ``RoundBatch`` (legacy host assembly) or, when
built with ``plane=`` (a cohort-engine ``DevicePlane``), an ``IndexPlan`` —
indices and scalars only — which the plane materializes on the device by
gathering its resident bank (and, for the device RR backends, regenerating
the reshuffling streams there).  Host (numpy) inputs are moved to the step's
device first.  The port's counterpart of ``repro.fed.rounds`` with every
plane off; the ``vmapped`` cohort mode is not ported yet.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..configs.base import FLConfig
from ..data.federated import ClientMeta, IndexPlan, RoundBatch
from ..utils.device import resolve_device
from ..utils.pytree import tree_sq_norm, tree_zeros_like
from .server import ServerState
from .strategy import BoundStrategy, FedStrategy, bind_strategy


def to_device(x, device, dtype: torch.dtype | None = None) -> torch.Tensor:
    """A numpy array or tensor as a tensor on ``device`` (no copy when it is
    one there already)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)


def as_device_meta(meta: ClientMeta, device) -> ClientMeta:
    """ClientMeta -> device tensors: float32 scalars, int64 client ids.

    The single definition of the meta dtype policy — ``as_device_batch``
    (legacy path) and ``cohort.plan.as_device_plan`` (engine path) both use
    it, which keeps the two paths bitwise-interchangeable."""
    return ClientMeta(*[
        to_device(a, device, torch.int64 if name == "client_id" else torch.float32)
        for name, a in zip(ClientMeta._fields, meta)])


def as_device_batch(rb: RoundBatch, device) -> RoundBatch:
    """Host RoundBatch (numpy) -> tensors on ``device``, float32 meta."""
    return RoundBatch(
        data={k: to_device(v, device) for k, v in rb.data.items()},
        step_mask=to_device(rb.step_mask, device, torch.float32),
        meta=as_device_meta(rb.meta, device),
    )


def build_round_step(loss_fn: Callable,
                     strategy: "FedStrategy | BoundStrategy | None" = None,
                     fl: FLConfig | None = None, num_clients: int | None = None,
                     *, plane=None, device=None) -> Callable:
    """The round step over ``device`` (``cuda`` unless given; see
    ``utils.device.resolve_device``)."""
    device = resolve_device(device)
    if not isinstance(strategy, BoundStrategy):
        if fl is None:
            raise TypeError("build_round_step needs an FLConfig (fl=...)")
        if num_clients is None:
            num_clients = fl.num_clients
    strat = bind_strategy(strategy, fl, loss_fn, num_clients=num_clients)
    fl = strat.fl
    if plane is not None and plane.device != device:
        raise ValueError(f"the plane's bank lives on {plane.device}, the step runs on {device}")
    acc_dt = getattr(torch, fl.accum_dtype)

    @torch.no_grad()
    def round_step(state: ServerState, batch, lr_mult=1.0):
        if isinstance(batch, IndexPlan):
            # cohort-engine path: materialize on the device through the
            # resident bank (device RR backends regenerate the indices here)
            if plane is None:
                raise TypeError(
                    "round_step received an index plan but build_round_step was "
                    "called without plane=; pass the engine's DevicePlane")
            from .cohort.plan import as_device_plan  # deferred: cohort imports rounds

            batch = plane.materialize(as_device_plan(batch, device))
        else:
            batch = as_device_batch(batch, device)
        meta = batch.meta
        lr_mult = to_device(lr_mult, device, torch.float32)
        eta = strat.client_transform(meta, lr_mult)                   # [C]
        coeff = strat.agg_coeffs(meta)                                 # [C]
        acc = tree_zeros_like(state.params, dtype=acc_dt)
        losses = []
        for c in range(meta.valid.shape[0]):
            delta, loss = strat.local_step(state.params,
                                           {k: v[c] for k, v in batch.data.items()},
                                           batch.step_mask[c], eta[c])
            # THE accumulation rule: slot order, fp32 product, accumulator dtype
            acc = {k: (A + coeff[c] * delta[k].float()).to(A.dtype) for k, A in acc.items()}
            losses.append(loss)
        delta_agg = {k: a.to(state.params[k].dtype) for k, a in acc.items()}
        state = strat.server_update(state, delta_agg, fl.server_lr)
        valid_sum = torch.clamp_min(meta.valid.sum(), 1.0)
        metrics = {
            "local_loss": (torch.stack(losses) * meta.valid).sum() / valid_sum,
            "delta_norm": torch.sqrt(tree_sq_norm(delta_agg)),
            "cohort": meta.valid.sum(),
        }
        return state, metrics

    return round_step
