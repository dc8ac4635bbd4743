"""The federated round step — a thin driver over a bound FedStrategy.

``build_round_step(loss_fn, strategy, fl, num_clients, plane=, device=)``
returns

    round_step(state: ServerState, batch, lr_mult) -> (ServerState, metrics)

The driver owns only cohort execution; local step sizes, aggregation
coefficients and the server optimizer come from the bound strategy hooks
(``repro_torch.fed.strategy``).  Two cohort modes (``fl.cohort_mode``), the
JAX package's, compute the same math

    Delta = sum_i coeff_i * (y_i - x),   coeff_i = valid_i * w~_i / q_i^S
    x    <- x + eta_g * Delta            (+ server optimizer state)

with per-client local steps y <- y - (eta_l / c_i) * g over the masked RR
stream:

* ``vmapped`` (the default) — the cohort's clients run their local steps
  together, one batch over a leading ``[C]`` axis (the strategy's
  ``cohort_step``: each step's kernels are issued once for the cohort), and
  the stacked deltas are aggregated by the strategy's ``aggregate`` hook
  (``weighted_sum``, an fp32 einsum over the client axis).
* ``sequential`` — a Python loop over the slots, each client on the whole
  device, accumulating ``coeff_i * Delta_i`` in slot order into an
  ``fl.accum_dtype`` accumulator (the only mode that reads it).

The step consumes either a ``RoundBatch`` (legacy host assembly) or, when
built with ``plane=`` (a cohort-engine ``DevicePlane``), an ``IndexPlan`` —
indices and scalars only — which the plane materializes on the device by
gathering its resident bank (and, for the device RR backends, regenerating
the reshuffling streams there).  Host (numpy) inputs are moved to the step's
device first.

With a non-identity uplink codec (``fl.uplink``; ``repro_torch.fed.comm``)
the codec runs once on the slot-order ``[C]`` stack of deltas (one launch of
each quantize kernel per wire leaf): the sequential loop stages the stack
and accumulates the decoded deltas in slot order by the same rule; the
vmapped mode's stack is its batched output.  With a non-identity downlink
codec (``fl.downlink``) each slot's round-start params are reconstructed
from its banked reference before the cohort runs, ``ref_i +
decode(encode(x - ref_i))``, and each client trains from, and measures its
update against, its own reconstruction.  EF residuals, DIANA shifts and the
downlink references live in the per-client bank (``ServerState.clients``):
the cohort's rows are gathered at ``ids = where(valid, client_id, N)`` and
committed back masked (padding slots write what they read).  Unlike the JAX
package, which returns a new bank, the commit updates the bank in place
(15.1 GB at CharLM-100M's 32 clients; a copy would double it), so a state
passed to a round step must not be used again.  ``identity`` in both
directions keeps the plane-off op sequence: no staging, no bank, no new
metric keys.  The port's counterpart of ``repro.fed.rounds`` with the
fleet, robust, privacy and obs planes off and the padded execution mode.

The server optimizer's momentum tree (``state.opt["m"]``, zeros when the
optimizer keeps none) rides down to every client's local steps, and the
server update gets a ``RoundCtx`` (batch, ``lr_mult``, momentum):
FedShuffleMVR's corrected steps and its server step read them.  With a
codec, MVR consumes the decoded aggregate.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..configs.base import FLConfig
from ..data.federated import ClientMeta, IndexPlan, RoundBatch
from ..utils.device import resolve_device
from ..utils.pytree import tree_map, tree_sq_norm, tree_zeros_like
from .comm import (DOWNLINK_STATE_KEY, UPLINK_STATE_KEY, dense_bits, downlink_apply,
                   downlink_round_keys, round_keys, uplink_apply, wire_bits_total)
from .server import ServerState
from .strategy import BoundStrategy, FedStrategy, RoundCtx, bind_strategy


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
    num_clients = strat.num_clients
    banked = strat.client_state is not None
    codec, down = strat.codec, strat.down_codec
    up_on = codec is not None and codec.name != "identity"
    dl_on = down is not None and down.name != "identity"
    apply_up = uplink_apply(codec) if up_on else None
    apply_down = downlink_apply(down) if dl_on else None

    def add_weighted(acc, delta, coeff_i):
        # THE accumulation rule: slot order, fp32 product, accumulator dtype
        return {k: (A + coeff_i * delta[k].float()).to(A.dtype) for k, A in acc.items()}

    def slot_keys(rule, keyfn, meta, rnd):
        # per-slot stream keys for codecs that draw random bits, zeros otherwise
        if rule.seeded:
            return keyfn(fl.seed, meta.client_id, rnd)
        return torch.zeros_like(meta.client_id)

    def uplink(deltas, new_cs, meta, rnd):
        # the codec on the slot-order [C] stack; EF state into the cohort's rows
        dhat, ef2 = apply_up(deltas, new_cs.get(UPLINK_STATE_KEY, {}),
                             slot_keys(codec, round_keys, meta, rnd))
        if codec.client_init is not None:
            new_cs = {**new_cs, UPLINK_STATE_KEY: ef2}
        return dhat, new_cs

    def run_sequential(state, batch, starts, eta, momentum, new_cs):
        """The slots one after another, accumulated in slot order."""
        meta = batch.meta
        C = meta.valid.shape[0]
        coeff = strat.agg_coeffs(meta)                                 # [C]
        acc = tree_zeros_like(state.params, dtype=acc_dt)
        if up_on:
            staged = {k: torch.empty((C, *v.shape), dtype=v.dtype, device=v.device)
                      for k, v in state.params.items()}
        losses = []
        for c in range(C):
            p_c = {k: v[c] for k, v in starts.items()} if dl_on else state.params
            delta, loss = strat.local_step(p_c, {k: v[c] for k, v in batch.data.items()},
                                           batch.step_mask[c], eta[c], momentum)
            if up_on:
                for k, v in delta.items():
                    staged[k][c] = v
            else:
                acc = add_weighted(acc, delta, coeff[c])
            losses.append(loss)
        if up_on:
            # the decoded deltas accumulated in slot order by the same rule
            dhat, new_cs = uplink(staged, new_cs, meta, state.rnd)
            del staged
            for c in range(C):
                acc = add_weighted(acc, {k: v[c] for k, v in dhat.items()}, coeff[c])
            del dhat
        delta_agg = {k: a.to(state.params[k].dtype) for k, a in acc.items()}
        return delta_agg, torch.stack(losses), new_cs

    def run_vmapped(state, batch, starts, eta, momentum, new_cs):
        """The slots' local steps batched over the cohort, then the strategy's
        aggregate of the (decoded) stack."""
        x = starts if dl_on else state.params
        deltas, losses = strat.cohort_step(x, batch.data, batch.step_mask, eta, momentum,
                                           stacked=dl_on)
        if up_on:
            deltas, new_cs = uplink(deltas, new_cs, batch.meta, state.rnd)
        return strat.aggregate(deltas, batch.meta), losses, new_cs

    run_cohort = run_vmapped if fl.cohort_mode == "vmapped" else run_sequential

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
        momentum = state.opt.get("m")
        if momentum is None:
            # zeros, as stride-0 views of one scalar: no chain that binds
            # under such an opt reads them (bind_strategy checks needs)
            zero = {dt: torch.zeros((), dtype=dt, device=device)
                    for dt in {v.dtype for v in state.params.values()}}
            momentum = {k: zero[v.dtype].expand_as(v) for k, v in state.params.items()}
        if banked:
            if state.clients is None:
                raise TypeError("round_step got a ServerState without the client state "
                                "bank its codecs keep; build it with the bound strategy's init()")
            # the cohort's bank rows; padding slots read (and write) the scratch row
            ids = torch.where(meta.valid > 0, meta.client_id, num_clients)
            cstate0 = tree_map(lambda b: b.index_select(0, ids), state.clients)
        else:
            cstate0 = {}
        new_cs, starts = cstate0, None
        if dl_on:
            # each slot's round-start params, reconstructed once from its
            # reference before the cohort runs; committed as its next reference
            starts = apply_down(state.params, cstate0[DOWNLINK_STATE_KEY]["ref"],
                                slot_keys(down, downlink_round_keys, meta, state.rnd))
            new_cs = {**cstate0, DOWNLINK_STATE_KEY: {"ref": starts}}
        delta_agg, losses, new_cs = run_cohort(state, batch, starts, eta, momentum, new_cs)
        if banked:
            # masked commit: valid slots write their new rows, padding slots
            # what they read; then every slot scatters to its own row
            valid = meta.valid > 0

            def commit(bank, new, old):
                upd = torch.where(valid.view((-1,) + (1,) * (new.dim() - 1)), new, old)
                bank.index_copy_(0, ids, upd.to(bank.dtype))

            tree_map(commit, state.clients, new_cs, cstate0)
        params, bank = state.params, state.clients
        ctx = RoundCtx(batch=batch, lr_mult=lr_mult, momentum=momentum)
        state = strat.server_update(state, delta_agg, fl.server_lr, ctx)
        if banked:
            state = state._replace(clients=bank)
        valid_sum = torch.clamp_min(meta.valid.sum(), 1.0)
        metrics = {
            "local_loss": (losses * meta.valid).sum() / valid_sum,
            "delta_norm": torch.sqrt(tree_sq_norm(delta_agg)),
            "cohort": meta.valid.sum(),
        }
        if up_on or dl_on:
            # bytes on the wire (static per client: every payload is
            # params-shaped); an identity direction pays its dense cost
            dense = dense_bits(params)
            up_bits = wire_bits_total(codec, params) if up_on else dense
            down_bits = wire_bits_total(down, params) if dl_on else dense
            n_valid = meta.valid.sum()
            if up_on:
                metrics["uplink_mbytes"] = n_valid * _f32(up_bits / 8e6)
                metrics["uplink_compression"] = torch.tensor(_f32(dense / up_bits))
            if dl_on:
                metrics["downlink_mbytes"] = n_valid * _f32(down_bits / 8e6)
                metrics["downlink_compression"] = torch.tensor(_f32(dense / down_bits))
            metrics["total_comm_mbytes"] = n_valid * _f32((up_bits + down_bits) / 8e6)
        return state, metrics

    return round_step


def _f32(x: float) -> float:
    """``x`` rounded to float32 (the JAX package's ``jnp.float32(x)``)."""
    return float(np.float32(x))
