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

Under ``fl.exec_mode="bucketed"`` the step takes a ``BucketedBatch`` (or,
through the plane, a ``BucketedPlan``): the cohort's slots partitioned into
step buckets, each run over its occupied rows for its K_b steps only
(``fed.bucketing``).  The vmapped mode runs ``cohort_step`` once a bucket
and reassembles the deltas and losses into the zero-filled slot-order [C]
stack the padded layout computes; the sequential mode keeps its slot-order
loop, slot c running its bucket's row, and a slot no bucket holds adds a
zero delta and loss, as a fully masked slot computes.  Everything after the
local steps (codecs, aggregation, bank commit, server step) sees the same
[C] stacks in both layouts, so bucketed rounds equal padded ones bitwise
wherever the per-slot local steps do.

With a non-identity uplink codec (``fl.uplink``; ``repro_torch.fed.comm``)
the codec runs once on the slot-order ``[C]`` stack of deltas (one launch of
each quantize kernel per wire leaf): the sequential loop stages the stack
and accumulates the decoded deltas in slot order by the same rule; the
vmapped mode's stack is its batched output.  With a non-identity downlink
codec (``fl.downlink``) each slot's round-start params are reconstructed
from its banked reference before the cohort runs, ``ref_i +
decode(encode(x - ref_i))``, and each client trains from, and measures its
update against, its own reconstruction.  The local chain's persistent
per-client state (SCAFFOLD's control variates, under the transform's name),
EF residuals, DIANA shifts and the downlink references live in the
per-client bank (``ServerState.clients``): the cohort's rows are gathered at
``ids = where(valid, client_id, N)``, the chain's rows ride through the
local steps (each bucket takes its slots' rows), and everything is
committed back masked (padding slots, and slots no bucket holds, write what
they read).  Unlike the JAX
package, which returns a new bank, the commit updates the bank in place
(15.1 GB at CharLM-100M's 32 clients; a copy would double it), so a state
passed to a round step must not be used again.  ``identity`` in both
directions keeps the plane-off op sequence: no staging, no bank, no new
metric keys.

The fleet plane (``repro_torch.fed.fleet``) lives in the host plan (fault
cuts, dropped slots, the buffered server's ticks as cohorts); the step adds
the buffered server's per-client counters (bank key ``"fleet"``, bumped
before the masked commit) and, while the plane is on, the metric keys
``round_virtual_time``, ``arrived_clients``, ``dropped_clients`` and
``mean_staleness``.  The robust plane (``repro_torch.fed.robust``) runs on
the slot-order [C] stack: the attack before the uplink codec, then
quarantine, coefficient renormalization, scrub and the bound aggregator
(``robust_combine``), and the reject guard after the server update (a
rejected round keeps its input's params, opt and bank rows; ``rnd``
advances); its keys are ``quarantined_clients``, ``suspected_adversaries``
and ``rounds_rejected``.  While the robust plane is on the sequential mode
stages its deltas, as it does for a codec.  The port's counterpart of
``repro.fed.rounds`` with the privacy and obs planes off.

The server optimizer's momentum tree (``state.opt["m"]``, zeros when the
optimizer keeps none) and its whole opt-state dict ride down to every
client's local steps, and the server update gets a ``RoundCtx`` (batch,
``lr_mult``, momentum, and with a bank the cohort's ``CohortState``: the
rows gathered and the rows committed): FedShuffleMVR's corrected steps and
its server step, SCAFFOLD's steps and its control-variate fold read them.
With a codec, MVR consumes the decoded aggregate.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..configs.base import FLConfig
from ..data.federated import (Bucket, BucketedBatch, BucketedPlan, ClientMeta, IndexPlan,
                              RoundBatch)
from ..utils.device import resolve_device
from ..utils.pytree import tree_map, tree_sq_norm, tree_zeros_like
from .bucketing import occupied, run_buckets, slot_inputs
from .comm import (DOWNLINK_STATE_KEY, UPLINK_STATE_KEY, dense_bits, downlink_apply,
                   downlink_round_keys, round_keys, uplink_apply, wire_bits_total)
from .fleet import FLEET_STATE_KEY, fleet_active, slot_staleness
from .robust import (build_attack, guard_quarantines, guard_rejects, params_ok,
                     quarantine_masks, renormalize_coeffs, robust_active, scrub_deltas,
                     select_state)
from .server import ServerState
from .strategy import (BoundStrategy, CohortState, FedStrategy, RoundCtx, bind_strategy,
                       weighted_sum)


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
        None if a is None
        else to_device(a, device, torch.int64 if name == "client_id" else torch.float32)
        for name, a in zip(ClientMeta._fields, meta)])


def as_device_buckets(buckets: tuple, pos, device) -> tuple[tuple, np.ndarray]:
    """A host bucket layout's occupied rows (``bucketing.occupied``) as
    tensors on ``device``: int32 indices, float32 masks, int64 slots.  The
    re-based ``pos`` stays on the host."""
    kept, pos = occupied(buckets, pos)
    return tuple(
        Bucket(data=None if b.data is None else {k: to_device(v, device) for k, v in b.data.items()},
               idx=None if b.idx is None else to_device(b.idx, device, torch.int32),
               step_mask=to_device(b.step_mask, device, torch.float32),
               slots=to_device(b.slots, device, torch.int64))
        for b in kept), pos


def as_device_batch(rb: "RoundBatch | BucketedBatch", device) -> "RoundBatch | BucketedBatch":
    """Host RoundBatch / BucketedBatch (numpy) -> tensors on ``device``,
    float32 meta; a bucketed batch moves its buckets' occupied rows only."""
    if isinstance(rb, BucketedBatch):
        buckets, pos = as_device_buckets(rb.buckets, rb.pos, device)
        return BucketedBatch(buckets=buckets, meta=as_device_meta(rb.meta, device), pos=pos)
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
    chain_keys = strat.chain_state      # the bank keys the local chain reads and writes
    codec, down = strat.codec, strat.down_codec
    up_on = codec is not None and codec.name != "identity"
    dl_on = down is not None and down.name != "identity"
    apply_up = uplink_apply(codec) if up_on else None
    apply_down = downlink_apply(down) if dl_on else None
    fleet_on = fleet_active(fl)
    # robust plane: the attack on the stack before encode (adversaries
    # control their wire payload), quarantine and the robust combiner after
    # decode, the reject guard after the server step; off, no op is added
    robust_on = robust_active(fl)
    apply_attack = build_attack(fl) if robust_on else None
    g_quar = robust_on and guard_quarantines(fl)
    g_rej = robust_on and guard_rejects(fl)
    # the sequential mode stages the [C] stack for whatever runs on it
    staged_seq = up_on or robust_on

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

    def robust_combine(deltas, meta):
        """The decoded slot-order stack under the robust plane: quarantine
        -> coefficient renormalization -> scrub -> the bound aggregator."""
        coeff = strat.agg_coeffs(meta)                                 # [C]
        zero = meta.valid.new_zeros(())
        info = {"quarantined_clients": zero, "suspected_adversaries": zero}
        if g_quar:
            healthy, suspected = quarantine_masks(deltas, meta)
            info["quarantined_clients"] = (meta.valid * (1.0 - healthy)).sum()
            info["suspected_adversaries"] = suspected.sum()
            coeff = renormalize_coeffs(coeff, healthy)
            # zero the quarantined slots' values too: a zeroed coefficient
            # alone would leak NaN/Inf through sorted estimators (0 * nan)
            deltas = scrub_deltas(deltas, healthy)
        combine = strat.robust_aggregate
        if combine is None:           # hand-built strategy: canonical mean
            return weighted_sum(deltas, coeff), info
        return combine(deltas, coeff, meta), info

    def after_local(deltas, new_cs, meta, rnd):
        """The [C] stack from the local steps to the aggregate: the attack,
        the uplink codec, then the robust combiner (robust plane on; else
        None, and the caller aggregates)."""
        if apply_attack is not None:
            deltas = apply_attack(deltas, meta, rnd)
        if up_on:
            deltas, new_cs = uplink(deltas, new_cs, meta, rnd)
        if robust_on:
            return deltas, new_cs, robust_combine(deltas, meta)
        return deltas, new_cs, None

    def run_sequential(state, batch, starts, eta, momentum, new_cs):
        """The slots one after another, accumulated in slot order."""
        meta = batch.meta
        C = meta.valid.shape[0]
        coeff = strat.agg_coeffs(meta)                                 # [C]
        acc = tree_zeros_like(state.params, dtype=acc_dt)
        if staged_seq:
            staged = {k: torch.empty((C, *v.shape), dtype=v.dtype, device=v.device)
                      for k, v in state.params.items()}
        # the chain's state rows: a slot's finalized row, or (a slot no
        # bucket holds) the row it read, which the masked commit keeps
        cs_in = {k: new_cs[k] for k in chain_keys}
        cs_out = tree_map(torch.clone, cs_in)
        losses = []
        for c, inputs in enumerate(slot_inputs(batch)):
            if inputs is None:
                # a slot no bucket holds: the zero delta and loss of a fully
                # masked slot (its coefficient is 0 and acc + 0 is acc)
                if staged_seq:
                    for v in staged.values():
                        v[c].zero_()
                losses.append(meta.valid.new_zeros(()))
                continue
            data, mask = inputs
            p_c = {k: v[c] for k, v in starts.items()} if dl_on else state.params
            delta, loss, cs_c = strat.local_step(p_c, momentum, state.opt, data, mask, eta[c],
                                                 tree_map(lambda t: t[c], cs_in))
            tree_map(lambda o, t: o[c].copy_(t), cs_out, {k: cs_c[k] for k in chain_keys})
            if staged_seq:
                for k, v in delta.items():
                    staged[k][c] = v
            else:
                acc = add_weighted(acc, delta, coeff[c])
            losses.append(loss)
        new_cs = {**new_cs, **cs_out}
        losses = torch.stack(losses)
        if staged_seq:
            dhat, new_cs, combined = after_local(staged, new_cs, meta, state.rnd)
            del staged
            if combined is not None:
                return combined[0], losses, new_cs, combined[1]
            # the decoded deltas accumulated in slot order by the same rule
            for c in range(C):
                acc = add_weighted(acc, {k: v[c] for k, v in dhat.items()}, coeff[c])
            del dhat
        delta_agg = {k: a.to(state.params[k].dtype) for k, a in acc.items()}
        return delta_agg, losses, new_cs, None

    def run_vmapped(state, batch, starts, eta, momentum, new_cs):
        """The slots' local steps batched over the cohort (a bucket at a time
        in the bucketed layout), then the strategy's aggregate of the
        (decoded) slot-order stack."""
        x = starts if dl_on else state.params
        cs_in = {k: new_cs[k] for k in chain_keys}
        if isinstance(batch, BucketedBatch):
            # each bucket takes its rows of eta, of the chain's state and,
            # with the downlink, of the per-slot start points; else every
            # slot starts from x
            def bucket_step(data, mask, eta_b, cs_b, x_b=x):
                return strat.cohort_step(x_b, momentum, state.opt, data, mask, eta_b, cs_b,
                                         stacked=dl_on)

            like = (state.params, batch.meta.valid[0], tree_map(lambda t: t[0], cs_in))
            deltas, losses, cs_out = run_buckets(bucket_step, batch, like, eta, cs_in,
                                                 *((x,) if dl_on else ()))
        else:
            deltas, losses, cs_out = strat.cohort_step(x, momentum, state.opt, batch.data,
                                                       batch.step_mask, eta, cs_in,
                                                       stacked=dl_on)
        new_cs = {**new_cs, **{k: cs_out[k] for k in chain_keys}}
        deltas, new_cs, combined = after_local(deltas, new_cs, batch.meta, state.rnd)
        if combined is not None:
            return combined[0], losses, new_cs, combined[1]
        return strat.aggregate(deltas, batch.meta), losses, new_cs, None

    run_cohort = run_vmapped if fl.cohort_mode == "vmapped" else run_sequential

    @torch.no_grad()
    def round_step(state: ServerState, batch, lr_mult=1.0):
        if isinstance(batch, (IndexPlan, BucketedPlan)):
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
        # the reject guard reverts to the round's input: params and opt copied
        # here (the bank's rows are cstate0)
        prev = ServerState(params=tree_map(torch.clone, state.params),
                           opt=tree_map(torch.clone, state.opt), rnd=state.rnd) if g_rej else None
        delta_agg, losses, new_cs, rb_info = run_cohort(state, batch, starts, eta, momentum,
                                                        new_cs)
        cstate = None
        if banked and FLEET_STATE_KEY in new_cs:
            # buffered server bookkeeping: bump the cohort's arrival /
            # staleness counters before the masked commit, so padding slots
            # (and dropped clients) write back what they read
            fb = new_cs[FLEET_STATE_KEY]
            new_cs = {**new_cs, FLEET_STATE_KEY: {
                "arrivals": fb["arrivals"] + 1.0,
                "stale_sum": fb["stale_sum"] + slot_staleness(meta)}}
        if banked:
            # masked commit: valid slots write their new rows, padding slots
            # (and slots no bucket holds, whose rows read zeros) what they
            # read; then every slot scatters to its own row, in place
            valid = meta.valid > 0
            upd = tree_map(lambda new, old: torch.where(
                valid.view((-1,) + (1,) * (new.dim() - 1)), new, old), new_cs, cstate0)
            del new_cs
            tree_map(lambda bank, u: bank.index_copy_(0, ids, u.to(bank.dtype)),
                     state.clients, upd)
            cstate = CohortState(old=cstate0, new=upd)
        params, bank = state.params, state.clients
        ctx = RoundCtx(batch=batch, lr_mult=lr_mult, momentum=momentum, cstate=cstate)
        state = strat.server_update(state, delta_agg, fl.server_lr, ctx)
        if banked:
            state = state._replace(clients=bank)
        rejected = None
        if g_rej:
            # divergence guard: a blown round's params and opt revert, and
            # its committed rows are written back to what the round read
            ok = params_ok(prev.params, state.params)
            state = select_state(ok, state, prev)
            if banked:
                tree_map(lambda b, u, o: b.index_copy_(0, ids, torch.where(
                    ok, u, o).to(b.dtype)), bank, cstate.new, cstate.old)
            rejected = 1.0 - ok.to(torch.float32)
            del prev
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
        if fleet_on:
            # round_virtual_time: sync = the slowest surviving client's wall
            # time; buffered = the tick's span (the K-th arrival flushes it)
            zero = torch.zeros_like(meta.valid)
            arrive = zero if meta.arrive_time is None else meta.arrive_time
            dropped = zero if meta.dropped is None else meta.dropped
            metrics["round_virtual_time"] = torch.max(arrive * meta.valid)
            metrics["arrived_clients"] = meta.valid.sum()
            metrics["dropped_clients"] = dropped.sum()
            metrics["mean_staleness"] = (slot_staleness(meta) * meta.valid).sum() / valid_sum
        if robust_on:
            # the counts are 0 whenever their guard is off
            metrics["quarantined_clients"] = rb_info["quarantined_clients"]
            metrics["suspected_adversaries"] = rb_info["suspected_adversaries"]
            metrics["rounds_rejected"] = meta.valid.new_zeros(()) if rejected is None \
                else rejected
        return state, metrics

    return round_step


def _f32(x: float) -> float:
    """``x`` rounded to float32 (the JAX package's ``jnp.float32(x)``)."""
    return float(np.float32(x))
