"""Fault injection: dropout, stragglers, mid-round aborts (``FAULTS``).

A fault scenario is a pure vectorized rule over one round's cohort —
``fn(fl, fleet, ids, rnd, ctx: RoundFaults) -> RoundFaults`` — applied in
the order listed in ``fl.faults`` ("dropout,straggler,abort").  Randomized
faults draw their coins from the counter-based per-(seed, client, round)
fleet streams (:func:`~repro_torch.fed.fleet.model.fleet_uniform`), so a
fault realization is stateless: identical on the legacy host path, the
cohort engine's prefetch thread, and across checkpoint resumes.

Built-in scenarios:

* ``dropout``   — a client fails with probability ``fl.drop_prob`` and
  contributes nothing (its slot is masked out exactly like cohort padding).
* ``straggler`` — with probability ``fl.straggler_prob`` a client's round
  wall time is multiplied by ``fl.straggler_factor``.
* ``abort``     — a virtual-time round deadline ``fl.round_deadline``:
  clients run only the local steps that fit their tier's step rate within
  the budget (a *deterministic* per-client step cap, which the bucketed
  layout folds into its step buckets) and clients whose latency alone
  exceeds the deadline drop out.

The port's counterpart of ``repro.fed.fleet.faults`` (host numpy).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np

from ...configs.base import FLConfig
from .model import SUB_DROPOUT, SUB_STRAGGLER, FleetModel, fleet_uniform, parse_faults

_NO_CAP = np.int64(2**31 - 1)


class RoundFaults(NamedTuple):
    """One cohort's realized fault state (all [c], host numpy)."""

    wall: np.ndarray         # float64 virtual completion times
    dropped: np.ndarray      # bool — contributes nothing this round
    steps_cap: np.ndarray    # int64 realized-local-step cap (deadline cuts)


def _dropout(fl: FLConfig, fleet: FleetModel, ids, rnd, ctx: RoundFaults) -> RoundFaults:
    coin = fleet_uniform(fl.seed, ids, rnd, SUB_DROPOUT)
    return ctx._replace(dropped=ctx.dropped | (coin < fl.drop_prob))


def _straggler(fl: FLConfig, fleet: FleetModel, ids, rnd, ctx: RoundFaults) -> RoundFaults:
    coin = fleet_uniform(fl.seed, ids, rnd, SUB_STRAGGLER)
    wall = np.where(coin < fl.straggler_prob, ctx.wall * float(fl.straggler_factor), ctx.wall)
    return ctx._replace(wall=wall)


def _abort(fl: FLConfig, fleet: FleetModel, ids, rnd, ctx: RoundFaults) -> RoundFaults:
    ids = np.atleast_1d(np.asarray(ids)).astype(np.int64)
    cap = fleet.deadline_caps(fl.round_deadline)[ids]
    return RoundFaults(
        wall=np.minimum(ctx.wall, float(fl.round_deadline)),
        dropped=ctx.dropped | (cap < 1),
        steps_cap=np.minimum(ctx.steps_cap, np.maximum(cap, 1)),
    )


FAULTS: dict[str, Callable] = {
    "dropout": _dropout,
    "straggler": _straggler,
    "abort": _abort,
}


def register_fault(name: str, fn: Callable, *, overwrite: bool = False) -> None:
    """Register ``fn(fl, fleet, ids, rnd, ctx) -> RoundFaults`` under
    ``name`` (listable in ``FLConfig.faults``)."""
    if not overwrite and name in FAULTS:
        raise ValueError(
            f"fault scenario {name!r} already registered (pass overwrite=True to replace)")
    FAULTS[name] = fn


def apply_faults(fl: FLConfig, fleet: FleetModel, ids, rnd: int,
                 planned_steps) -> RoundFaults:
    """Base tier wall times + the configured fault scenarios, in order.

    ``planned_steps`` are the clients' planned local step counts; the
    returned ``steps_cap`` bounds what they actually realize (deadline
    aborts), ``wall`` their virtual completion times, ``dropped`` who
    contributes nothing."""
    ids = np.atleast_1d(np.asarray(ids)).astype(np.int64)
    ctx = RoundFaults(wall=fleet.wall_time(ids, planned_steps),
                      dropped=np.zeros(len(ids), bool),
                      steps_cap=np.full(len(ids), _NO_CAP))
    for name in parse_faults(fl.faults):
        ctx = FAULTS[name](fl, fleet, ids, rnd, ctx)
    return ctx


def validate_faults(fl: FLConfig) -> None:
    """Bind-time validation of ``fl.faults`` and the knobs each uses."""
    active = parse_faults(fl.faults)
    for name in active:
        if name not in FAULTS:
            raise ValueError(
                f"unknown fault scenario {name!r} in fl.faults; have {sorted(FAULTS)}")
    if "dropout" in active and not 0.0 < fl.drop_prob < 1.0:
        raise ValueError(f"fault 'dropout' needs 0 < fl.drop_prob < 1, got {fl.drop_prob}")
    if "straggler" in active:
        if not 0.0 < fl.straggler_prob <= 1.0:
            raise ValueError(
                f"fault 'straggler' needs 0 < fl.straggler_prob <= 1, got {fl.straggler_prob}")
        if fl.straggler_factor < 1.0:
            raise ValueError(f"fl.straggler_factor must be >= 1, got {fl.straggler_factor}")
    if "abort" in active and fl.round_deadline <= 0.0:
        raise ValueError(
            f"fault 'abort' needs fl.round_deadline > 0, got {fl.round_deadline}")
