"""Byzantine-robustness plane: adversarial clients, robust aggregators,
self-healing rounds.

Three layers (see the module docstrings):

* :mod:`~repro_torch.fed.robust.attacks`     — ATTACKS registry; adversary
  set drawn counter-based per (seed, client) through the rr_perm hash
  chain, attacks rewrite the slot-order [C] delta stack before the codec;
* :mod:`~repro_torch.fed.robust.aggregators` — ROBUST_AGGS registry (median
  / trimmed mean / clipping / krum), weight-aware over FedShuffle's bound
  aggregation coefficients and on the canonical ``weighted_sum`` scale;
* :mod:`~repro_torch.fed.robust.guards`      — per-client quarantine
  (NaN/Inf/norm spike, coefficient renormalization) and the server-level
  round-reject divergence guard.

With the default knobs (``attack="none"``, ``aggregator="mean"``,
``guard="off"``) the whole plane is off: the round driver adds no ops and
no metric keys.  The port's counterpart of ``repro.fed.robust``.
"""
from __future__ import annotations

from ...configs.base import FLConfig
from .aggregators import (ROBUST_AGGS, TRIM_PARAM_AGGS, build_robust_aggregate,
                          register_robust_agg)
from .attacks import ATTACKS, adversary_mask, attack_round_keys, build_attack, register_attack
from .guards import (GUARDS, guard_quarantines, guard_rejects, params_ok, quarantine_masks,
                     renormalize_coeffs, scrub_deltas, select_state, suspicion_ratio)


def robust_active(fl: FLConfig) -> bool:
    """Whether any robustness-plane machinery runs.  False is the frozen
    default: no extra round ops, no new metric keys, bitwise-identical
    rounds (the same contract as ``fleet_active``)."""
    return fl.attack != "none" or fl.aggregator != "mean" or fl.guard != "off"


def validate_robust_config(fl: FLConfig) -> None:
    """Bind-time validation of every robustness knob (unknown attack /
    aggregator / guard names and out-of-range fractions fail loudly here)."""
    if fl.attack != "none":
        if fl.attack not in ATTACKS:
            raise ValueError(f"unknown attack {fl.attack!r}; have {sorted(ATTACKS)}")
        if not 0.0 < fl.attack_frac < 1.0:
            raise ValueError(f"fl.attack_frac must be in (0, 1), got {fl.attack_frac}")
        if fl.attack_scale <= 0.0:
            raise ValueError(f"fl.attack_scale must be > 0, got {fl.attack_scale}")
    if fl.aggregator not in ROBUST_AGGS:
        raise ValueError(
            f"unknown aggregator {fl.aggregator!r}; have {sorted(ROBUST_AGGS)}")
    if fl.aggregator in TRIM_PARAM_AGGS and not 0.0 < fl.trim_frac < 0.5:
        raise ValueError(
            f"aggregator {fl.aggregator!r} needs fl.trim_frac in (0, 0.5) "
            f"(its breakdown/neighbor parameter), got {fl.trim_frac}")
    if fl.guard not in GUARDS:
        raise ValueError(f"unknown guard {fl.guard!r}; have {GUARDS}")


__all__ = ["ATTACKS", "GUARDS", "ROBUST_AGGS", "TRIM_PARAM_AGGS",
           "adversary_mask", "attack_round_keys", "build_attack",
           "build_robust_aggregate", "guard_quarantines", "guard_rejects",
           "params_ok", "quarantine_masks", "register_attack",
           "register_robust_agg", "renormalize_coeffs", "robust_active",
           "scrub_deltas", "select_state", "suspicion_ratio", "validate_robust_config"]
