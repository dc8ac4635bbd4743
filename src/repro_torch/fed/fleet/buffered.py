"""Buffered-async server path: staleness weighting + the fleet state bank.

The FedBuff-style server (``fl.server_mode="buffered"``) aggregates each
tick's first-K arrivals through the *existing* strategy hooks: binding wraps
``agg_coeffs`` so every coefficient is multiplied by a staleness discount,
and ``aggregate`` (= ``weighted_sum(deltas, agg_coeffs(meta))``) inherits it
in both cohort modes.  The weighting contract:

    ``constant`` — w(tau) = 1            (pure FedBuff averaging)
    ``poly``     — w(tau) = (1 + tau) ** -fl.staleness_power

with tau the update's staleness in server ticks (``meta.staleness``; 0 for
work dispatched and aggregated in the same tick, and in sync mode).

Per-client staleness counters ride ``ServerState.clients`` under the
reserved ``FLEET_STATE_KEY`` bank key, like SCAFFOLD's control variates and
the uplink's error-feedback residuals: one fp32 scalar row per client and a
scratch row, gathered and committed O(cohort) by the round driver.

Composition with the robustness plane (``repro_torch.fed.robust``):
staleness discounts enter through the wrapped ``agg_coeffs``, and robust
aggregators consume exactly those coefficients; quarantine renormalization
(``renormalize_coeffs``) preserves the discounted total mass.  The port's
counterpart of ``repro.fed.fleet.buffered``.
"""
from __future__ import annotations

import torch

from ...configs.base import FLConfig

FLEET_STATE_KEY = "fleet"   # reserved ServerState.clients bank key


def fleet_client_state(device=None) -> dict:
    """One client's row of the fleet bank: cumulative arrival/staleness
    counters (fp32 scalars on ``device``; the round driver increments the
    cohort's rows)."""
    return {"arrivals": torch.zeros((), dtype=torch.float32, device=device),
            "stale_sum": torch.zeros((), dtype=torch.float32, device=device)}


def slot_staleness(meta) -> torch.Tensor:
    """The cohort's per-slot staleness as a [C] fp32 tensor.

    The single definition of the "no fleet fields => tau = 0" rule:
    hand-built metas and sync-mode plans (``meta.staleness`` None or zeros)
    read as fresh everywhere staleness is consumed."""
    stal = getattr(meta, "staleness", None)
    if stal is None:
        return torch.zeros_like(torch.as_tensor(meta.valid, dtype=torch.float32))
    return torch.as_tensor(stal, dtype=torch.float32)


def staleness_weights(fl: FLConfig, meta) -> torch.Tensor:
    """Per-slot staleness discounts ([C] fp32, 1.0 at tau=0)."""
    stal = slot_staleness(meta)
    if fl.staleness == "constant":
        return torch.ones_like(stal)
    return (1.0 + stal) ** -float(fl.staleness_power)
