"""Heterogeneous fleet plane: device tiers, fault injection, async server.

Three layers (see the module docstrings):

* :mod:`~repro_torch.fed.fleet.model`    — per-client device-tier arrays
  (``FLEETS``) + counter-based per-(seed, client, round) draws;
* :mod:`~repro_torch.fed.fleet.faults`   — dropout / straggler / abort
  scenarios (``FAULTS``) applied vectorized over a round's cohort;
* :mod:`~repro_torch.fed.fleet.clock` / :mod:`~repro_torch.fed.fleet.buffered`
  — the virtual-clock executor and the FedBuff-style buffered-async server.

With the default knobs (``fleet="homogeneous"``, ``server_mode="sync"``, no
faults) the whole plane is off: ``build_fleet`` returns None, the pipeline
adds no fleet math, the round step adds no metric keys.  The port's
counterpart of ``repro.fed.fleet``.
"""
from __future__ import annotations

from ...configs.base import FLConfig
from .buffered import FLEET_STATE_KEY, fleet_client_state, slot_staleness, staleness_weights
from .clock import BufferedSchedule, TickOutcome
from .faults import FAULTS, RoundFaults, apply_faults, register_fault, validate_faults
from .model import (FLEETS, FleetModel, build_fleet, fleet_active, fleet_uniform, parse_faults,
                    register_fleet)

SERVER_MODES = ("sync", "buffered")
STALENESS_KINDS = ("constant", "poly")


def validate_fleet_config(fl: FLConfig) -> None:
    """Bind-time validation of every fleet-plane knob (unknown names, bad
    parameters, unsupported combinations fail loudly here, not mid-round)."""
    if fl.fleet not in FLEETS:
        raise ValueError(f"unknown fleet model {fl.fleet!r}; have {sorted(FLEETS)}")
    if fl.fleet_tiers < 1:
        raise ValueError(f"fl.fleet_tiers must be >= 1, got {fl.fleet_tiers}")
    if fl.tier_spread < 1.0:
        raise ValueError(f"fl.tier_spread must be >= 1, got {fl.tier_spread}")
    if fl.tier_latency < 0.0:
        raise ValueError(f"fl.tier_latency must be >= 0, got {fl.tier_latency}")
    if fl.zipf_alpha <= 0.0:
        raise ValueError(f"fl.zipf_alpha must be > 0, got {fl.zipf_alpha}")
    if fl.server_mode not in SERVER_MODES:
        raise ValueError(f"unknown server_mode {fl.server_mode!r}; have {SERVER_MODES}")
    if fl.staleness not in STALENESS_KINDS:
        raise ValueError(
            f"unknown staleness weighting {fl.staleness!r}; have {STALENESS_KINDS}")
    if fl.staleness_power < 0.0:
        raise ValueError(f"fl.staleness_power must be >= 0, got {fl.staleness_power}")
    validate_faults(fl)
    if fl.server_mode == "buffered":
        if fl.buffer_size < 1:
            raise ValueError(f"fl.buffer_size must be >= 1, got {fl.buffer_size}")
        if fl.buffer_size > fl.cohort_size:
            raise ValueError(
                f"fl.buffer_size ({fl.buffer_size}) cannot exceed the "
                f"concurrency fl.cohort_size ({fl.cohort_size}) — a tick "
                f"could never collect its K arrivals.")
        if fl.cohort_size + fl.buffer_size - 1 > fl.num_clients:
            raise ValueError(
                f"buffered mode needs num_clients >= cohort_size + "
                f"buffer_size - 1 (got {fl.num_clients} < {fl.cohort_size} "
                f"+ {fl.buffer_size} - 1): a completed client's slot must "
                f"be refillable with a client neither in flight nor already "
                f"aggregated in the tick being assembled.")
        if fl.sampling == "full":
            raise ValueError(
                "buffered mode is incompatible with sampling='full' — the "
                "whole population would be permanently in flight.")
        from ..strategy import equalized_mode  # deferred: strategy imports this plane

        if equalized_mode(fl.algorithm) is not None:
            raise ValueError(
                f"buffered mode does not support equalized-step strategies "
                f"({fl.algorithm!r}): the cohort-wide K is undefined when "
                f"clients start rounds at different virtual times.")


__all__ = ["FLEETS", "FAULTS", "FLEET_STATE_KEY", "SERVER_MODES",
           "STALENESS_KINDS", "BufferedSchedule", "FleetModel", "RoundFaults",
           "TickOutcome", "apply_faults", "build_fleet", "fleet_active",
           "fleet_client_state", "fleet_uniform", "parse_faults",
           "register_fault", "register_fleet", "slot_staleness", "staleness_weights",
           "validate_faults", "validate_fleet_config"]
