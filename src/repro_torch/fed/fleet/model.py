"""Device-tier fleet model: per-client compute/latency heterogeneity.

Real cross-device fleets are not uniformly fast: clients differ in compute
tier and network latency, so a round's *virtual* wall time is dominated by
its slowest participants.  This module turns ``fl.fleet`` into O(population)
cached per-client arrays, plus counter-based per-(seed, client, round)
uniform draws riding the same rr_perm hash chain the reshuffling and uplink
streams use (the fleet tag keeps them independent), so every draw is
stateless and identical wherever the round is produced (legacy host path,
cohort engine, prefetch thread, checkpoint resume).  Host numpy throughout,
bitwise equal to the JAX package's draws.

Registered fleet models (``FLEETS``; extensible via :func:`register_fleet`):

* ``homogeneous`` — unit speed, zero latency.  With ``server_mode="sync"``
  and no faults this is the *fleet-plane-off* contract: ``build_fleet``
  returns None and the pipeline's round assembly computes nothing new.
* ``tiered``      — ``fl.fleet_tiers`` discrete device tiers; speeds decay
  geometrically from 1 down to ``1/fl.tier_spread`` and latency scales
  inversely (slow devices sit on slow links).
* ``zipf_latency`` — unit speed, Pareto(``fl.zipf_alpha``)-tailed per-client
  latency scaled by ``fl.tier_latency`` (capped at 256x so a virtual round
  stays finite) — the straggler-tail regime FedBuff targets.

Virtual time is unitless: one unit ~ one local step of a tier-0 device.
A client's round wall time is ``latency_i + steps_i / speed_i``.  The
port's counterpart of ``repro.fed.fleet.model``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np

from ...configs.base import FLConfig
from ...data.federated import Population
from ...kernels.rr_perm.ref import fmix32, key_combine, stream_key
from ...utils.tags import (SUB_FLEET_DROPOUT, SUB_FLEET_LATENCY, SUB_FLEET_STRAGGLER,
                           SUB_FLEET_TIER, TAG_FLEET)

# per-use subtags folded in after the fleet tag (one stream per purpose)
SUB_TIER = SUB_FLEET_TIER              # tier assignment (round-independent)
SUB_LATENCY = SUB_FLEET_LATENCY        # latency draw (round-independent)
SUB_DROPOUT = SUB_FLEET_DROPOUT        # per-round dropout coin
SUB_STRAGGLER = SUB_FLEET_STRAGGLER    # per-round straggler coin


def parse_faults(spec: str) -> tuple:
    """``fl.faults`` ("a,b,c") -> fault names in application order."""
    return tuple(name.strip() for name in (spec or "").split(",") if name.strip())


def fleet_active(fl: FLConfig) -> bool:
    """Whether any fleet-plane machinery runs.  False is the frozen default:
    no extra meta math, no new metric keys, bitwise-identical rounds."""
    return (fl.fleet != "homogeneous" or fl.server_mode != "sync"
            or bool(parse_faults(fl.faults)))


def fleet_uniform(seed: int, client_ids, rnd: int, subtag: int) -> np.ndarray:
    """Counter-based U[0,1) per (seed, client, round, subtag) — host numpy.

    The (seed, client, round) chain of the RR index streams with the fleet
    tag and a per-purpose subtag folded in, so e.g. the dropout coin and the
    straggler coin of one (client, round) are independent."""
    ids = np.atleast_1d(np.asarray(client_ids)).astype(np.uint32)
    key = stream_key(seed, ids, np.uint32(int(rnd) & 0xFFFFFFFF))
    key = key_combine(key, np.uint32(TAG_FLEET))
    key = key_combine(key, np.uint32(subtag & 0xFFFFFFFF))
    return fmix32(key).astype(np.float64) / np.float64(2**32)


@dataclass(frozen=True)
class FleetModel:
    """O(population) cached device-tier arrays (host-side, built once)."""

    name: str
    tier: np.ndarray         # [n] int32 device tier (0 = fastest)
    speed: np.ndarray        # [n] float64 local steps per virtual-time unit
    latency: np.ndarray      # [n] float64 fixed per-round overhead

    def wall_time(self, ids, steps) -> np.ndarray:
        """Virtual completion time of ``steps`` local steps per client."""
        ids = np.atleast_1d(np.asarray(ids)).astype(np.int64)
        return self.latency[ids] + np.asarray(steps, np.float64) / self.speed[ids]

    def deadline_caps(self, deadline: float) -> np.ndarray:
        """Max local steps each client finishes within ``deadline`` ([n]
        int64, >= 0; 0 means even latency alone exceeds the budget).  Purely
        deterministic — this is what maps tiers onto step buckets."""
        cap = np.floor((float(deadline) - self.latency) * self.speed)
        return np.maximum(cap, 0.0).astype(np.int64)


def _homogeneous(fl: FLConfig, population: Population) -> FleetModel:
    n = population.num_clients
    return FleetModel(name="homogeneous", tier=np.zeros(n, np.int32),
                      speed=np.ones(n), latency=np.zeros(n))


def _tiered(fl: FLConfig, population: Population) -> FleetModel:
    n, T = population.num_clients, max(1, int(fl.fleet_tiers))
    u = fleet_uniform(fl.seed, np.arange(n), 0, SUB_TIER)
    tier = np.minimum((u * T).astype(np.int32), T - 1)
    # geometric speed decay: tier 0 at 1.0, the last tier at 1/tier_spread
    expo = tier / max(T - 1, 1)
    speed = float(fl.tier_spread) ** (-expo)
    latency = float(fl.tier_latency) / speed     # slow devices, slow links
    return FleetModel(name="tiered", tier=tier, speed=speed, latency=latency)


_ZIPF_CAP = 256.0  # latency tail cap (x tier_latency): keeps rounds finite


def _zipf_latency(fl: FLConfig, population: Population) -> FleetModel:
    n = population.num_clients
    u = fleet_uniform(fl.seed, np.arange(n), 0, SUB_LATENCY)
    # Pareto tail via inverse CDF; 1-u in (0, 1] avoids the u=0 pole
    lat = np.minimum((1.0 - u) ** (-1.0 / float(fl.zipf_alpha)), _ZIPF_CAP)
    tier = np.clip(np.floor(np.log2(np.maximum(lat, 1.0))), 0, 31).astype(np.int32)
    return FleetModel(name="zipf_latency", tier=tier, speed=np.ones(n),
                      latency=float(fl.tier_latency) * lat)


FLEETS: dict[str, Callable] = {
    "homogeneous": _homogeneous,
    "tiered": _tiered,
    "zipf_latency": _zipf_latency,
}


def register_fleet(name: str, build: Callable, *, overwrite: bool = False) -> None:
    """Register ``build(fl, population) -> FleetModel`` under ``name``
    (the ``FLConfig.fleet`` key)."""
    if not overwrite and name in FLEETS:
        raise ValueError(
            f"fleet model {name!r} already registered (pass overwrite=True to replace)")
    FLEETS[name] = build


def build_fleet(fl: FLConfig, population: Population) -> FleetModel | None:
    """Resolve ``fl.fleet`` to its cached arrays; None when the fleet plane
    is fully off (the bitwise-frozen default path)."""
    if not fleet_active(fl):
        return None
    if fl.fleet not in FLEETS:
        raise ValueError(f"unknown fleet model {fl.fleet!r}; have {sorted(FLEETS)}")
    return FLEETS[fl.fleet](fl, population)
