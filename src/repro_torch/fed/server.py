"""Server state + LR schedules.

Server semantics (descent form of Algorithm 1/3/4):
    ``x <- x + eta_g * Delta``  with  ``Delta = sum_{i in S} (w~_i/q_i^S) Delta_i``
(Delta_i = y_i - x points *against* the local gradient, so adding it descends.)
The server optimizers are registered in ``repro_torch.fed.strategy``;
``init_server`` / ``apply_server`` are the legacy string-keyed entry points
and delegate to that registry.  ``wsd_schedule`` and ``cosine_schedule``
are the JAX package's LR multipliers, keyed by the absolute round.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple


class ServerState(NamedTuple):
    """Everything the server owns between rounds: the parameters (a flat
    dict of tensors), the optimizer state (a dict of such trees), the number
    of completed rounds and the per-client state bank.

    ``clients`` is ``None`` unless a plane keeps per-client state (a
    stateful client transform's under its name, e.g. SCAFFOLD's control
    variates under ``"scaffold"``; the comm plane's EF residuals / DIANA
    shifts under ``"uplink"``, the downlink's client-held reference under
    ``"downlink"``): then ``{name: {field:
    tree}}`` with ``[num_clients + 1, ...]`` leaves, row ``num_clients`` the
    scratch row that padding slots aim at.  The round driver gathers and
    commits O(cohort) rows of it, in place (see ``fed.rounds``); server
    optimizers build ``ServerState(params=, opt=, rnd=)`` and the driver
    re-attaches the bank."""

    params: dict
    opt: dict
    rnd: int
    clients: Any = None


def init_server(fl, params) -> ServerState:
    """A ServerState of ``fl.server_opt``'s initial opt state, without a
    bank (the legacy entry point; a bound strategy's ``init`` builds one)."""
    from .strategy import server_opt_init  # deferred: strategy imports ServerState

    return ServerState(params=params, opt=server_opt_init(fl, params), rnd=0)


def apply_server(fl, state: ServerState, delta, lr) -> ServerState:
    """One server update given the aggregated pseudo-update ``delta``, on
    the legacy path without a round context: optimizers that estimate
    gradients from client data (mvr) or fold in client state (scaffold)
    apply only their parameter step here."""
    from .strategy import apply_server_opt  # deferred: strategy imports ServerState

    return apply_server_opt(fl, state, delta, lr)


def wsd_schedule(rnd: int, total: int, warmup_frac: float = 0.05, decay_frac: float = 0.2) -> float:
    """MiniCPM's Warmup-Stable-Decay LR schedule (arXiv:2404.06395)."""
    warmup = max(1, int(total * warmup_frac))
    decay_start = int(total * (1.0 - decay_frac))
    if rnd < warmup:
        return (rnd + 1) / warmup
    if rnd < decay_start:
        return 1.0
    # exponential decay to 10% over the decay phase
    frac = (rnd - decay_start) / max(1, total - decay_start)
    return float(0.1**frac)


def cosine_schedule(rnd: int, total: int, warmup_frac: float = 0.05) -> float:
    """Linear warmup, then a half cosine from 1 to 0 over the rest."""
    warmup = max(1, int(total * warmup_frac))
    if rnd < warmup:
        return (rnd + 1) / warmup
    t = (rnd - warmup) / max(1, total - warmup)
    return 0.5 * (1 + math.cos(math.pi * t))
