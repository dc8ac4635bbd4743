"""Server state.

Server semantics (descent form of Algorithm 1/3/4):
    ``x <- x + eta_g * Delta``  with  ``Delta = sum_{i in S} (w~_i/q_i^S) Delta_i``
(Delta_i = y_i - x points *against* the local gradient, so adding it descends.)
The server optimizers are registered in ``repro_torch.fed.strategy``.
"""
from __future__ import annotations

from typing import Any, NamedTuple


class ServerState(NamedTuple):
    """Everything the server owns between rounds: the parameters (a flat
    dict of tensors), the optimizer state (a dict of such trees), the number
    of completed rounds and the per-client state bank.

    ``clients`` is ``None`` unless a plane keeps per-client state (the comm
    plane's EF residuals / DIANA shifts under ``"uplink"``, the downlink's
    client-held reference under ``"downlink"``): then ``{name: {field:
    tree}}`` with ``[num_clients + 1, ...]`` leaves, row ``num_clients`` the
    scratch row that padding slots aim at.  The round driver gathers and
    commits O(cohort) rows of it, in place (see ``fed.rounds``); server
    optimizers build ``ServerState(params=, opt=, rnd=)`` and the driver
    re-attaches the bank."""

    params: dict
    opt: dict
    rnd: int
    clients: Any = None
