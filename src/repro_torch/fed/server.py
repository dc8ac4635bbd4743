"""Server state.

Server semantics (descent form of Algorithm 1/3/4):
    ``x <- x + eta_g * Delta``  with  ``Delta = sum_{i in S} (w~_i/q_i^S) Delta_i``
(Delta_i = y_i - x points *against* the local gradient, so adding it descends.)
The server optimizers are registered in ``repro_torch.fed.strategy``.
"""
from __future__ import annotations

from typing import NamedTuple


class ServerState(NamedTuple):
    """Everything the server owns between rounds: the parameters (a flat
    dict of tensors), the optimizer state (a dict of such trees) and the
    number of completed rounds."""

    params: dict
    opt: dict
    rnd: int
