"""Self-healing round guards: quarantine bad clients, reject blown rounds.

Two defense layers that run *regardless* of which aggregator is configured
(a robust estimator bounds influence, a guard removes obviously-corrupt
inputs before it even votes):

* **Client quarantine** (``fl.guard`` in ``("quarantine", "full")``) — a
  per-client health check over the decoded slot-order delta stack: any
  NaN/Inf coordinate, or an update norm spiking past ``SPIKE_MULT`` x the
  cohort's median norm, zeroes that slot's coefficient for the aggregation
  and renormalizes the survivors so the total FedShuffle mass (hence the
  server step scale) is preserved.  Quarantine is per-round and
  aggregation-only: the client's loss still reports, its state-bank rows
  still commit, and it may return healthy next round.
* **Round rejection** (``fl.guard`` in ``("reject", "full")``) — a
  server-level divergence guard after the server update: if the new
  parameters contain non-finite values or their norm blew past
  ``GROWTH_LIMIT`` x the pre-round norm, the round's param / opt / bank
  updates are discarded by a ``where``-select against the round's input
  (no host sync).  The round counter still advances, so round-indexed
  schedules, codec / attack key streams and resume validation stay
  aligned — a rejected round is a skipped round, not a replayed one.  The
  port commits the bank in place, so :func:`select_state` picks params and
  opt and the round driver writes the cohort's gathered rows back.

Surfaced as ``quarantined_clients`` / ``suspected_adversaries`` /
``rounds_rejected`` metrics only while the robust plane is active.  The
port's counterpart of ``repro.fed.robust.guards``.
"""
from __future__ import annotations

import torch

from ...utils.pytree import tree_map
from ..server import ServerState
from .aggregators import _EPS, masked_median, slot_sqnorms

GUARDS = ("off", "quarantine", "reject", "full")

# norm-spike threshold: quarantine a client whose update norm exceeds this
# multiple of the cohort's median norm (median over valid finite slots)
SPIKE_MULT = 8.0
# divergence threshold: reject the round if ||params_new|| grows past this
# multiple of sqrt(||params_old||^2 + 1)  (the +1 absorbs near-zero starts)
GROWTH_LIMIT = 100.0


def guard_quarantines(fl) -> bool:
    return fl.guard in ("quarantine", "full")


def guard_rejects(fl) -> bool:
    return fl.guard in ("reject", "full")


def _finite_mask(deltas: dict) -> torch.Tensor:
    """[C] f32: 1 where every coordinate of a slot's update is finite."""
    bad = sum((~torch.isfinite(x.float())).to(torch.float32).sum(dim=tuple(range(1, x.dim())))
              for x in deltas.values())
    return (bad == 0).to(torch.float32)


def suspicion_ratio(deltas: dict, meta) -> torch.Tensor:
    """[C] update-norm / cohort-median-norm: ~1 for honest clients; scaled
    attacks and diverged clients sit far in the tail.  Non-finite norms
    clamp to 1e9 so they stay visible."""
    norm = torch.sqrt(slot_sqnorms(deltas))
    med = masked_median(norm, meta.valid * _finite_mask(deltas))
    ratio = norm / torch.clamp_min(med, _EPS)
    return torch.where(torch.isfinite(ratio), ratio, torch.full_like(ratio, 1e9))


def quarantine_masks(deltas: dict, meta) -> tuple[torch.Tensor, torch.Tensor]:
    """(healthy [C], suspected [C]) over the decoded slot-order stack.

    ``suspected`` flags valid slots tripping the norm-spike heuristic (the
    "looks adversarial" signal); ``healthy`` additionally drops NaN/Inf
    slots — ``1 - healthy`` (on valid slots) is what quarantine removes."""
    norm = torch.sqrt(slot_sqnorms(deltas))
    fin = _finite_mask(deltas)
    med = masked_median(norm, meta.valid * fin)
    spike = norm > torch.tensor(SPIKE_MULT, dtype=torch.float32, device=norm.device) \
        * torch.clamp_min(med, _EPS)
    spike = spike.to(torch.float32) * fin       # non-finite handled separately
    return fin * (1.0 - spike), meta.valid * spike


def scrub_deltas(deltas: dict, healthy: torch.Tensor) -> dict:
    """Zero quarantined slots' values in the stacked dict (``where``, not a
    multiply — 0 * NaN is NaN, and a quarantined client's non-finite values
    must not leak through the sorted-scan estimators downstream)."""
    return {k: torch.where(healthy.reshape((-1,) + (1,) * (d.dim() - 1)) > 0, d,
                           torch.zeros((), dtype=d.dtype, device=d.device))
            for k, d in deltas.items()}


def renormalize_coeffs(coeff: torch.Tensor, healthy: torch.Tensor) -> torch.Tensor:
    """Zero quarantined coefficients, rescale survivors to the original
    total mass (an all-quarantined cohort degrades to a zero aggregate)."""
    cf = coeff.float()
    tot = cf.sum()
    kept = (cf * healthy).sum()
    scale = torch.where(kept > 0, tot / torch.where(kept > 0, kept, torch.ones_like(kept)),
                        torch.ones_like(kept))
    return cf * healthy * scale


def params_ok(prev_params: dict, new_params: dict) -> torch.Tensor:
    """0-d bool tensor: the post-update parameters are finite and un-blown."""
    finite = torch.stack([torch.isfinite(x.float()).all() for x in new_params.values()]).all()
    sq_new = sum(torch.sum(torch.square(x.float())) for x in new_params.values())
    sq_prev = sum(torch.sum(torch.square(x.float())) for x in prev_params.values())
    limit = torch.tensor(GROWTH_LIMIT**2, dtype=torch.float32, device=sq_new.device)
    return finite & (sq_new <= limit * (sq_prev + 1.0))


def select_state(ok: torch.Tensor, new: ServerState, prev: ServerState) -> ServerState:
    """Keep or revert a round's params and opt by ``where`` on the device
    (``rnd`` always advances).  The bank is ``new``'s: the round driver
    commits it in place and writes a rejected round's rows back itself."""

    def pick(n, p):
        return tree_map(lambda a, b: torch.where(ok, a, b), n, p)

    return ServerState(params=pick(new.params, prev.params), opt=pick(new.opt, prev.opt),
                       rnd=new.rnd, clients=new.clients)
