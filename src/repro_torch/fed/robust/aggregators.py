"""Byzantine-robust aggregation over FedShuffle's per-client coefficients.

FedShuffle's correction flows through the aggregation weights
``coeff_i = valid_i * w~_i / q_i`` — so the robust estimators here *compose
with* those weights instead of replacing them.  Every aggregator takes the
slot-order stacked ``[C, ...]`` delta dict plus the strategy's bound
coefficient vector (staleness discounts under the buffered fleet included)
and returns an estimate on the **same scale** as the canonical
``weighted_sum``: a coefficient-weighted location estimate times the total
coefficient mass ``W = sum(coeff)``, so ``mean`` is exactly
``weighted_sum`` and swapping aggregators never rescales ``server_lr``.

All cross-client math runs on the slot-order ``[C]`` stack every layout
stages (the bucketed layout reassembles into slot order first, and the
sequential mode stages its deltas while the plane is on), so padded ==
bucketed bitwise.  The estimators are plain torch, as the JAX package's are
plain ``jnp`` (sorts, cumulative sums, a Gram matrix, the krum bit search);
no kernel of their own.

Registered aggregators (``ROBUST_AGGS``; via :func:`register_robust_agg`):

* ``mean``              — the canonical ``weighted_sum`` (the frozen default).
* ``coordinate_median`` — per-coordinate *weighted* median via sorted
  cumulative coefficients (breakdown point: 1/2 of coefficient mass).
* ``trimmed_mean``      — per-coordinate weighted mean over the central
  ``[trim, 1 - trim]`` coefficient-mass window.
* ``norm_clip``         — clip every client's update norm to the cohort's
  median norm, then ``weighted_sum``.
* ``centered_clip``     — Karimireddy et al. 2021 iterative centered
  clipping: repeat ``v += sum_i (coeff_i/W) * clip(Delta_i - v, tau)``.
* ``krum`` / ``multi_krum`` — Blanchard et al. 2017 via the O(C^2) pairwise
  squared-distance matrix; ``krum`` ships the best-scored client's update,
  ``multi_krum`` the coefficient-weighted mean of the best ``k``.

Three choices keep the port's results those of the JAX package: sorts are
stable (``jnp.argsort`` is; ties would otherwise reorder the carried
weights), the median's first-hit search compares in int32 (``argmax``
takes no bool; torch's returns the first maximum, as JAX's does), and the
krum threshold search reads the fp32 distances' bits with
``Tensor.view(torch.int32)``, not a cast.  That search repeats the JAX
package's int32 arithmetic exactly, wraparound included: its first
midpoint overflows, so the search never leaves the bit range's top and
every valid partner counts (ROADMAP, "Facts about the reference").  The
selections are the JAX package's.  Estimators are fp32 internally and
cast back per leaf, like ``weighted_sum``.  The port's counterpart of
``repro.fed.robust.aggregators``.
"""
from __future__ import annotations

from typing import Callable

import torch

from ...configs.base import FLConfig

_EPS = 1e-12
_BIG = 1e30  # finite stand-in for +inf where a 0-weight would make inf*0=nan

# aggregators whose breakdown point / neighbor count is fl.trim_frac
TRIM_PARAM_AGGS = ("trimmed_mean", "krum", "multi_krum")


def _wbcast(w: torch.Tensor, ndim: int) -> torch.Tensor:
    return w.reshape((-1,) + (1,) * (ndim - 1))


def _wsum(deltas: dict, coeff: torch.Tensor) -> dict:
    """The canonical fp32 einsum aggregation (== strategy.weighted_sum)."""
    return {k: torch.einsum("c,c...->...", coeff.float(), t.float()).to(t.dtype)
            for k, t in deltas.items()}


def _sorted_with_weights(x: torch.Tensor, coeff: torch.Tensor):
    """Sort a stacked leaf along the client axis (stably), carrying the
    weights along."""
    xs, order = torch.sort(x.float(), dim=0, stable=True)
    ws = _wbcast(coeff.float(), x.dim()).expand(x.shape).gather(0, order)
    return xs, ws


def slot_sqnorms(deltas: dict) -> torch.Tensor:
    """Per-slot fp32 squared norms of the stacked dict ([C])."""
    return sum(torch.sum(torch.square(x.float()), dim=tuple(range(1, x.dim())))
               for x in deltas.values())


def masked_median(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Unweighted median of ``x[mask > 0]`` ([C] -> 0-d; inf when empty),
    the lower middle value for an even count."""
    keep = mask > 0
    xs = torch.sort(torch.where(keep, x.float(), torch.inf)).values
    k = torch.clamp_min(keep.sum() - 1, 0) // 2
    return xs.index_select(0, k.reshape(1))[0]          # no host sync


def _mean(deltas, coeff, meta, fl: FLConfig):
    return _wsum(deltas, coeff)


def _coordinate_median(deltas, coeff, meta, fl: FLConfig):
    W = coeff.float().sum()

    def leaf(x):
        xs, ws = _sorted_with_weights(x, coeff)
        cw = torch.cumsum(ws, dim=0)
        half = 0.5 * cw[-1]
        # first index whose cumulative mass reaches half: necessarily a slot
        # with positive weight, so 0-coefficient (invalid / quarantined)
        # values can never be selected
        idx = (cw >= half[None]).to(torch.int32).argmax(dim=0)
        med = xs.gather(0, idx[None])[0]
        return (med * W).to(x.dtype)

    return {k: leaf(x) for k, x in deltas.items()}


def _trimmed_mean(deltas, coeff, meta, fl: FLConfig):
    cf = coeff.float()
    W = cf.sum()
    lo = torch.tensor(fl.trim_frac, dtype=torch.float32, device=cf.device) * W
    hi = torch.tensor(1.0 - fl.trim_frac, dtype=torch.float32, device=cf.device) * W

    def leaf(x):
        xs, ws = _sorted_with_weights(x, coeff)
        cw_hi = torch.cumsum(ws, dim=0)
        cw_lo = cw_hi - ws
        # effective mass of each sorted value inside the central window
        eff = torch.clamp(cw_hi, lo, hi) - torch.clamp(cw_lo, lo, hi)
        tm = (eff * xs).sum(dim=0) / torch.clamp_min(hi - lo, _EPS)
        return (tm * W).to(x.dtype)

    return {k: leaf(x) for k, x in deltas.items()}


def _norm_clip(deltas, coeff, meta, fl: FLConfig):
    norm = torch.sqrt(slot_sqnorms(deltas))
    tau = masked_median(norm, coeff > 0)
    fac = torch.clamp(tau / torch.clamp_min(norm, _EPS), max=1.0)     # [C]
    clipped = {k: d.float() * _wbcast(fac, d.dim()) for k, d in deltas.items()}
    return {k: v.to(deltas[k].dtype) for k, v in _wsum(clipped, coeff).items()}


_CCLIP_ITERS = 3


def _centered_clip(deltas, coeff, meta, fl: FLConfig):
    cf = coeff.float()
    W = cf.sum()
    wn = cf / torch.clamp_min(W, _EPS)                                 # [C]
    tau = masked_median(torch.sqrt(slot_sqnorms(deltas)), coeff > 0)
    v = {k: d.new_zeros(d.shape[1:], dtype=torch.float32) for k, d in deltas.items()}
    for _ in range(_CCLIP_ITERS):
        diff = {k: d.float() - v[k][None] for k, d in deltas.items()}
        r = torch.sqrt(slot_sqnorms(diff))                             # [C]
        fac = torch.clamp(tau / torch.clamp_min(r, _EPS), max=1.0)
        v = {k: v[k] + torch.einsum("c,c...->...", wn * fac, df) for k, df in diff.items()}
        del diff
    return {k: (vl * W).to(deltas[k].dtype) for k, vl in v.items()}


def _pairwise_sqdists(deltas: dict) -> torch.Tensor:
    """[C, C] fp32 squared distances via the Gram matrix (O(C^2))."""
    sq = slot_sqnorms(deltas)                                          # [C]
    gram = sum(torch.einsum("cn,en->ce", x.float().flatten(1), x.float().flatten(1))
               for x in deltas.values())
    return torch.clamp_min(sq[:, None] + sq[None, :] - 2.0 * gram, 0.0)


def _krum_scores(deltas: dict, coeff: torch.Tensor, trim_frac: float):
    """(scores [C], k) — each valid client's summed distances to the
    neighbors the threshold search admits.

    The search bisects each row's k-th smallest distance on the *int32 bit
    patterns* of the (non-negative) fp32 distances, 31 masked count passes
    over the [C, C] matrix, in the JAX package's int32 arithmetic: its
    first midpoint ``lo + (hi - lo) // 2`` wraps (hi - lo is 2^31), so
    ``hi`` stays at the top of the range and every valid partner counts
    (see the module docstring)."""
    C = coeff.shape[0]
    dev = coeff.device
    m = (coeff > 0).to(torch.float32)                                  # [C]
    nv = m.sum().to(torch.int32)
    f = (torch.tensor(trim_frac, dtype=torch.float32, device=dev)
         * nv.to(torch.float32)).to(torch.int32)
    k = torch.clamp(nv - f - 2, 1, C)
    dist = torch.clamp(_pairwise_sqdists(deltas), max=_BIG)
    # exclude self and invalid / quarantined partners from the neighbor pool
    pair_ok = (m[:, None] * m[None, :]) * (1.0 - torch.eye(C, dtype=torch.float32, device=dev))
    dbits = dist.view(torch.int32)                                     # [C, C]
    kf = k.to(torch.float32)
    lo = torch.full((C,), -1, dtype=torch.int32, device=dev)           # cnt(lo) <  k
    hi = torch.full((C,), 2**31 - 1, dtype=torch.int32, device=dev)    # cnt(hi) >= k
    for _ in range(31):                                # log2 of the bit range
        mid = lo + torch.div(hi - lo, 2, rounding_mode="floor")
        cnt = (pair_ok * (dbits <= mid[:, None])).sum(dim=1)
        hit = cnt >= kf
        hi = torch.where(hit, mid, hi)
        lo = torch.where(hit, lo, mid)
    near = pair_ok * (dbits <= hi[:, None]).to(torch.float32)
    neigh = (near * dist).sum(dim=1)
    # valid clients always strictly beat invalid ones
    scores = torch.where(m > 0, torch.clamp(neigh, max=_BIG), torch.inf)
    return scores, k


def _krum(deltas, coeff, meta, fl: FLConfig):
    W = coeff.float().sum()
    scores, _ = _krum_scores(deltas, coeff, fl.trim_frac)
    sel = torch.argmin(scores).reshape(1)
    return {k: (x.index_select(0, sel)[0].float() * W).to(x.dtype) for k, x in deltas.items()}


def _multi_krum(deltas, coeff, meta, fl: FLConfig):
    cf = coeff.float()
    W = cf.sum()
    C = cf.shape[0]
    scores, k = _krum_scores(deltas, coeff, fl.trim_frac)
    order = torch.sort(scores, stable=True).indices
    keep = torch.zeros(C, dtype=torch.float32, device=cf.device).index_put(
        (order,), (torch.arange(C, device=cf.device) < k).to(torch.float32))
    kept = cf * keep
    # renormalize the survivors' coefficients so total mass is preserved
    w2 = kept * (W / torch.clamp_min(kept.sum(), _EPS))
    return _wsum(deltas, w2)


ROBUST_AGGS: dict[str, Callable] = {
    "mean": _mean,
    "coordinate_median": _coordinate_median,
    "trimmed_mean": _trimmed_mean,
    "norm_clip": _norm_clip,
    "centered_clip": _centered_clip,
    "krum": _krum,
    "multi_krum": _multi_krum,
}


def register_robust_agg(name: str, agg: Callable, *, overwrite: bool = False) -> None:
    """Register ``agg(deltas, coeff, meta, fl) -> delta_agg`` under ``name``
    (the ``FLConfig.aggregator`` key)."""
    if not overwrite and name in ROBUST_AGGS:
        raise ValueError(
            f"robust aggregator {name!r} already registered (pass overwrite=True to replace)")
    ROBUST_AGGS[name] = agg


def build_robust_aggregate(fl: FLConfig) -> Callable:
    """Resolve ``fl.aggregator`` to ``(deltas, coeff, meta) -> delta_agg``."""
    if fl.aggregator not in ROBUST_AGGS:
        raise ValueError(
            f"unknown aggregator {fl.aggregator!r}; have {sorted(ROBUST_AGGS)}")
    fn = ROBUST_AGGS[fl.aggregator]

    def robust_aggregate(deltas, coeff, meta):
        return fn(deltas, coeff, meta, fl)

    return robust_aggregate
