"""Fixed-shape distribution summaries (in-round histograms).

FedShuffle's arguments are about *distributions* — per-client step counts
under imbalance, update norms, staleness under buffered aggregation, bytes
on the wire — but scalar round metrics (means, maxima) erase exactly that
structure.  This module computes fixed-size histograms *inside* the round
from the existing slot-order ``[C]`` arrays, so surfacing a distribution
costs one ``searchsorted`` + ``index_add_`` on the device and one small
transfer, never a per-client host readback.

The cardinality contract: every histogram has a **static** bin count and
**static, config-derived edges** (numpy constants, never functions of
runtime values or of the execution layout), so histograms from padded /
bucketed / legacy / engine rounds are directly comparable.  Out-of-range
values clamp into the first / last bin (the edge builders put ``+inf`` at
the top where the tail is unbounded).

Edge builders:

* :func:`pow2_edges` — ``[0, 1, 2, 4, ..., inf)`` for small-integer counts
  (local steps, staleness ticks): resolution where the mass is, one
  unbounded tail bin.
* :func:`log_edges` — log-uniform decades for positive scale-free values
  (update norms, wire bytes).

``fed.rounds`` emits (gated on ``fl.telemetry``): ``hist_steps``,
``hist_update_norm``, plus ``hist_staleness`` when the fleet plane is on,
``hist_uplink_mbytes`` / ``hist_downlink_mbytes`` under a non-identity
codec, ``hist_suspicion`` (update-norm / median-norm ratios) while the
robustness plane is active, and ``hist_dp_scale`` with DP on.

The port's counterpart of ``repro.obs.hist``.  The squared norms are fp32
sums in the JAX package's leaf order (``utils.pytree.wire_layout``: a
stacked leaf is its layers' sums added in layer order), and a slot's sums
run over its own rows, one reduction a leaf exactly as for a single
client, so :func:`slot_sqnorms` of a stack equals :func:`tree_sqnorm` of
each slot bitwise and a slot's norm does not depend on the batch around it.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.pytree import wire_layout

# histogram metric keys share this prefix — the train loop routes them to
# registry Histogram instruments instead of the scalar row
HIST_PREFIX = "hist_"


def pow2_edges(bins: int) -> np.ndarray:
    """``[0, 1, 2, 4, ..., 2**(bins-2), inf]`` — bins for count data."""
    if bins < 2:
        raise ValueError(f"need >= 2 bins, got {bins}")
    finite = [0.0, 1.0] + [float(2 ** k) for k in range(1, bins - 1)]
    return np.asarray(finite + [np.inf], np.float64)


def log_edges(lo: float, hi: float, bins: int) -> np.ndarray:
    """Log-uniform edges over ``[lo, hi]`` with clamped tails ([bins+1])."""
    if bins < 2:
        raise ValueError(f"need >= 2 bins, got {bins}")
    if not (0.0 < lo < hi):
        raise ValueError(f"need 0 < lo < hi, got ({lo}, {hi})")
    return np.logspace(np.log10(lo), np.log10(hi), bins + 1)


def fixed_histogram(values, edges, weights=None) -> torch.Tensor:
    """Weighted histogram of ``values`` into static ``edges`` ([bins] f32, on
    the values' device).

    ``edges`` is a host constant, or :func:`device_edges` of one (compared in
    fp32, as the JAX package does); the output shape is static, and
    out-of-range values clamp into the boundary bins.  ``weights`` defaults
    to 1 per value (pass ``meta.valid`` to drop padding slots)."""
    v = torch.as_tensor(values).to(torch.float32).reshape(-1)
    e = edges if isinstance(edges, torch.Tensor) else device_edges(edges, v.device)
    bins = e.numel() - 1
    idx = torch.clamp(torch.searchsorted(e, v, right=True) - 1, 0, bins - 1)
    w = (torch.ones_like(v) if weights is None
         else torch.as_tensor(weights).to(device=v.device, dtype=torch.float32).reshape(-1))
    return torch.zeros(bins, dtype=torch.float32, device=v.device).index_add_(0, idx, w)


def device_edges(edges, device) -> torch.Tensor:
    """Static edges as the fp32 tensor :func:`fixed_histogram` compares
    against, on ``device``.  The round step makes its tensors once, when it
    is built: a copy from the host in a round would wait for its queued
    work."""
    return torch.as_tensor(np.asarray(edges, np.float64).astype(np.float32), device=device)


def tree_sqnorm(tree: dict) -> torch.Tensor:
    """Scalar fp32 squared L2 norm of a tree, summed in the JAX package's
    leaf order."""
    total = 0
    for _, names in wire_layout(tree):
        total = total + sum(torch.sum(torch.square(tree[k].to(torch.float32))) for k in names)
    return total


def slot_sqnorms(deltas: dict) -> torch.Tensor:
    """Per-slot squared L2 norms of a ``[C, ...]``-stacked update tree ([C]
    fp32): :func:`tree_sqnorm` of each slot."""
    C = next(iter(deltas.values())).shape[0]
    return torch.stack([tree_sqnorm({k: v[c] for k, v in deltas.items()}) for c in range(C)])


def round_hist_edges(fl, *, with_staleness: bool, with_uplink: bool,
                     with_robust: bool = False, with_dp: bool = False,
                     with_downlink: bool = False) -> dict:
    """The static edge table for one configuration's round histograms.

    One definition shared by the emitter (``fed.rounds``) and the host
    accumulator (``fed.train_loop`` pre-creates registry Histogram
    instruments from it), so device counts always merge into matching bins.
    """
    bins = fl.telemetry_bins
    edges = {
        "hist_steps": pow2_edges(bins),
        "hist_update_norm": log_edges(1e-9, 1e3, bins),
    }
    if with_staleness:
        edges["hist_staleness"] = pow2_edges(bins)
    if with_uplink:
        edges["hist_uplink_mbytes"] = log_edges(1e-6, 1e4, bins)
    if with_downlink:
        # the broadcast direction's per-slot wire cost (fed.comm downlink)
        edges["hist_downlink_mbytes"] = log_edges(1e-6, 1e4, bins)
    if with_robust:
        # per-client update-norm / cohort-median-norm ratio (fed.robust):
        # honest mass sits near 1, scaled attacks / diverged clients in the
        # upper tail
        edges["hist_suspicion"] = log_edges(1e-2, 1e3, bins)
    if with_dp:
        # per-client DP clip scale min(1, C/||delta||) (fed.privacy): mass
        # at the top edge = updates under the clip bound, the lower tail =
        # how hard the clip is biting
        edges["hist_dp_scale"] = log_edges(1e-4, 1.0, bins)
    return edges
