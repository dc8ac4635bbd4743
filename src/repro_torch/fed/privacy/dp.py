"""DP-FedShuffle mechanism: per-client L2 clipping + server Gaussian noise.

The mechanism is the standard DP-FedAvg recipe (McMahan et al. 2018) adapted
to FedShuffle's weight-aware aggregation:

* every *shipped* client update is clipped to L2 norm ``fl.dp_clip`` — an
  exact per-client sensitivity bound, applied to the final delta (not per
  step, which is what ``local_clip``/``fl.clip_norm`` does — the two are
  rejected together at bind time because their bounds would silently
  stack);
* the server adds isotropic Gaussian noise to the weighted aggregate with

      sigma = fl.dp_noise_mult * fl.dp_clip * max_i |coeff_i|

  where ``coeff_i`` are the strategy's bound aggregation coefficients
  (``valid_i * w_i / q_i``, staleness-discounted when buffered), so
  ``dp_noise_mult`` is the noise multiplier ``z`` the RDP accountant
  consumes.

Noise is *counter-based*: drawn per ``(seed, round)`` off the rr_perm hash
chain (``TAG_PRIVACY`` / ``SUB_DP_NOISE``, ``utils/tags.py``) by Box–Muller
over two ``fmix32`` uniform streams.  No generator state exists, so the
legacy loop, the cohort engine, the prefetch thread and a resumed run
replay the same noise for the same round.  Leaf ``i``'s stream is keyed by
the JAX package's leaf index and its element counter runs over that leaf's
flat positions (the wire view, ``utils.pytree.wire_layout``: a stacked
leaf's layers in order), so the uniforms are bitwise the JAX package's;
the normals' ``log``, ``cos`` and ``sqrt`` in fp32 may differ from XLA's by
an ulp.

Clipping is exposed twice:

* :func:`dp_clip_cohort` — the round driver's path: clips the slot-order
  ``[C]`` delta stack and returns the exact per-slot clipped indicator
  (the ``dp_clipped_frac`` metric) and scale (``hist_dp_scale``);
* ``"dp_clip"`` in the ClientTransform registry — a ``finalize_delta``
  chain link computing the same function per client (or per slot in the
  cohort step).

Both take the norm as ``obs.hist`` does: an fp32 sum in the JAX package's
leaf order, a slot's sums over its own rows, so the two paths agree
bitwise and a slot's norm does not depend on the cohort around it.  The
port's counterpart of ``repro.fed.privacy.dp``.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ...core.local import ClientTransform, register_client_transform
from ...kernels.rr_perm.ref import fmix32_torch, key_combine_torch, stream_key_torch
from ...obs.hist import slot_sqnorms, tree_sqnorm
from ...utils.pytree import wire_layout
from ...utils.tags import SUB_DP_NOISE, TAG_PRIVACY

_EPS = 1e-12  # clip-scale denominator guard (matches local_clip's)


def _scaled(tree: dict, scale: torch.Tensor) -> dict:
    """Each leaf times ``scale`` (0-d, or [C] over the leading axis) in fp32,
    cast back to its dtype."""
    return {k: (x.to(torch.float32) * (scale if scale.dim() == 0 else
                                        scale.view(-1, *([1] * (x.dim() - 1))))).to(x.dtype)
            for k, x in tree.items()}


def _clip(sq: torch.Tensor, clip: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(clipped indicator, scale) from squared norms, in fp32 (the bound is
    filled on the norms' device: a copy from the host would wait for the
    round's queued work)."""
    nrm = torch.sqrt(sq)
    limit = torch.full_like(nrm, clip)
    scale = torch.minimum(torch.ones_like(nrm), limit / torch.clamp_min(nrm, _EPS))
    return (nrm > limit).to(torch.float32), scale


def clip_update(delta: dict, clip: float):
    """L2-clip one client's update tree to norm ``clip``.

    Returns ``(clipped delta, was_clipped {0., 1.}, scale)`` — norm and scale
    in fp32 whatever the leaf dtype."""
    was, scale = _clip(tree_sqnorm(delta), clip)
    return _scaled(delta, scale), was, scale


def dp_clip_cohort(deltas: dict, fl):
    """Clip a slot-order ``[C]`` delta stack to ``fl.dp_clip`` per slot.

    Same math as :func:`clip_update`, slot by slot.  Returns ``(clipped
    stack, clipped indicator [C], scale [C])``."""
    was, scale = _clip(slot_sqnorms(deltas), fl.dp_clip)
    return _scaled(deltas, scale), was, scale


def dp_clip_transform(loss_fn, fl) -> ClientTransform:
    """``"dp_clip"`` chain link: clip the *shipped* update to ``fl.dp_clip``
    (a ``finalize_delta`` hook — per-step directions are untouched).  In the
    cohort step (``end.steps`` is [C]) each slot is clipped by its own
    norm."""
    limit = float(fl.dp_clip)
    if not limit > 0:
        raise ValueError(
            f"client transform 'dp_clip' needs fl.dp_clip > 0 (the per-update "
            f"L2 sensitivity bound), got {limit!r}")

    def finalize_delta(end, delta):
        if end is not None and torch.as_tensor(end.steps).dim() > 0:
            was, scale = _clip(slot_sqnorms(delta), limit)
            return _scaled(delta, scale)
        return clip_update(delta, limit)[0]

    return ClientTransform(name="dp_clip", init=lambda params: {},
                           update=lambda step, d, carry, cstate: (d, carry),
                           finalize_delta=finalize_delta)


register_client_transform("dp_clip", dp_clip_transform)


def noise_key(seed: int, rnd, device=None) -> torch.Tensor:
    """The round's DP-noise stream key — ``[1]`` (a uint32 value in int64),
    per (seed, round)."""
    base = stream_key_torch(seed, torch.zeros(1, dtype=torch.int64, device=device), int(rnd))
    return key_combine_torch(key_combine_torch(base, TAG_PRIVACY), SUB_DP_NOISE)


def noise_uniforms(key: torch.Tensor, n: int, start: int = 0):
    """The two fp32 uniform streams in (0, 1) behind the normals at element
    counters ``start .. start + n - 1`` of a leaf key: ``(u1, u2)``."""
    ctr = torch.arange(start, start + n, dtype=torch.int64, device=key.device)
    ka = key_combine_torch(key.reshape(1), ctr)                       # [n]
    kb = key_combine_torch(ka, 1)
    # (u + 0.5) / 2^32 lands strictly inside (0, 1): log / cos stay finite
    return tuple((fmix32_torch(k).to(torch.float32) + 0.5) * float(2.0 ** -32) for k in (ka, kb))


def _std_normal(key: torch.Tensor, n: int, start: int = 0) -> torch.Tensor:
    """Counter-based standard normals: Box–Muller over :func:`noise_uniforms`
    ([n] fp32)."""
    u1, u2 = noise_uniforms(key, max(1, n), start)
    z = torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(float(np.float32(2.0 * np.pi)) * u2)
    return z[:n]


def add_dp_noise(delta_agg: dict, coeff, valid, fl, rnd):
    """Add the round's Gaussian noise to the aggregated update.

    ``sigma = dp_noise_mult * dp_clip * max_i(valid_i * |coeff_i|)`` — the
    exact L2 sensitivity of the weighted sum under per-client clipping.
    Returns ``(noisy aggregate, sigma)``; leaf ``i`` of the JAX package's
    tree draws from ``key_combine(noise_key, i)`` over its flat positions."""
    f32 = torch.float32
    top = torch.max(valid.to(f32) * torch.abs(coeff.to(f32)))
    sigma = torch.full_like(top, fl.dp_noise_mult) * (torch.full_like(top, fl.dp_clip) * top)
    key = noise_key(fl.seed, rnd, coeff.device)
    out = {}
    for i, (_, names) in enumerate(wire_layout(delta_agg)):
        lk = key_combine_torch(key, i)
        off = 0
        for name in names:
            leaf = delta_agg[name]
            n = math.prod(leaf.shape)
            z = _std_normal(lk, n, off).reshape(leaf.shape)
            out[name] = (leaf.to(f32) + sigma * z).to(leaf.dtype)
            off += n
    return {k: out[k] for k in delta_agg}, sigma
