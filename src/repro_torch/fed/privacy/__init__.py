"""Privacy plane: DP-FedShuffle + secure-aggregation simulation.

Off by default: with ``fl.dp="off"`` and ``fl.secagg="off"`` the round step
adds no op and no metric key, and its ServerState is the plane-off code's,
bitwise — across presets, cohort modes, execution layouts, codecs and the
buffered fleet (``tests/test_torch_privacy.py``).

Three layers (see each module's docstring):

* ``dp.py`` — per-client L2 clipping (driver path + ``"dp_clip"``
  ClientTransform) and counter-based server Gaussian noise;
* ``accountant.py`` — host-side RDP eps(delta) under subsampling
  amplification, pure-function-of-round so resume is bitwise;
* ``secagg.py`` — pairwise antisymmetric masks in uint32 fixed point with
  exact modular cancellation and dropout recovery.

``validate_privacy_config`` runs at bind time (``bind_strategy``) whenever
the plane is active; it owns the cross-knob rejections — most notably the
ambiguous ``local_clip`` + ``dp`` composition.  The port's counterpart of
``repro.fed.privacy``.
"""
from __future__ import annotations

from .accountant import (DEFAULT_ORDERS, RDPAccountant, accountant_for,
                         check_dp_resume, dp_checkpoint_record,
                         rdp_subsampled_gaussian, sampling_rate)
from .dp import (add_dp_noise, clip_update, dp_clip_cohort, dp_clip_transform, noise_key,
                 noise_uniforms)
from .secagg import (fixed_point_decode, fixed_point_encode, mask_matrix, pair_keys,
                     secagg_chunks, secagg_combine, secagg_payloads, secagg_reference)

_DP = ("off", "on")
_SECAGG = ("off", "pairwise")


def dp_active(fl) -> bool:
    """True when the DP mechanism (clip + noise + accountant) is on."""
    return getattr(fl, "dp", "off") != "off"


def secagg_active(fl) -> bool:
    """True when the pairwise-mask secure-aggregation layer is on."""
    return getattr(fl, "secagg", "off") != "off"


def privacy_active(fl) -> bool:
    """True when any privacy-plane feature leaves the frozen default."""
    return dp_active(fl) or secagg_active(fl)


def validate_privacy_config(fl, *, transform_names: tuple = ()) -> None:
    """Bind-time validation of the privacy knobs (called when active).

    ``transform_names`` is the resolved local-update chain — needed to
    reject the ambiguous per-step-clip + DP-clip composition.
    """
    if fl.dp not in _DP:
        raise ValueError(f"fl.dp must be one of {_DP}, got {fl.dp!r}")
    if fl.secagg not in _SECAGG:
        raise ValueError(f"fl.secagg must be one of {_SECAGG}, got {fl.secagg!r}")
    if dp_active(fl):
        if not fl.dp_clip > 0:
            raise ValueError(
                f"fl.dp='on' needs fl.dp_clip > 0 (the per-update L2 "
                f"sensitivity bound), got {fl.dp_clip!r}")
        if not fl.dp_noise_mult > 0:
            raise ValueError(
                f"fl.dp='on' needs fl.dp_noise_mult > 0 (the Gaussian noise "
                f"multiplier z the accountant converts to epsilon), got "
                f"{fl.dp_noise_mult!r}")
        if not 0 < fl.dp_delta < 1:
            raise ValueError(
                f"fl.dp='on' needs fl.dp_delta in (0, 1), got {fl.dp_delta!r}")
        if "clip" in transform_names:
            raise ValueError(
                "ambiguous clipping composition: the bound local update "
                "chain includes the per-step 'clip' transform (bound to "
                f"fl.clip_norm={fl.clip_norm!r}) while fl.dp='on' adds "
                f"per-update DP clipping (fl.dp_clip={fl.dp_clip!r}).  Two "
                "different clip bounds would silently stack, and the DP "
                "sensitivity analysis only covers dp_clip — drop 'clip' "
                "from fl.local_update (DP clipping alone bounds the shipped "
                "update) or keep 'clip' and set fl.dp='off'")
    if secagg_active(fl):
        if not 1 <= fl.secagg_bits <= 30:
            raise ValueError(
                f"fl.secagg_bits must be in [1, 30] (fractional bits of the "
                f"uint32 fixed-point domain; >30 leaves no integer headroom "
                f"for the modular sum), got {fl.secagg_bits!r}")
        if fl.aggregator != "mean":
            raise ValueError(
                f"fl.secagg='pairwise' requires fl.aggregator='mean': the "
                f"server only ever sees the blinded modular sum, so robust "
                f"estimators over per-client updates (got "
                f"{fl.aggregator!r}) have nothing to operate on")
        if fl.guard in ("quarantine", "full"):
            raise ValueError(
                f"fl.secagg='pairwise' is incompatible with per-client "
                f"quarantine guards (fl.guard={fl.guard!r}): quarantine "
                f"inspects individual updates the masking hides; use "
                f"fl.guard='reject' (server-level) or 'off'")


__all__ = [
    "DEFAULT_ORDERS", "RDPAccountant", "accountant_for", "add_dp_noise",
    "check_dp_resume", "clip_update", "dp_active", "dp_checkpoint_record",
    "dp_clip_cohort", "dp_clip_transform", "fixed_point_decode",
    "fixed_point_encode", "mask_matrix", "noise_key", "noise_uniforms", "pair_keys",
    "privacy_active", "rdp_subsampled_gaussian", "sampling_rate",
    "secagg_active", "secagg_chunks", "secagg_combine", "secagg_payloads",
    "secagg_reference",
    "validate_privacy_config",
]
