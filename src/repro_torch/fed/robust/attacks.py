"""Adversarial-client attack models applied to the slot-order delta stack.

A Byzantine client does not follow the protocol: whatever it *computed*
locally, what it *ships* is adversarial.  Attacks rewrite the cohort's
stacked slot-order ``[C]`` delta tree **before** the uplink codec encodes
it, so adversaries control their wire payload exactly (a sign-flipped
update is quantized like any honest one).

The adversary *set* is drawn counter-based per ``(seed, client)`` through
the rr_perm hash chain under the robust domain tag.  Membership is
round-independent — a compromised device stays compromised — and a pure
function of the client id, so the legacy path, the cohort engine, the
prefetch thread and a checkpoint resume all replay the identical set.
Per-round attack randomness (``scaled_noise``) folds the round into its own
key, so resumes replay noise bitwise.  The hash math is the JAX package's
uint32 arithmetic held in int64 tensors and masked to 32 bits
(``kernels.rr_perm.ref``'s plain torch version), on the tensors' device:
masks, keys and noise are bitwise equal to JAX's on any device.

Registered attacks (``ATTACKS``; extensible via :func:`register_attack`) —
each is ``attack(deltas, adv, meta, keys, fl) -> deltas`` over the stacked
``[C, ...]`` dict, where ``adv`` is the per-slot adversary mask (already
masked by ``meta.valid``) and ``keys`` the per-slot round keys:

* ``sign_flip``    — ship ``-attack_scale * Delta_i`` (gradient ascent).
* ``zero_update``  — ship zeros (free-riding / update withholding).
* ``scaled_noise`` — ship ``attack_scale * U[-1, 1)`` per coordinate from
  the counter-based stream, keyed by the JAX package's leaf index and
  flat position (the wire view, ``utils.pytree.to_wire``).
* ``ipm``          — inner-product manipulation (Xie et al. 2020): every
  adversary ships ``-attack_scale *`` the honest cohort mean.

With ``fl.attack == "none"`` the round driver never calls into this
module.  The port's counterpart of ``repro.fed.robust.attacks``.
"""
from __future__ import annotations

from typing import Callable

import torch

from ...configs.base import FLConfig
from ...kernels.rr_perm.ref import fmix32_torch, key_combine_torch, stream_key_torch
from ...utils.pytree import from_wire, to_wire
from ...utils.tags import SUB_ROBUST_ADVERSARY, SUB_ROBUST_NOISE, TAG_ROBUST

# per-use subtags folded in after the robust tag (one stream per purpose)
SUB_ADVERSARY = SUB_ROBUST_ADVERSARY  # adversary-set membership (round-independent)
SUB_NOISE = SUB_ROBUST_NOISE          # per-round attack noise stream

_TWO32 = float(2**32)


def _ids(client_ids) -> torch.Tensor:
    """Client ids as a >= 1-d int64 tensor (a padding slot's -1 folds into
    the hash as 0xFFFFFFFF, as JAX's uint32 cast does)."""
    return torch.as_tensor(client_ids).to(torch.int64).reshape(-1)


def _unit(key: torch.Tensor) -> torch.Tensor:
    """U[0, 1) in fp32 from uint32 keys held in int64: fmix32 / 2^32."""
    return fmix32_torch(key).to(torch.float32) / _TWO32


def adversary_mask(seed: int, client_ids, frac: float) -> torch.Tensor:
    """Counter-based adversary membership per ``(seed, client)`` — [C] f32
    on the ids' device, bitwise equal to JAX's ``adversary_mask``."""
    ids = _ids(client_ids)
    key = stream_key_torch(seed, ids, 0)
    key = key_combine_torch(key, TAG_ROBUST)
    key = key_combine_torch(key, SUB_ADVERSARY)
    frac32 = torch.tensor(frac, dtype=torch.float32, device=ids.device)
    return (_unit(key) < frac32).to(torch.float32)


def attack_round_keys(seed: int, client_ids, rnd) -> torch.Tensor:
    """Per-slot attack-noise keys for one round ([C] int64, uint32 values),
    keyed off the absolute round counter so a resume replays identical
    noise."""
    key = stream_key_torch(seed, _ids(client_ids), int(rnd))
    key = key_combine_torch(key, TAG_ROBUST)
    return key_combine_torch(key, SUB_NOISE)


def _unit_noise(keys: torch.Tensor, like: torch.Tensor, leaf_idx: int) -> torch.Tensor:
    """Counter-based U[-1, 1) of ``like``'s stacked shape ([C, ...]): slot
    c's element at flat position j hashes (keys[c], leaf_idx, j).  Made a
    slot at a time, so the int64 hash temporaries stay one slot's size."""
    n = max(1, like[0].numel())
    pos = torch.arange(n, dtype=torch.int64, device=like.device)
    ks = key_combine_torch(keys.to(like.device), leaf_idx)
    rows = [2.0 * _unit(key_combine_torch(k.reshape(1), pos)) - 1.0 for k in ks]
    return torch.stack(rows).reshape(like.shape)


def _bcast(v: torch.Tensor, ndim: int) -> torch.Tensor:
    """[C] -> [C, 1, ..., 1] for broadcasting against a stacked leaf."""
    return v.reshape((-1,) + (1,) * (ndim - 1))


def _blend(deltas: dict, adv: torch.Tensor, attacked: Callable) -> dict:
    """Adversary slots take ``attacked(name, d)``, honest slots keep ``d``
    (one leaf at a time, so a full-width stack holds one leaf's copy)."""
    return {k: torch.where(_bcast(adv, d.dim()) > 0, attacked(k, d).to(d.dtype), d)
            for k, d in deltas.items()}


def _sign_flip(deltas, adv, meta, keys, fl: FLConfig):
    scale = torch.tensor(-fl.attack_scale, dtype=torch.float32, device=adv.device)
    return _blend(deltas, adv, lambda k, d: scale * d.float())


def _zero_update(deltas, adv, meta, keys, fl: FLConfig):
    return _blend(deltas, adv, lambda k, d: torch.zeros_like(d))


def _scaled_noise(deltas, adv, meta, keys, fl: FLConfig):
    scale = torch.tensor(fl.attack_scale, dtype=torch.float32, device=adv.device)
    noise = from_wire([(path, scale * _unit_noise(keys, w, i))
                       for i, (path, w) in enumerate(to_wire(deltas))], deltas)
    return _blend(deltas, adv, lambda k, d: noise[k])


def _ipm(deltas, adv, meta, keys, fl: FLConfig):
    # unweighted mean over the honest valid slots — the attacker's estimate
    # of the descent direction it wants to negate
    honest = meta.valid * (1.0 - (adv > 0).to(torch.float32))          # [C]
    w = honest / torch.clamp_min(honest.sum(), 1.0)
    scale = torch.tensor(-fl.attack_scale, dtype=torch.float32, device=adv.device)
    return _blend(deltas, adv, lambda k, d: (
        scale * torch.einsum("c,c...->...", w, d.float())).expand(d.shape))


ATTACKS: dict[str, Callable] = {
    "sign_flip": _sign_flip,
    "zero_update": _zero_update,
    "scaled_noise": _scaled_noise,
    "ipm": _ipm,
}


def register_attack(name: str, attack: Callable, *, overwrite: bool = False) -> None:
    """Register ``attack(deltas, adv, meta, keys, fl) -> deltas`` under
    ``name`` (the ``FLConfig.attack`` key)."""
    if not overwrite and name in ATTACKS:
        raise ValueError(
            f"attack {name!r} already registered (pass overwrite=True to replace)")
    ATTACKS[name] = attack


def build_attack(fl: FLConfig) -> Callable | None:
    """Resolve ``fl.attack`` to ``apply_attack(deltas, meta, rnd)`` over the
    stacked deltas; None when no attack runs (the frozen default path)."""
    if fl.attack == "none":
        return None
    if fl.attack not in ATTACKS:
        raise ValueError(f"unknown attack {fl.attack!r}; have {sorted(ATTACKS)}")
    fn = ATTACKS[fl.attack]

    def apply_attack(deltas, meta, rnd):
        adv = adversary_mask(fl.seed, meta.client_id, fl.attack_frac) * meta.valid
        keys = attack_round_keys(fl.seed, meta.client_id, rnd)
        return fn(deltas, adv, meta, keys, fl)

    return apply_attack
