"""Stateless RR index generation: the swap-or-not cipher, numpy and plain torch.

The paper's random reshuffling needs one fresh permutation of [0, n_i) per
(client, round, epoch).  Here the permutation is a counter-based cipher:
position ``j`` of the epoch stream maps to ``SoN_K(j)``, where ``SoN`` is the
Hoang–Morris–Rogaway swap-or-not shuffle, an exact permutation of [0, n) for
any n.  Each round ``r`` draws a key ``K_r in [0, n)``, pairs ``x`` with
``(K_r - x) mod n`` and swaps the pair iff a hash bit of the pair's larger
element says so.

Two implementations of the same uint32 arithmetic:

* the **numpy mirror** (``fmix32`` … ``rr_indices``): native uint32 with
  wraparound, the host reference every other version is held to bitwise;
* the **plain torch version** (``*_torch``): torch has no uint32 add, shift
  or modulo on the CPU, so it holds each uint32 in an int64 and masks with
  ``& 0xFFFFFFFF`` after every add and left shift.  A product of two 32-bit
  values can exceed 2^63, so multiplications split the constant into 16-bit
  halves and never overflow.  It runs on any device; the CPU tests and the
  kernel check on the card use it, the main path on a card does not.

The CUDA kernel (``kernel.py``, ``csrc/rr_perm.cu``) computes the same
function.
"""
from __future__ import annotations

import numpy as np
import torch

from ...utils.tags import TAG_RR

_INIT = 0x9E3779B9     # golden-ratio seed of the key chain
_M32 = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# numpy mirror (uint32 with native wraparound)
# ---------------------------------------------------------------------------


def fmix32(h):
    """murmur3 finalizer — the 32-bit avalanche at the core of every hash."""
    dt = np.uint32
    h = h ^ (h >> dt(16))
    h = h * dt(0x85EBCA6B)
    h = h ^ (h >> dt(13))
    h = h * dt(0xC2B2AE35)
    h = h ^ (h >> dt(16))
    return h


def key_combine(h, v):
    """Fold one more value into a running uint32 key (boost::hash_combine)."""
    dt = np.uint32
    # >= 1-d on purpose: numpy demotes 0-d arrays to scalars, whose ufuncs
    # warn on the wraparound this hash relies on
    v = np.atleast_1d(np.asarray(v)).astype(dt)
    return fmix32(h ^ (v + dt(_INIT) + (h << dt(6)) + (h >> dt(2))))


def stream_key(seed: int, client, rnd):
    """The (seed, client, round) part of the key chain; epoch folds in later."""
    dt = np.uint32
    h = fmix32(np.atleast_1d(np.asarray((_INIT ^ TAG_RR) & _M32, dt)))
    h = key_combine(h, np.asarray(seed & _M32, dt))
    h = key_combine(h, client)
    return key_combine(h, rnd)


def swap_or_not(x, n, key, rounds: int):
    """Apply the cipher to ``x`` (uint32, < n) under per-element ``key``;
    ``n`` < 2^31 so ``kr + n - x`` cannot wrap.  Returns uint32 in [0, n)."""
    dt = np.uint32
    for r in range(rounds):
        kr_key = key_combine(key, dt(r))
        kr = fmix32(kr_key) % n
        partner = (kr + n - x) % n
        canon = np.maximum(x, partner)
        bit = key_combine(kr_key, canon) & dt(1)
        x = np.where(bit == dt(1), partner, x)
    return x


def permutation_np(seed: int, client: int, rnd: int, epoch: int, n: int,
                   rounds: int = 24) -> np.ndarray:
    """The full epoch permutation as a host array (numpy mirror)."""
    key = key_combine(stream_key(seed, np.uint32(client & _M32),
                                 np.uint32(rnd & _M32)),
                      np.uint32(epoch & _M32))
    x = np.arange(n, dtype=np.uint32)
    return swap_or_not(x, np.uint32(n), key, rounds).astype(np.int64)


def rr_indices(prekey, sizes, spe, B: int, K: int, *, rounds: int = 24,
               mode: str = "rr") -> np.ndarray:
    """Index matrices [C, K, B] int32 for a whole cohort (numpy mirror).

    prekey [C] uint32 — ``stream_key(seed, client, rnd)`` per slot;
    sizes [C] int32 (>= 1); spe [C] int32 steps-per-epoch (>= 1).  Step k
    has epoch ``e = k // spe`` and position ``p = (k % spe) * B + b``.
    mode "rr": ``SoN(p mod n)``, every epoch one full pass with the tail of
    the last partial batch re-wrapped within the epoch's permutation; mode
    "wr": i.i.d. with replacement, one hash per position.
    """
    if mode not in ("rr", "wr"):
        raise ValueError(mode)
    dt = np.uint32
    sizes, spe = np.asarray(sizes), np.asarray(spe)
    k = np.arange(K, dtype=np.int32)[None, :]
    e = k // spe[:, None]
    b = np.arange(B, dtype=np.int32)[None, None, :]
    flat = ((k % spe[:, None])[:, :, None] * np.int32(B) + b).astype(dt)
    key_ce = key_combine(np.asarray(prekey, dt)[:, None], e.astype(dt))[:, :, None]
    n3 = sizes[:, None, None].astype(dt)
    if mode == "wr":
        return (fmix32(key_combine(key_ce, flat)) % n3).astype(np.int32)
    return swap_or_not(flat % n3, n3, key_ce, rounds).astype(np.int32)


# ---------------------------------------------------------------------------
# plain torch (each uint32 held in an int64, masked to 32 bits)
# ---------------------------------------------------------------------------


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """``h * c mod 2^32`` for h in [0, 2^32) without int64 overflow."""
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def fmix32_torch(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def key_combine_torch(h: torch.Tensor, v: "torch.Tensor | int") -> torch.Tensor:
    v = v & _M32 if isinstance(v, int) else v.to(torch.int64) & _M32
    return fmix32_torch(h ^ ((v + _INIT + ((h << 6) & _M32) + (h >> 2)) & _M32))


def stream_key_torch(seed: int, client: torch.Tensor, rnd) -> torch.Tensor:
    """``stream_key`` over int64 tensors: ``client`` [C] (a padding slot's
    -1 folds in as 0xFFFFFFFF, as the uint32 cast does) and the round
    ``rnd``.  Returns [C] int64 in [0, 2^32)."""
    h0 = int(fmix32(np.atleast_1d(np.asarray((_INIT ^ TAG_RR) & _M32, np.uint32)))[0])
    h = torch.full(client.shape, h0, dtype=torch.int64, device=client.device)
    h = key_combine_torch(h, seed & _M32)
    h = key_combine_torch(h, client)
    return key_combine_torch(h, int(rnd))


def swap_or_not_torch(x: torch.Tensor, n, key: torch.Tensor, rounds: int) -> torch.Tensor:
    """``swap_or_not`` over int64 tensors holding uint32 values: ``x`` < n,
    ``n`` and ``key`` broadcast against ``x``.  Returns int64 in [0, n)."""
    for r in range(rounds):
        kr_key = key_combine_torch(key, r)
        kr = fmix32_torch(kr_key) % n
        partner = (kr + n - x) % n
        bit = key_combine_torch(kr_key, torch.maximum(x, partner)) & 1
        x = torch.where(bit == 1, partner, x)
    return x


def rr_indices_torch(prekey: torch.Tensor, sizes: torch.Tensor, spe: torch.Tensor,
                     B: int, K: int, rounds: int = 24, mode: str = "rr") -> torch.Tensor:
    """The plain torch version of the kernel: [C] int64 ``prekey`` (values
    in [0, 2^32)), int32 ``sizes`` and ``spe`` -> [C, K, B] int32, on the
    tensors' device.  ``sizes`` and ``spe`` are clamped to >= 1, as the
    kernel clamps them."""
    if mode not in ("rr", "wr"):
        raise ValueError(mode)
    dev = prekey.device
    n = sizes.to(torch.int64).clamp_min(1)[:, None, None]
    s = spe.to(torch.int64).clamp_min(1)[:, None]
    k = torch.arange(K, dtype=torch.int64, device=dev)[None, :]
    e = torch.div(k, s, rounding_mode="floor")                    # [C, K]
    b = torch.arange(B, dtype=torch.int64, device=dev)[None, None, :]
    flat = (k - e * s)[:, :, None] * B + b                        # [C, K, B]
    key = key_combine_torch(prekey.to(torch.int64)[:, None], e)[:, :, None]
    if mode == "wr":
        return (fmix32_torch(key_combine_torch(key, flat)) % n).to(torch.int32)
    return swap_or_not_torch(flat % n, n, key, rounds).to(torch.int32)
