"""Stochastic quantization for the comm plane: numpy mirror and plain torch.

The qsgd codec's hot path (both wire directions): chunks of ``chunk``
consecutive values each carry one fp32 scale, the chunk's max-abs, and every
value is rounded *stochastically* to one of ``2^bits - 1`` signed levels

    q = clip(floor(|v| * (L / scale) + u), 0, L),   L = 2^(bits-1) - 1

with ``u in [0, 1]`` drawn from a counter-based hash of (chunk key, position)
— the murmur3 chain of ``kernels.rr_perm``, so the random bits are stateless
and identical in every version.  The signed levels ``sign(v) * q`` are
biased to ``[0, 2L]`` and packed ``8 // bits`` to the byte: the packed uint8
array and the per-chunk scales are the wire format.  The inverse is
``((lv - L) * scale) * (1/L)``, exact on all-zero chunks.

Two implementations of the same IEEE fp32 / uint32 arithmetic:

* the **numpy mirror** (``quantize_pack`` / ``unpack_dequantize`` over
  ``[nc, chunk]`` arrays): the port's copy of the JAX package's ``ref.py``
  with ``xp=np``, the host reference every other version is held to bitwise;
* the **plain torch version** (``*_torch`` over ``[R, n]`` rows of any
  length): the keys are uint32 values held in int64 and hashed with
  ``key_combine_torch``; the int64 -> fp32 conversion rounds to nearest
  even, as numpy's uint32 -> fp32 does; multiply and add are separate ops
  (never fused: a fused ``a * inv + u`` moves ``floor`` at level boundaries
  and changes the bytes); and ``L / scale`` is a tensor-by-tensor division
  (torch's ``scalar / tensor`` multiplies by a reciprocal, which rounds
  differently).  A row's ragged tail is padded with zeros, which leaves
  its scale and its bytes as the mirror computes them for the padded chunk.
  It works a slice of chunks at a time, so its int64 temporaries stay small
  at any size.

The CUDA kernels (``kernel.py``, ``csrc/quantize.cu``) compute the same
bytes.  Inputs are finite; NaN and inf are not part of the contract.
"""
from __future__ import annotations

import numpy as np
import torch

from ..rr_perm.ref import key_combine, key_combine_torch

BITS_CHOICES = (2, 4, 8)
_SLICE_VALUES = 1 << 24      # values per slice of the plain torch version


def levels(bits: int) -> int:
    """L = 2^(bits-1) - 1, the largest level magnitude."""
    if bits not in BITS_CHOICES:
        raise ValueError(f"uplink bits must be one of {BITS_CHOICES}, got {bits}")
    return 2 ** (bits - 1) - 1


def packed_width(chunk: int, bits: int) -> int:
    """Bytes per packed chunk (``chunk`` values at ``bits`` bits each)."""
    per = 8 // bits
    if chunk % per:
        raise ValueError(f"chunk ({chunk}) must be a multiple of {per} for {bits}-bit packing")
    return chunk // per


def num_chunks(n: int, chunk: int) -> int:
    return -(-n // chunk)


# ---------------------------------------------------------------------------
# numpy mirror
# ---------------------------------------------------------------------------


def pack_levels(lv, bits: int):
    """Biased levels [..., chunk] uint8 in [0, 2L] -> packed [..., chunk//per];
    element ``j`` of a byte-group is shifted by ``bits * j``."""
    per = 8 // bits
    chunk = lv.shape[-1]
    lv3 = lv.reshape(lv.shape[:-1] + (packed_width(chunk, bits), per))
    packed = lv3[..., 0]
    for j in range(1, per):
        packed = packed | (lv3[..., j] << np.uint8(bits * j))
    return packed


def unpack_levels(packed, chunk: int, bits: int):
    """Packed bytes [..., chunk//per] -> biased levels [..., chunk] uint8."""
    per = 8 // bits
    mask = np.uint8(2**bits - 1)
    lv = np.stack([(packed >> np.uint8(bits * j)) & mask for j in range(per)], axis=-1)
    return lv.reshape(lv.shape[:-2] + (chunk,))


def quantize_pack(v2, keys, bits: int):
    """[nc, chunk] f32 + per-chunk keys [nc] uint32 -> (packed uint8
    [nc, chunk // (8//bits)], scale f32 [nc])."""
    L = np.float32(levels(bits))
    chunk = v2.shape[1]
    a = np.abs(v2)
    scale = a.max(axis=1)
    safe = np.where(scale > 0, scale, np.float32(1.0))
    inv = np.where(scale > 0, L / safe, np.float32(0.0))
    x = a * inv[:, None]
    pos = np.arange(chunk, dtype=np.uint32)[None, :]
    u = key_combine(keys[:, None], pos).astype(np.float32) * np.float32(2.0**-32)
    q = np.clip(np.floor(x + u), np.float32(0.0), L)
    lv = np.where(v2 < 0, L - q, L + q).astype(np.uint8)
    return pack_levels(lv, bits), scale


def unpack_dequantize(packed, scale, chunk: int, bits: int):
    """Inverse of :func:`quantize_pack`: -> f32 [nc, chunk]."""
    L = np.float32(levels(bits))
    lv = unpack_levels(packed, chunk, bits).astype(np.float32)
    return (lv - L) * scale[:, None] * (np.float32(1.0) / L)


# ---------------------------------------------------------------------------
# plain torch (uint32 keys held in int64)
# ---------------------------------------------------------------------------


def _quantize_chunks(v2: torch.Tensor, keys: torch.Tensor, bits: int):
    """[m, chunk] f32 + [m] int64 keys -> (packed [m, pb] uint8, scale [m])."""
    L = float(levels(bits))
    m, chunk = v2.shape
    a = v2.abs()
    scale = a.amax(dim=1)
    nonzero = scale > 0
    safe = torch.where(nonzero, scale, torch.ones_like(scale))
    inv = torch.where(nonzero, torch.div(torch.full_like(safe, L), safe), torch.zeros_like(scale))
    x = a * inv[:, None]
    p = torch.arange(chunk, dtype=torch.int64, device=v2.device)[None, :]
    u = key_combine_torch(keys[:, None], p).to(torch.float32) * 2.0**-32
    q = torch.clamp(torch.floor(x + u), 0.0, L)
    lv = torch.where(v2 < 0, L - q, L + q).to(torch.uint8)
    per = 8 // bits
    lv3 = lv.reshape(m, packed_width(chunk, bits), per)
    packed = lv3[..., 0]
    for j in range(1, per):
        packed = packed | (lv3[..., j] << (bits * j))
    return packed, scale


def quantize_pack_torch(v: torch.Tensor, keys: torch.Tensor, *, chunk: int, bits: int):
    """[R, n] f32 rows + per-chunk keys [R, nc] (int64, values in
    [0, 2^32)) -> (packed uint8 [R, nc, pb], scale f32 [R, nc]), with
    ``nc = ceil(n / chunk)`` and ``pb = chunk * bits / 8``."""
    R, n = v.shape
    nc, pb = num_chunks(n, chunk), packed_width(chunk, bits)
    if keys.shape != (R, nc):
        raise ValueError(f"keys must be [{R}, {nc}], got {tuple(keys.shape)}")
    v2 = torch.nn.functional.pad(v.float(), (0, nc * chunk - n)).reshape(R * nc, chunk)
    k = keys.to(torch.int64).reshape(R * nc)
    packed = torch.empty((R * nc, pb), dtype=torch.uint8, device=v.device)
    scale = torch.empty((R * nc,), dtype=torch.float32, device=v.device)
    step = max(1, _SLICE_VALUES // chunk)
    for s in range(0, R * nc, step):
        packed[s:s + step], scale[s:s + step] = _quantize_chunks(v2[s:s + step], k[s:s + step], bits)
    return packed.reshape(R, nc, pb), scale.reshape(R, nc)


def unpack_dequantize_torch(packed: torch.Tensor, scale: torch.Tensor, *, n: int,
                            chunk: int, bits: int) -> torch.Tensor:
    """(packed [R, nc, pb] uint8, scale [R, nc] f32) -> [R, n] f32."""
    L = np.float32(levels(bits))
    R, nc, pb = packed.shape
    if pb != packed_width(chunk, bits) or nc != num_chunks(n, chunk):
        raise ValueError(f"packed {tuple(packed.shape)} does not hold n={n} values "
                         f"at chunk={chunk}, bits={bits}")
    per, mask = 8 // bits, 2**bits - 1
    lv = torch.stack([(packed >> (bits * j)) & mask for j in range(per)], dim=-1)
    lv = lv.reshape(R, nc, chunk).to(torch.float32)
    out = (lv - float(L)) * scale[..., None] * float(np.float32(1.0) / L)
    return out.reshape(R, nc * chunk)[:, :n]
