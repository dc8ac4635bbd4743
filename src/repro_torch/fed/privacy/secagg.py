"""Seeded pairwise-mask secure-aggregation simulation (modular arithmetic).

Simulates the Bonawitz et al. (2017) pairwise-masking protocol on the
slot-order ``[C]`` delta stack, with the cryptography (key agreement, secret
sharing) replaced by the repo's counter-based hash chain: the pair key for
clients ``(i, j)`` is ``stream_key(seed, min(i,j), round)`` with the privacy
tag + secagg-mask subtag folded in, then ``max(i,j)``, so both ends of a
pair — and the server, for dropout recovery — derive the same mask without
any state or communication.

Masks only cancel *exactly* in an exact-arithmetic domain, so the layer runs
in uint32 modular fixed point:

1. each client's weighted update ``coeff_i * delta_i`` is encoded with
   ``fl.secagg_bits`` fractional bits (round-to-nearest-even, clamp to the
   int32 range, reinterpret as uint32 — two's-complement wraparound);
2. client ``i`` ships ``enc_i + sum_j dispatched_j * m(i, j)  (mod 2^32)``
   where ``m(i, j) = -m(j, i)`` and ``m(i, i) = 0``;
3. the server adds the surviving (valid) payloads mod 2^32; for
   fleet-dropped clients — who masked nobody but whom survivors masked
   *against* — it reconstructs their pairwise shares from the same chain and
   subtracts them (the protocol's dropout-recovery path);
4. every mask term now appears exactly once with each sign, so the modular
   sum equals ``sum_valid enc_i`` bitwise, and decoding yields the
   fixed-point-quantized weighted aggregate.

The codec roundtrip runs first on the real-valued deltas and this layer
encodes what survives it (quantize-then-mask).  The simulation reproduces
the arithmetic and the dropout-recovery dataflow, not key agreement, share
verification or malicious-server security.

The port's counterpart of ``repro.fed.privacy.secagg``.  Torch has no
uint32 arithmetic on the CPU, so every uint32 is held in an int64 tensor in
[0, 2^32) and masked with ``& 0xFFFFFFFF`` (the hash chain is
``kernels.rr_perm.ref``'s plain torch version).  A mask's counter is the
element's flat position in the JAX package's leaf (the wire view,
``utils.pytree.wire_layout``: a layer-stacked leaf is its layers
concatenated) and its leaf index is the JAX leaf's, so encodings, masks,
payloads and the aggregate are bitwise the JAX package's.

Memory: the JAX package materializes ``[C, C, n]`` masks a leaf.
:func:`secagg_payloads` does the same (tests' sizes);
:func:`secagg_combine`, the round's path, walks each leaf in chunks of the
counter axis and forms the masks of the pairs ``i < j`` only (``m(j, i)``
is the negation), [P, chunk] at a time.  Each coordinate's modular sum is
independent and exact, so the chunking and the order of the integer sums
change no bit.  The per-client mask sums and the recovery sums are
products of small-integer matrices with the masks, taken in float64: every
partial sum is an integer below 2^53, so they are exact.
"""
from __future__ import annotations

import math
from typing import Iterator

import torch

from ...kernels.rr_perm.ref import fmix32_torch, key_combine_torch, stream_key_torch
from ...utils.pytree import to_wire, wire_layout
from ...utils.tags import SUB_SECAGG_MASK, TAG_PRIVACY

# largest float32-exact clamp bound safely inside int32: 2^31 - 128
_CLAMP = 2147483520.0
_M32 = 0xFFFFFFFF
_TWO31 = 1 << 31
# counter positions a chunk of secagg_combine covers: its [P, CHUNK] int64
# masks are 224 MB at a cohort of 8 (P = 28 pairs)
CHUNK = 1 << 20


def fixed_point_encode(x: torch.Tensor, bits: int) -> torch.Tensor:
    """float32 -> uint32 two's-complement fixed point with ``bits``
    fractional bits (round-half-even, clamped to the int32 range), held in
    int64."""
    scaled = torch.round(x.to(torch.float32) * float(2.0 ** bits))
    scaled = torch.clamp(scaled, -_CLAMP, _CLAMP)
    return scaled.to(torch.int32).to(torch.int64) & _M32


def fixed_point_decode(u: torch.Tensor, bits: int) -> torch.Tensor:
    """Inverse of :func:`fixed_point_encode` (modular domain -> float32)."""
    signed = ((u.to(torch.int64) + _TWO31) & _M32) - _TWO31
    return signed.to(torch.float32) * float(2.0 ** -bits)


def _ids(client_id) -> torch.Tensor:
    """Client ids as int64 uint32 values (a padding slot's -1 is 0xFFFFFFFF,
    as the JAX package's uint32 cast makes it)."""
    return torch.as_tensor(client_id).to(torch.int64).reshape(-1) & _M32


def pair_keys(seed: int, ids, rnd) -> torch.Tensor:
    """``[C, C]`` pair-mask keys (uint32 values in int64), symmetric:
    key(i, j) == key(j, i)."""
    ids = _ids(ids)
    C = ids.shape[0]
    lo = torch.minimum(ids[:, None], ids[None, :]).reshape(-1)
    hi = torch.maximum(ids[:, None], ids[None, :]).reshape(-1)
    key = stream_key_torch(seed, lo, int(rnd))
    key = key_combine_torch(key, TAG_PRIVACY)
    key = key_combine_torch(key, SUB_SECAGG_MASK)
    return key_combine_torch(key, hi).reshape(C, C)


def mask_matrix(keys: torch.Tensor, ids, leaf_idx: int, n: int) -> torch.Tensor:
    """Signed pairwise masks for one flattened leaf — ``[C, C, n]``.

    Antisymmetric mod 2^32 (``out[i, j] + out[j, i] == 0``), zero on the
    diagonal and for duplicate client ids."""
    ids = _ids(ids).to(keys.device)
    lk = key_combine_torch(keys, leaf_idx)                            # [C, C]
    ctr = torch.arange(n, dtype=torch.int64, device=keys.device)
    m = fmix32_torch(key_combine_torch(lk[:, :, None], ctr[None, None, :]))
    neg = (-m) & _M32                                                 # 0 - m mod 2^32
    signed = torch.where((ids[:, None] < ids[None, :])[:, :, None], m, neg)
    return torch.where((ids[:, None] == ids[None, :])[:, :, None], torch.zeros_like(m), signed)


def _slots(valid, dropped, coeff):
    """(weights valid * coeff [C] fp32, survived [C], dropped [C],
    dispatched [C]) — the last three int64 0/1."""
    valid_f = valid.to(torch.float32)
    drop_f = torch.zeros_like(valid_f) if dropped is None else dropped.to(torch.float32)
    disp = torch.clamp(valid_f + drop_f, 0.0, 1.0).to(torch.int64)
    return (valid_f * coeff.to(torch.float32), valid_f.to(torch.int64), drop_f.to(torch.int64),
            disp)


def secagg_payloads(deltas: dict, coeff, valid, dropped, client_id, rnd, fl) -> list:
    """Per JAX leaf ``(enc [C, n], payload [C, n], masks [C, C, n])`` — what
    each client would put on the wire, whole leaves as the JAX package forms
    them (small sizes; the round uses :func:`secagg_combine`)."""
    bits = int(fl.secagg_bits)
    coeff_v, _, _, disp = _slots(valid, dropped, coeff)
    keys = pair_keys(fl.seed, client_id, rnd).to(coeff_v.device)
    out = []
    for i, (_, x) in enumerate(to_wire(deltas)):
        enc = fixed_point_encode(coeff_v[:, None] * x.to(torch.float32), bits)
        masks = mask_matrix(keys, client_id, i, x.shape[1])
        pay = (enc + (masks * disp[None, :, None]).sum(1)) & _M32
        out.append((enc, pay, masks))
    return out


def secagg_chunks(deltas: dict, coeff, valid, dropped, client_id, rnd, fl, *,
                  chunk: int = CHUNK) -> Iterator[tuple]:
    """The protocol over ``[C]``-stacked ``deltas``, a chunk of one leaf's
    counter axis at a time: yields ``(key, start, enc [C, m], pay [C, m],
    rec [m])`` — the port key and its flat offset, the clients' encodings
    and payloads (uint32 values in int64) and the server's recovery sum of
    the shares survivors masked against dropped clients.  Keys come in the
    JAX package's leaf order, a stacked leaf's layers in order."""
    bits = int(fl.secagg_bits)
    coeff_v, surv, drop, disp = _slots(valid, dropped, coeff)
    dev = coeff_v.device
    ids = _ids(client_id).to(dev)
    C = ids.shape[0]
    keys = pair_keys(fl.seed, ids, rnd)
    iu, ju = torch.triu_indices(C, C, 1, device=dev)                  # the pairs i < j
    sign = torch.where(ids[iu] < ids[ju], 1, torch.where(ids[iu] > ids[ju], -1, 0))
    # pay_i = enc_i + sum_p A[i, p] * m_p: slot i's pair p with j adds
    # disp_j * s(i, j), where s(i, j) = sign * m_p and s(j, i) = -s(i, j)
    A = torch.zeros(C, iu.shape[0], dtype=torch.float64, device=dev)
    p = torch.arange(iu.shape[0], device=dev)
    A[iu, p] = (disp[ju] * sign).to(torch.float64)
    A[ju, p] = (-disp[iu] * sign).to(torch.float64)
    # rec = sum_{i, j} surv_i drop_j s(i, j), over the pairs
    r = ((surv[iu] * drop[ju] - surv[ju] * drop[iu]) * sign).to(torch.float64)
    for leaf_idx, (_, names) in enumerate(wire_layout(deltas)):
        lk = key_combine_torch(keys[iu, ju], leaf_idx)[:, None]          # [P, 1]
        off = 0
        for name in names:
            x = deltas[name].reshape(C, -1)
            n = x.shape[1]
            for a in range(0, n, chunk):
                b = min(n, a + chunk)
                ctr = torch.arange(off + a, off + b, dtype=torch.int64, device=dev)
                masks = fmix32_torch(key_combine_torch(lk, ctr)).to(torch.float64)   # [P, m]
                enc = fixed_point_encode(coeff_v[:, None] * x[:, a:b].to(torch.float32), bits)
                pay = (enc + (A @ masks).to(torch.int64)) & _M32
                rec = (r @ masks).to(torch.int64) & _M32
                yield name, a, enc, pay, rec
            off += n


def secagg_combine(deltas: dict, coeff, valid, dropped, client_id, rnd, fl, *,
                   chunk: int = CHUNK) -> dict:
    """Masked modular aggregation of a slot-order delta stack.

    Returns the aggregate tree (params-shaped, leaf dtypes preserved):
    bitwise equal to decoding ``sum_valid fixed_point_encode(coeff_i *
    delta_i)`` — the masks and the dropout-recovery shares cancel exactly."""
    bits = int(fl.secagg_bits)
    surv = valid.to(torch.int64)
    flat = {k: torch.empty(math.prod(v.shape[1:]), dtype=torch.float32, device=v.device)
            for k, v in deltas.items()}
    for name, a, _, pay, rec in secagg_chunks(deltas, coeff, valid, dropped, client_id, rnd,
                                              fl, chunk=chunk):
        tot = (pay * surv[:, None]).sum(0) & _M32
        flat[name][a:a + pay.shape[1]] = fixed_point_decode((tot - rec) & _M32, bits)
    return {k: flat[k].reshape(v.shape[1:]).to(v.dtype) for k, v in deltas.items()}


def secagg_reference(deltas: dict, coeff, valid, fl) -> dict:
    """The unmasked fixed-point aggregate — the bitwise cancellation target
    (no masks, no recovery; what :func:`secagg_combine` must equal)."""
    bits = int(fl.secagg_bits)
    coeff_v, surv, _, _ = _slots(valid, None, coeff)
    out = {}
    for k, v in deltas.items():
        enc = fixed_point_encode(coeff_v[:, None] * v.reshape(v.shape[0], -1).to(torch.float32),
                                 bits)
        agg = (enc * surv[:, None]).sum(0) & _M32
        out[k] = fixed_point_decode(agg, bits).reshape(v.shape[1:]).to(v.dtype)
    return out
