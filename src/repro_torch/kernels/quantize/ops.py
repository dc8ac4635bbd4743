"""Dispatch for the comm plane's quantize-pack / unpack-dequantize, by the
tensors' device and ``FLConfig.uplink_backend`` (shared by both wire
directions, so the wire format always matches whichever end decodes it).

``backend="kernel"`` (the default): a CUDA tensor launches the hand-written
kernel (``kernel.py``) and nothing else, there is no fallback; a CPU tensor
takes the plain torch version (``ref.*_torch``), which computes the same
bits.  ``backend="ref"``: the plain torch version on any device.
"""
from __future__ import annotations

import torch

from .kernel import quantize_pack_kernel, unpack_dequantize_kernel
from .ref import quantize_pack_torch, unpack_dequantize_torch

BACKENDS = ("kernel", "ref")


def _use_kernel(t: torch.Tensor, backend: str) -> bool:
    if backend not in BACKENDS:
        raise ValueError(f"unknown quantize backend {backend!r}; have {BACKENDS}")
    if backend == "ref" or t.device.type == "cpu":
        return False
    if t.device.type == "cuda":
        return True
    raise ValueError(f"quantize has no kernel for device {t.device}")


def quantize_pack(v: torch.Tensor, keys: torch.Tensor, *, chunk: int, bits: int,
                  backend: str = "kernel"):
    """[R, n] f32 + [R, nc] int64 keys -> (packed uint8 [R, nc, pb], scale
    f32 [R, nc]); see ``ref`` for the semantics."""
    if _use_kernel(v, backend):
        return quantize_pack_kernel(v, keys, chunk=chunk, bits=bits)
    return quantize_pack_torch(v, keys, chunk=chunk, bits=bits)


def unpack_dequantize(packed: torch.Tensor, scale: torch.Tensor, *, n: int, chunk: int,
                      bits: int, backend: str = "kernel") -> torch.Tensor:
    """(packed uint8 [R, nc, pb], scale f32 [R, nc]) -> [R, n] f32."""
    if _use_kernel(packed, backend):
        return unpack_dequantize_kernel(packed, scale, n=n, chunk=chunk, bits=bits)
    return unpack_dequantize_torch(packed, scale, n=n, chunk=chunk, bits=bits)
