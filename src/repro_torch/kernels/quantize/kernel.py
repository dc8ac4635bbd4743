"""CUDA kernel wrappers: stochastic quantize-pack and unpack-dequantize.

Launch ``quantize_pack_kernel`` / ``unpack_dequantize_kernel`` from
``repro_torch/csrc/quantize.cu`` (built with ``nvcc`` for ``sm_90a`` at first
use, loaded with ``ctypes``) on the current stream, one block per chunk over
``[R, n]`` rows; the source's header note gives the bound and the design.
Replace the Pallas kernels ``repro/kernels/quantize/kernel.py:
quantize_pack_kernel`` and ``unpack_dequantize_kernel``.
"""
from __future__ import annotations

import ctypes

import torch

from ..build import load
from .ref import levels, num_chunks, packed_width

_MAX_BLOCKS = 2**31 - 1


def _lib() -> ctypes.CDLL:
    lib = load("quantize")
    q = lib.quantize_pack_launch
    q.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    q.restype = ctypes.c_int
    d = lib.unpack_dequantize_launch
    d.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    d.restype = ctypes.c_int
    return lib


def _check(name: str, t: torch.Tensor, dev: torch.device, dtype: torch.dtype, shape: tuple):
    if t.device != dev or dev.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor on {dev}, got {t.device}")
    if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {list(shape)} {dtype} tensor, "
                         f"got {t.dtype} {tuple(t.shape)}")


def _grid(rows: int, nc: int, chunk: int, bits: int) -> None:
    levels(bits)
    packed_width(chunk, bits)
    if rows < 1 or nc < 1 or rows * nc > _MAX_BLOCKS:
        raise ValueError(f"bad shape: {rows} rows x {nc} chunks (one block a chunk, "
                         f"at most {_MAX_BLOCKS})")


def quantize_pack_kernel(v: torch.Tensor, keys: torch.Tensor, *, chunk: int, bits: int):
    """[R, n] f32 rows and [R, nc] int64 chunk keys (values in [0, 2^32))
    on one CUDA device -> (packed [R, nc, chunk*bits/8] uint8, scale [R, nc] f32)."""
    R, n = v.shape
    nc = num_chunks(n, chunk)
    dev = v.device
    _check("v", v, dev, torch.float32, (R, n))
    _check("keys", keys, dev, torch.int64, (R, nc))
    _grid(R, nc, chunk, bits)
    lib = _lib()
    with torch.cuda.device(dev):
        packed = torch.empty((R, nc, packed_width(chunk, bits)), dtype=torch.uint8, device=dev)
        scale = torch.empty((R, nc), dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.quantize_pack_launch(v.data_ptr(), keys.data_ptr(), packed.data_ptr(),
                                       scale.data_ptr(), R, n, nc, chunk, bits, stream)
    if err != 0:
        raise RuntimeError(f"quantize_pack_kernel launch failed: cudaError {err}")
    quantize_pack_kernel.launches += 1
    return packed, scale


def unpack_dequantize_kernel(packed: torch.Tensor, scale: torch.Tensor, *, n: int,
                             chunk: int, bits: int) -> torch.Tensor:
    """(packed [R, nc, pb] uint8, scale [R, nc] f32) on one CUDA device ->
    [R, n] f32."""
    R, nc, _ = packed.shape
    dev = packed.device
    if nc != num_chunks(n, chunk):
        raise ValueError(f"{nc} chunks do not hold n={n} values at chunk={chunk}")
    _check("packed", packed, dev, torch.uint8, (R, nc, packed_width(chunk, bits)))
    _check("scale", scale, dev, torch.float32, (R, nc))
    _grid(R, nc, chunk, bits)
    lib = _lib()
    with torch.cuda.device(dev):
        out = torch.empty((R, n), dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.unpack_dequantize_launch(packed.data_ptr(), scale.data_ptr(), out.data_ptr(),
                                           R, n, nc, chunk, bits, stream)
    if err != 0:
        raise RuntimeError(f"unpack_dequantize_kernel launch failed: cudaError {err}")
    unpack_dequantize_kernel.launches += 1
    return out


quantize_pack_kernel.launches = 0        # launches so far; reset by the caller
unpack_dequantize_kernel.launches = 0
