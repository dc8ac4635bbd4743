"""CUDA kernel wrappers: stochastic quantize-pack and unpack-dequantize.

Launch one of two routes of ``repro_torch/csrc/quantize.cu`` (built with
``nvcc`` for ``sm_90a`` at first use, loaded with ``ctypes``) on the current
stream over ``[R, n]`` rows: ``"warp"`` (one warp per chunk, 8 chunks a
block, values in registers from 16-byte loads, the chunk-constant part of
the hash hoisted, one vector store of a lane's packed word) where
:func:`route` says so, else ``"block"`` (one block of 128 threads per chunk,
any chunk, n and alignment).  Both give the same bytes; the source's header
note gives the bound and both designs.  Replace the Pallas kernels
``repro/kernels/quantize/kernel.py: quantize_pack_kernel`` and
``unpack_dequantize_kernel``.
"""
from __future__ import annotations

import ctypes

import torch

from ..build import load
from .ref import levels, num_chunks, packed_width

_MAX_BLOCKS = 2**31 - 1
ROUTES = ("warp", "block")
WARP_CHUNKS = 8          # chunks (warps) a block on the warp route
WARP_MAX_CHUNK = 1024    # 32 values a lane


def _lib() -> ctypes.CDLL:
    lib = load("quantize")
    for name in ("quantize_pack_launch", "quantize_pack_warp_launch"):
        fn = getattr(lib, name)
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int64] * 2 + [ctypes.c_int] * 3
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    for name in ("unpack_dequantize_launch", "unpack_dequantize_warp_launch"):
        fn = getattr(lib, name)
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int64] * 2 + [ctypes.c_int] * 3
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def route(n: int, chunk: int, bits: int, *ptrs: int) -> str:
    """Which kernel takes rows of ``n`` values cut into chunks of ``chunk``
    at ``bits`` bits, given the caller's data pointers (the f32 rows to
    quantize, or the packed bytes to dequantize; the outputs come from the
    allocator, aligned): ``"warp"`` for a chunk that is a multiple of 128
    up to 1024, ``n % 4 == 0`` and 16-byte-aligned pointers (a lane reads
    and writes whole float4s), ``"block"`` for everything else.  Decided
    from these numbers alone, before any launch; the device plays no part."""
    levels(bits)
    if chunk % 128 or not 128 <= chunk <= WARP_MAX_CHUNK or n % 4 or any(p % 16 for p in ptrs):
        return "block"
    return "warp"


def _choose(chosen: str, kernel: str | None) -> str:
    if kernel is None:
        return chosen
    if kernel not in ROUTES or (kernel == "warp" and chosen != "warp"):
        raise ValueError(f"kernel {kernel!r} cannot take these inputs (route: {chosen!r})")
    return kernel


def _check(name: str, t: torch.Tensor, dev: torch.device, dtype: torch.dtype, shape: tuple):
    if t.device != dev or dev.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor on {dev}, got {t.device}")
    if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {list(shape)} {dtype} tensor, "
                         f"got {t.dtype} {tuple(t.shape)}")


def _grid(rows: int, nc: int, chunk: int, bits: int, chosen: str) -> None:
    levels(bits)
    packed_width(chunk, bits)
    per_block = WARP_CHUNKS if chosen == "warp" else 1
    if rows < 1 or nc < 1 or -(-rows * nc // per_block) > _MAX_BLOCKS:
        raise ValueError(f"bad shape: {rows} rows x {nc} chunks ({per_block} chunk(s) a "
                         f"block on route {chosen!r}, at most {_MAX_BLOCKS} blocks)")


def quantize_pack_kernel(v: torch.Tensor, keys: torch.Tensor, *, chunk: int, bits: int,
                         kernel: str | None = None):
    """[R, n] f32 rows and [R, nc] int64 chunk keys (values in [0, 2^32))
    on one CUDA device -> (packed [R, nc, chunk*bits/8] uint8, scale [R, nc] f32).

    The kernel is :func:`route`'s choice; ``kernel`` names one instead (to
    time ``"block"`` on the inputs ``"warp"`` takes), and ``"warp"`` on
    inputs it does not take raises."""
    R, n = v.shape
    nc = num_chunks(n, chunk)
    dev = v.device
    _check("v", v, dev, torch.float32, (R, n))
    _check("keys", keys, dev, torch.int64, (R, nc))
    chosen = _choose(route(n, chunk, bits, v.data_ptr()), kernel)
    _grid(R, nc, chunk, bits, chosen)
    lib = _lib()
    with torch.cuda.device(dev):
        packed = torch.empty((R, nc, packed_width(chunk, bits)), dtype=torch.uint8, device=dev)
        scale = torch.empty((R, nc), dtype=torch.float32, device=dev)
        launch = lib.quantize_pack_warp_launch if chosen == "warp" else lib.quantize_pack_launch
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = launch(v.data_ptr(), keys.data_ptr(), packed.data_ptr(), scale.data_ptr(),
                     R, n, nc, chunk, bits, stream)
    if err != 0:
        raise RuntimeError(f"quantize_pack_kernel ({chosen}) launch failed: cudaError {err}")
    quantize_pack_kernel.launches += 1
    quantize_pack_kernel.route_launches[chosen] += 1
    return packed, scale


def unpack_dequantize_kernel(packed: torch.Tensor, scale: torch.Tensor, *, n: int,
                             chunk: int, bits: int, kernel: str | None = None) -> torch.Tensor:
    """(packed [R, nc, pb] uint8, scale [R, nc] f32) on one CUDA device ->
    [R, n] f32.  ``kernel`` as for :func:`quantize_pack_kernel`."""
    R, nc, _ = packed.shape
    dev = packed.device
    if nc != num_chunks(n, chunk):
        raise ValueError(f"{nc} chunks do not hold n={n} values at chunk={chunk}")
    _check("packed", packed, dev, torch.uint8, (R, nc, packed_width(chunk, bits)))
    _check("scale", scale, dev, torch.float32, (R, nc))
    chosen = _choose(route(n, chunk, bits, packed.data_ptr()), kernel)
    _grid(R, nc, chunk, bits, chosen)
    lib = _lib()
    with torch.cuda.device(dev):
        out = torch.empty((R, n), dtype=torch.float32, device=dev)
        launch = (lib.unpack_dequantize_warp_launch if chosen == "warp"
                  else lib.unpack_dequantize_launch)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = launch(packed.data_ptr(), scale.data_ptr(), out.data_ptr(), R, n, nc, chunk, bits,
                     stream)
    if err != 0:
        raise RuntimeError(f"unpack_dequantize_kernel ({chosen}) launch failed: cudaError {err}")
    unpack_dequantize_kernel.launches += 1
    unpack_dequantize_kernel.route_launches[chosen] += 1
    return out


quantize_pack_kernel.launches = 0        # launches so far; reset by the caller
quantize_pack_kernel.route_launches = dict.fromkeys(ROUTES, 0)   # the same, by route
unpack_dequantize_kernel.launches = 0
unpack_dequantize_kernel.route_launches = dict.fromkeys(ROUTES, 0)
