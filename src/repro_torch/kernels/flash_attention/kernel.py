"""CUDA kernel wrapper: GQA flash attention, causal or not, with an optional
sliding window.

Launches one of three kernels of ``repro_torch/csrc/flash_attention.cu``
(built with ``nvcc`` for ``sm_90a`` at first use, loaded with ``ctypes``)
on the current stream, one block per (64-row query tile, head, batch), as
:func:`route` says: ``flash_fwd_wgmma`` (``"wgmma"``: the non-causal mode
without a window, bf16 at hd 64, on Hopper's ``wgmma`` with TMA loads by a
producer warp), ``flash_fwd_mma`` (``"mma"``: the rest of bf16 on the
``mma.sync`` tensor cores) or ``flash_fwd`` (``"simt"``: fp32 sums on the
CUDA cores, any head dim up to 128, f32 or bf16).  The source's header
note gives the bound and the three designs.  Replaces the Pallas kernel
``repro/kernels/flash_attention/kernel.py:flash_attention``.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..build import load
from .ref import check_every_row_sees_a_key

DTYPES = (torch.float32, torch.bfloat16)
MAX_HD = 128
MMA_HDS = (16, 32, 64, 128)     # flash_fwd_mma's head dims
WGMMA_HD = 64                   # flash_fwd_wgmma's
# fastest first: a kernel takes the inputs its route takes and those of
# every route before it
ROUTES = ("wgmma", "mma", "simt")
MODES = ("causal", "noncausal")
# the C entry points' parameters, in order (csrc/flash_attention.cu, extern
# "C"): q, k, v, o, strides; B, H, KV, Tq, Tk, hd, window, causal; scale;
# then flash_attention_launch's bf16 flag; the stream
_HEAD = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_float]
ARGTYPES = {"flash_attention_launch": _HEAD + [ctypes.c_int, ctypes.c_void_p],
            "flash_attention_mma_launch": _HEAD + [ctypes.c_void_p],
            "flash_attention_wgmma_launch": _HEAD + [ctypes.c_void_p]}
_ENTRY = {"wgmma": "flash_attention_wgmma_launch", "mma": "flash_attention_mma_launch"}


def _lib() -> ctypes.CDLL:
    lib = load("flash_attention")
    for name, argtypes in ARGTYPES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
          window: int = 0) -> str:
    """Which kernel takes these [B,H,T,hd] inputs in this mode: for bf16
    with a head dim of 16, 32, 64 or 128 whose data pointers and batch,
    head and time strides are 16-byte aligned (the tensor-core kernels copy
    16 bytes at a time; TMA wants both), ``"wgmma"`` (``flash_fwd_wgmma``)
    when not ``causal``, without a window and at hd 64, else ``"mma"``
    (``flash_fwd_mma``); ``"simt"`` (``flash_fwd``) for everything else,
    f32 above all.  Decided from dtypes, shapes, strides and pointers and
    the mode alone, before any launch; the device plays no part."""
    if q.dtype != torch.bfloat16 or q.shape[-1] not in MMA_HDS:
        return "simt"
    for t in (q, k, v):
        if t.dtype != torch.bfloat16 or t.data_ptr() % 16 or any(t.stride(i) % 8 for i in range(3)):
            return "simt"
    return "wgmma" if not causal and not window and q.shape[-1] == WGMMA_HD else "mma"


def flash_attention_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                           causal: bool = True, window: int = 0,
                           kernel: str | None = None) -> torch.Tensor:
    """q [B,H,Tq,hd]; k,v [B,KV,Tk,hd] (f32 or bf16, one dtype, on one CUDA
    device, any strides with a contiguous head dim: transposed views of the
    model's [B,T,H,hd] tensors are read in place) -> [B,H,Tq,hd] in q's
    dtype, a transposed view of a contiguous [B,Tq,H,hd] tensor.  Query i
    sees the keys j <= i when ``causal``, every key otherwise (Tq may
    differ from Tk), and only those with i - j < window when ``window``;
    inputs where a row would see no key raise ``ValueError``.

    The kernel is :func:`route`'s choice; ``kernel`` names one instead, a
    later one of ``ROUTES`` (to time ``"mma"`` and ``"simt"`` on the inputs
    ``"wgmma"`` takes); an earlier one raises."""
    B, H, Tq, hd = q.shape
    KV, Tk = k.shape[1], k.shape[2]
    check_every_row_sees_a_key(Tq, Tk, window)
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"flash_attention_kernel needs CUDA tensors, got {dev}")
    for name, t, shape in (("k", k, (B, KV, Tk, hd)), ("v", v, (B, KV, Tk, hd))):
        if t.device != dev or t.dtype != q.dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be a {list(shape)} {q.dtype} tensor on {dev}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if q.dtype not in DTYPES:
        raise ValueError(f"flash_attention_kernel takes float32 or bfloat16, got {q.dtype}")
    if not 1 <= hd <= MAX_HD or KV == 0 or H % KV:
        raise ValueError(f"head dim {hd} (1..{MAX_HD}) and heads {H} / {KV} not supported")
    if any(t.stride(3) != 1 for t in (q, k, v)):
        raise ValueError("q, k and v need a contiguous head dim")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if max(B, H) > 65535:
        raise ValueError(f"batch {B} and heads {H} must be <= 65535 (grid dims)")
    chosen = route(q, k, v, causal=causal, window=window)
    if kernel is not None:
        if kernel not in ROUTES or ROUTES.index(kernel) < ROUTES.index(chosen):
            raise ValueError(f"kernel {kernel!r} cannot take these inputs (route: {chosen!r})")
        chosen = kernel
    out = torch.empty((B, Tq, H, hd), dtype=q.dtype, device=dev).transpose(1, 2)
    strides = np.array([t.stride(i) for t in (q, k, v, out) for i in range(3)], np.int64)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), strides.ctypes.data,
            B, H, KV, Tq, Tk, hd, window, int(causal), 1.0 / hd ** 0.5)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if chosen in _ENTRY:
            err = getattr(lib, _ENTRY[chosen])(*args, stream)
        else:
            err = lib.flash_attention_launch(*args, int(q.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_kernel ({chosen}) launch failed: cudaError {err}")
    flash_attention_kernel.launches += 1
    flash_attention_kernel.route_launches[chosen] += 1
    flash_attention_kernel.mode_launches[MODES[not causal]] += 1
    return out


flash_attention_kernel.launches = 0   # launches so far; reset by the caller
flash_attention_kernel.route_launches = dict.fromkeys(ROUTES, 0)   # the same, by kernel
flash_attention_kernel.mode_launches = dict.fromkeys(MODES, 0)     # the same, by mode
