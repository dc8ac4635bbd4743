"""CUDA kernel wrapper: causal, sliding-window GQA flash attention.

Launches ``flash_fwd`` from ``repro_torch/csrc/flash_attention.cu`` (built
with ``nvcc`` for ``sm_90a`` at first use, loaded with ``ctypes``) on the
current stream, one block per (64-row query tile, head, batch); the
source's header note gives the bound and the design.  Replaces the Pallas
kernel ``repro/kernels/flash_attention/kernel.py:flash_attention``.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..build import load

DTYPES = (torch.float32, torch.bfloat16)
MAX_HD = 128


def _lib() -> ctypes.CDLL:
    lib = load("flash_attention")
    fn = lib.flash_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def flash_attention_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                           window: int = 0) -> torch.Tensor:
    """q [B,H,Tq,hd]; k,v [B,KV,Tk,hd] (f32 or bf16, one dtype, on one CUDA
    device, any strides with a contiguous head dim: transposed views of the
    model's [B,T,H,hd] tensors are read in place) -> [B,H,Tq,hd] in q's
    dtype, a transposed view of a contiguous [B,Tq,H,hd] tensor."""
    B, H, Tq, hd = q.shape
    KV, Tk = k.shape[1], k.shape[2]
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
    out = torch.empty((B, Tq, H, hd), dtype=q.dtype, device=dev).transpose(1, 2)
    strides = np.array([t.stride(i) for t in (q, k, v, out) for i in range(3)], np.int64)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.flash_attention_launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                         strides.ctypes.data, B, H, KV, Tq, Tk, hd, window,
                                         1.0 / hd ** 0.5, int(q.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_kernel launch failed: cudaError {err}")
    flash_attention_kernel.launches += 1
    return out


flash_attention_kernel.launches = 0   # launches so far; reset by the caller
