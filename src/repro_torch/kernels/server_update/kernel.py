"""CUDA kernel wrapper: the fused App. F server update over many tensors.

Launches ``server_update_kernel`` from ``repro_torch/csrc/server_update.cu``
(built with ``nvcc`` for ``sm_90a`` at first use, loaded with ``ctypes``) on
the current stream: one launch for up to 256 tensors, which covers a whole
model's parameter dict; the source's header note gives the bound and the
design.  Replaces the Pallas kernel ``repro/kernels/server_update/kernel.py:
fused_server_update``.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..build import load

X_DTYPES = (torch.float32, torch.bfloat16)


def _lib() -> ctypes.CDLL:
    lib = load("server_update")
    fn = lib.server_update_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_float,
                   ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.server_update_max_tensors.argtypes = []
    lib.server_update_max_tensors.restype = ctypes.c_int
    return lib


def server_update_kernel(xs: list, ds: list, ms: list, *, eta_g: float, a: float,
                         inv_eta_l: torch.Tensor) -> tuple[list, list]:
    """Lists of contiguous tensors on one CUDA device, ``xs[i]`` f32 or bf16,
    ``ds[i]`` like ``xs[i]``, ``ms[i]`` f32 of the same shape, and a 0-dim
    f32 ``inv_eta_l`` there -> (new x' tensors, new m' tensors).  One launch
    for every 256 tensors that hold values; ``eta_g`` and ``a`` are rounded
    to fp32."""
    if not (len(xs) == len(ds) == len(ms)):
        raise ValueError(f"{len(xs)} x, {len(ds)} delta and {len(ms)} momentum tensors")
    dev = inv_eta_l.device
    if dev.type != "cuda" or inv_eta_l.dtype != torch.float32 or inv_eta_l.dim() != 0:
        raise ValueError(f"inv_eta_l must be a 0-dim float32 CUDA tensor, got "
                         f"{inv_eta_l.dtype} {tuple(inv_eta_l.shape)} on {inv_eta_l.device}")
    for i, (x, d, m) in enumerate(zip(xs, ds, ms)):
        for name, t, dt in (("x", x, x.dtype), ("delta", d, x.dtype), ("m", m, torch.float32)):
            if t.device != dev:
                raise ValueError(f"{name}[{i}] must be a CUDA tensor on {dev}, got {t.device}")
            if t.dtype != dt or t.shape != x.shape or not t.is_contiguous():
                raise ValueError(f"{name}[{i}] must be a contiguous {list(x.shape)} {dt} "
                                 f"tensor, got {t.dtype} {tuple(t.shape)}")
        if x.dtype not in X_DTYPES:
            raise ValueError(f"x[{i}] must be float32 or bfloat16, got {x.dtype}")
    lib = _lib()
    cap = lib.server_update_max_tensors()
    with torch.cuda.device(dev):
        x_out = [torch.empty_like(x) for x in xs]
        m_out = [torch.empty_like(m) for m in ms]
        stream = torch.cuda.current_stream(dev).cuda_stream
        for lo in range(0, len(xs), cap):
            part = range(lo, min(lo + cap, len(xs)))
            if not any(xs[i].numel() for i in part):
                continue
            rows = np.array([[xs[i].data_ptr(), ds[i].data_ptr(), ms[i].data_ptr(),
                              x_out[i].data_ptr(), m_out[i].data_ptr(), xs[i].numel(),
                              int(xs[i].dtype == torch.bfloat16)] for i in part], np.int64)
            err = lib.server_update_launch(rows.ctypes.data, len(part), eta_g, a,
                                           inv_eta_l.data_ptr(), stream)
            if err != 0:
                raise RuntimeError(f"server_update_kernel launch failed: cudaError {err}")
            server_update_kernel.launches += 1
    return x_out, m_out


server_update_kernel.launches = 0   # launches so far; reset by the caller
