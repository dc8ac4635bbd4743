"""CUDA kernel wrapper: the Mamba2 SSD intra-chunk step.

Launches ``ssd_intra_chunk`` from ``repro_torch/csrc/ssd.cu`` (built with
``nvcc`` for ``sm_90a`` at first use, loaded with ``ctypes``) on the
current stream, one block per (head, chunk, batch); the source's header
note gives the bound and the design.  Replaces the Pallas kernel
``repro/kernels/ssd/kernel.py:ssd_intra_chunk``.  A tile whose shared
memory exceeds what a block of the card may have raises.
"""
from __future__ import annotations

import ctypes

import torch

from ..build import load

DTYPES = (torch.float32, torch.bfloat16)


def _lib() -> ctypes.CDLL:
    lib = load("ssd")
    fn = lib.ssd_intra_chunk_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.ssd_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.ssd_smem_bytes.restype = ctypes.c_longlong
    return lib


def ssd_intra_chunk_kernel(xdt: torch.Tensor, a: torch.Tensor, Bm: torch.Tensor,
                           Cm: torch.Tensor):
    """xdt [Bz,nc,Q,H,P] (f32 or bf16); a [Bz,nc,Q,H] f32; Bm/Cm [Bz,nc,Q,N]
    (f32 or bf16, one dtype); contiguous, on one CUDA device -> (y_intra
    [Bz,nc,Q,H,P], S_local [Bz,nc,H,P,N]), both fp32."""
    Bz, nc, Q, H, P = xdt.shape
    N = Bm.shape[-1]
    dev = xdt.device
    if dev.type != "cuda":
        raise ValueError(f"ssd_intra_chunk_kernel needs CUDA tensors, got {dev}")
    for name, t, dtypes, shape in (("xdt", xdt, DTYPES, (Bz, nc, Q, H, P)),
                                   ("a", a, (torch.float32,), (Bz, nc, Q, H)),
                                   ("Bm", Bm, DTYPES, (Bz, nc, Q, N)),
                                   ("Cm", Cm, (Bm.dtype,), (Bz, nc, Q, N))):
        if t.device != dev or t.dtype not in dtypes or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {list(shape)} tensor of "
                             f"{[str(d) for d in dtypes]} on {dev}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if max(nc, Bz) > 65535:
        raise ValueError(f"chunks {nc} and batch {Bz} must be <= 65535 (grid dims)")
    y = torch.empty((Bz, nc, Q, H, P), dtype=torch.float32, device=dev)
    s = torch.empty((Bz, nc, H, P, N), dtype=torch.float32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ssd_intra_chunk_launch(xdt.data_ptr(), a.data_ptr(), Bm.data_ptr(),
                                         Cm.data_ptr(), y.data_ptr(), s.data_ptr(), Bz, nc, Q,
                                         H, P, N, int(xdt.dtype == torch.bfloat16),
                                         int(Bm.dtype == torch.bfloat16), stream)
    if err == -1:   # the tile exceeds a block's shared memory
        raise ValueError(f"ssd_intra_chunk_kernel: the (Q {Q}, P {P}, N {N}) tile needs "
                         f"{lib.ssd_smem_bytes(Q, P, N)} bytes of shared memory, more than "
                         f"a block of {torch.cuda.get_device_name(dev)} may have")
    if err != 0:
        raise RuntimeError(f"ssd_intra_chunk_kernel launch failed: cudaError {err}")
    ssd_intra_chunk_kernel.launches += 1
    return y, s


ssd_intra_chunk_kernel.launches = 0   # launches so far; reset by the caller
